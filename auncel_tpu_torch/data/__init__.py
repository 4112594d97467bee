"""Dataset files and synthetic datasets."""

from auncel_tpu_torch.data.io import (
    fvecs_read,
    fvecs_write,
    ivecs_read,
    ivecs_write,
    fbin_read,
    ibin_read,
)
from auncel_tpu_torch.data.synthetic import Dataset, make_clustered_dataset

__all__ = [
    "fvecs_read",
    "fvecs_write",
    "ivecs_read",
    "ivecs_write",
    "fbin_read",
    "ibin_read",
    "make_clustered_dataset",
    "Dataset",
]
