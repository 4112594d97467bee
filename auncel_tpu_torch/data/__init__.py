"""Synthetic datasets."""

from auncel_tpu_torch.data.synthetic import Dataset, make_clustered_dataset

__all__ = ["Dataset", "make_clustered_dataset"]
