"""IVF index layouts and scans."""

from auncel_tpu_torch.index.flat import FlatIndex
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.scan import IVFArrays
from auncel_tpu_torch.index.factory import index_factory

__all__ = ["FlatIndex", "IVFFlatIndex", "IVFArrays", "index_factory"]
