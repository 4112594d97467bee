"""auncel_tpu_torch — error-bounded IVF vector search in PyTorch and CUDA.

The port of ``auncel_tpu`` (JAX/XLA/Pallas on a TPU) to one NVIDIA Hopper
GPU. ``auncel_tpu`` stays the reference: the same index state, profile and
queries give the same ids and decisions in both packages. This package
imports torch and never jax.

Main path: ``IVFFlatIndex.train``/``add``/``enable_multirow``, ground truth
from ``exact_search``, ``ErrorSys.sys_train``/``set_topk``/``set_queries``/
``calibrate``, then ``ErrorSys.search`` with a recall bound per query. The
scan of the rows (dots, scores and masks) runs in the hand-written CUDA
kernel of ``kernels/rowscan.py`` on a CUDA device and in its plain PyTorch
version on the CPU.

The index layer a user reaches through ``index_factory``: ``FlatIndex``,
IVF on every ported storage (f32, bf16, SQ, and PQ on the padded layout,
whose probes K2 scores, ``kernels/scan_scores.py``), ``IndexPQ``, the
transforms, ``IndexRefineFlat`` and ``IndexIDMap``, and the other
non-graph families: IMI product cells (``index/imi.py``), ``IndexIVFPQR``,
``Index2Layer``, the binary indexes (``index/binary.py``, with
``index_binary_factory``) and LSH (``index/lsh.py``); and the HNSW graphs
(``index/hnsw.py``: flat, SQ8, PQ and two-level storage, binary HNSW, the
IVF%d_HNSW%d coarse quantizer, and ``index/hnsw_recons.py``'s
reconstruct-from-neighbours re-rank). Beyond one resident
index: ``index/ondisk.py`` serves an index directory from disk (fixed
and error-bounded search, paging only the probed lists), ``index/aux.py``
has range search and removal, ``index/invlists.py`` and
``index/ivflib.py`` compose and split inverted lists, and
``index/meta.py`` federates indexes (shards, dimension splits,
replicas). Scale-out: ``parallel/`` has ``ShardedIVF`` (per-shard IVF
indexes and profiles on a mesh of devices, the merge of their top-k) and
the data-parallel k-means; ``eval_harness/dist_bench.py`` measures it,
``figures/`` plots the harness's logs, and ``c_api/`` is the C ABI.
"""

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.flat import FlatIndex
from auncel_tpu_torch.index.hnsw import HNSWIndex
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.factory import index_factory
from auncel_tpu_torch.index.binary import index_binary_factory
from auncel_tpu_torch.profile.error_sys import ErrorSys

__version__ = "0.1.0"

__all__ = ["Metric", "FlatIndex", "HNSWIndex", "IVFFlatIndex",
           "index_factory", "index_binary_factory", "ErrorSys",
           "__version__"]
