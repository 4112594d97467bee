"""Carry index, profile and LAET model state from the JAX package into the
port.

Each function takes the JAX package's state as a dict of numpy arrays
(``{name: np.asarray(value)}`` of an ``IVFArrays``, ``MultiRowArrays``,
``TraceSet`` or LAET ``_MLP``; a nested ``rows`` dict for
``MultiRowArrays``), so this module imports no jax. The LAET regressor's
weights are the ones carried across. The storage codec comes across as it
is: float32 or bfloat16 vectors, SQ codes with their range, or PQ codes
with their codebooks. The other index families come across from their
trained state: IMI product centroids (and MultiIndexQuantizer codebooks),
IVFPQR's codes with its refine state, ``Index2Layer``'s centroids, books,
list ids and codes, the binary indexes' codes and centroid bits, the
LSH indexes' rotation, thresholds, period and centroids, and the HNSW
graphs (levels, entry point, each level's links, the vectors or the
storage codes and codec, the reconstruct-from-neighbours codebook), and a
sharded index (each shard's arrays, the stacked profiles and the
calibration). With
them both packages compute on identical state. The tensors go to the card
unless ``device`` says otherwise.
"""

import numpy as np
import torch

from auncel_tpu_torch.baselines.laet import MLP
from auncel_tpu_torch.index.binary import BinaryFlatIndex, BinaryIVFIndex
from auncel_tpu_torch.index.hnsw import HNSWIndex
from auncel_tpu_torch.index.hnsw_recons import ReconstructFromNeighbors
from auncel_tpu_torch.index.imi import MultiIndexQuantizer
from auncel_tpu_torch.index.io import bhnsw_from_state, ivfpqr_from_codes
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.lsh import IndexLSH, IVFSpectralHashIndex
from auncel_tpu_torch.index.twolayer import Index2Layer
from auncel_tpu_torch.ops.pq import PQCodebooks
from auncel_tpu_torch.parallel.sharded import ShardedIVF, make_mesh
from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.scan import IVFArrays, RowArrays
from auncel_tpu_torch.index.multirow import MultiRowArrays
from auncel_tpu_torch.profile.trace import TraceSet, traces_from_arrays

_INT_FIELDS = ("vec_ids", "list_sizes", "row_table", "rows_per_list",
               "row_base", "row_list", "n_bins")


def _tensor(name: str, a, device) -> torch.Tensor:
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.as_tensor(np.array(a, dtype=dtype, order="C"), device=device)


def _storage(a) -> torch.Tensor:
    """The stored vectors as they are: float32, uint8 codes, or bfloat16,
    whose bytes are reinterpreted (never rounded through float32; the
    dtype is recognised by name, so no ml_dtypes import is needed)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    if a.dtype == np.uint8:
        return torch.from_numpy(np.ascontiguousarray(a).copy())
    return torch.as_tensor(np.array(a, dtype=np.float32, order="C"))


def ivf_arrays_from_numpy(state: dict, device="cuda") -> IVFArrays:
    """IVFArrays from the JAX package's IVFArrays fields: float32 or
    bfloat16 vectors, uint8 SQ codes with ``sq_scale`` and ``sq_bias``, or
    uint8 PQ codes with ``pq_codebooks``. The JAX package marks residual PQ
    with ``pq_residual`` = ``()`` (None otherwise); the port with True."""
    fields = {}
    for f in IVFArrays._fields:
        v = state.get(f)
        if f == "db":
            fields[f] = _storage(v).to(device)
        elif f == "pq_residual":
            fields[f] = v is not None
        elif v is not None:
            fields[f] = _tensor(f, v, device)
    return IVFArrays(**fields)


def multirow_from_numpy(state: dict, device="cuda") -> MultiRowArrays:
    """MultiRowArrays from the JAX package's fields; ``state["rows"]`` is
    the IVFArrays dict of the row layout."""
    rows = RowArrays(*ivf_arrays_from_numpy(state["rows"], device))
    return MultiRowArrays(rows, *(_tensor(f, state[f], device)
                                  for f in MultiRowArrays._fields[1:]))


def traces_from_numpy(state: dict, device="cuda") -> TraceSet:
    """TraceSet from the JAX package's TraceSet fields."""
    return traces_from_arrays(state["phi"], state["u"], state["std"],
                              state["n_bins"], device)


def mlp_from_numpy(state: dict, device="cuda"):
    """The LAET regressor from the JAX package's ``_MLP`` fields (numpy
    ``w1, b1, w2, b2, w3, b3``, weights [in, out])."""
    w1 = np.asarray(state["w1"], np.float32)
    mlp = MLP(w1.shape[0], w1.shape[1])
    with torch.no_grad():
        for f in ("w1", "b1", "w2", "b2", "w3", "b3"):
            getattr(mlp, f).copy_(torch.from_numpy(
                np.array(state[f], np.float32)))
    return mlp.to(device)


def imi_from_numpy(centroids: np.ndarray, state: dict | None = None,
                   metric=Metric.L2, multirow: dict | None = None,
                   device="cuda") -> IVFFlatIndex:
    """An IMI index (``coarse="imi"``) on the JAX package's product
    centroids: trained and empty without ``state``, else on its packed
    arrays (and multi-row layout) as ``IVFFlatIndex.from_state`` shares
    them."""
    centroids = np.asarray(centroids, np.float32)
    if state is None:
        idx = IVFFlatIndex(centroids.shape[1], centroids.shape[0], metric,
                           device=device, coarse="imi")
        idx.set_centroids(centroids)
        return idx
    mr = None if multirow is None else multirow_from_numpy(multirow, device)
    return IVFFlatIndex.from_state(centroids,
                                   ivf_arrays_from_numpy(state, device),
                                   metric, multirow=mr, coarse="imi")


def miq_from_numpy(codebooks: list, nbits: int, cls=MultiIndexQuantizer,
                   device="cuda", **kw):
    """A trained MultiIndexQuantizer (``cls``: or MultiIndexQuantizer2,
    with its ``assign_indexes`` in ``kw``, filled with the codebooks) on
    the JAX package's per-subspace codebooks."""
    books = [np.array(b, np.float32) for b in codebooks]
    d = sum(b.shape[1] for b in books)
    miq = cls(d, len(books), nbits, device=device, **kw)
    miq.codebooks = books
    miq.is_trained = True
    for m, sub in enumerate(getattr(miq, "assign_indexes", ())):
        sub.reset()
        sub.add(books[m])
    return miq


def ivfpqr_from_numpy(state: dict, device="cuda"):
    """An IndexIVFPQR holding the JAX package's codes exactly: ``state``
    has the ``IVFPQR`` file's header fields (d, nlist, M, M_refine,
    k_factor, metric, ntotal) and payload (centroids, db, vec_ids,
    list_sizes, pq_books, refine_books, refine_codes, refine_sorted_ids,
    refine_pos); ``add`` is refused, as after loading the file."""
    return ivfpqr_from_codes(state, state, device)


def twolayer_from_numpy(state: dict, device="cuda") -> Index2Layer:
    """An Index2Layer from d, nlist, M, metric, centroids, books [M, 256,
    d/M], list_ids and codes."""
    idx = Index2Layer(state["d"], state["nlist"], M=state["M"],
                      metric=state.get("metric", Metric.L2), device=device)
    idx.centroids = np.asarray(state["centroids"], np.float32)
    idx._pq = PQCodebooks(torch.as_tensor(
        np.array(state["books"], np.float32), device=idx.device))
    idx.is_trained = True
    idx.list_ids = np.asarray(state["list_ids"], np.int32)
    idx.codes = np.asarray(state["codes"], np.uint8)
    return idx


def binary_from_numpy(state: dict, device="cuda"):
    """A BinaryFlatIndex from d and the packed ``codes``, or with
    ``centroid_bits`` (and nlist, nprobe) a BinaryIVFIndex."""
    codes = np.asarray(state["codes"], np.uint8)
    if state.get("centroid_bits") is None:
        idx = BinaryFlatIndex(state["d"], device=device)
    else:
        idx = BinaryIVFIndex(state["d"], state["nlist"], device=device)
        idx.centroid_bits = np.asarray(state["centroid_bits"], np.uint8)
        idx.is_trained = True
        idx.nprobe = state.get("nprobe", 1)
    if codes.shape[0]:
        idx.add(codes)
    return idx


def lsh_from_numpy(state: dict, device="cuda") -> IndexLSH:
    """An IndexLSH from d, nbits, rotate_data, train_thresholds, rrot,
    thresholds and its {0, 1} ``bits`` [n, nbits]."""
    idx = IndexLSH(state["d"], state["nbits"],
                   rotate_data=state["rotate_data"],
                   train_thresholds=state["train_thresholds"], device=device)
    if state.get("rrot") is not None:
        idx.rrot = np.asarray(state["rrot"], np.float32)
    idx.thresholds = np.asarray(state["thresholds"], np.float32)
    idx.is_trained = True
    idx._bits = np.asarray(state["bits"], np.int8)
    return idx


def spectral_hash_from_numpy(state: dict, device="cuda"
                             ) -> IVFSpectralHashIndex:
    """A trained IVFSpectralHashIndex from d, nlist, nbit, threshold_type,
    period, rrot, centroids and trained (the per-list thresholds), with
    the stored vectors ``x`` and ids ``ids`` queued (encoded at the first
    search, as in the JAX package)."""
    idx = IVFSpectralHashIndex(state["d"], state["nlist"], state["nbit"],
                               period=state["period"],
                               threshold_type=state["threshold_type"],
                               device=device)
    idx.rrot = np.array(state["rrot"], np.float32)
    idx.centroids = np.array(state["centroids"], np.float32)
    idx.trained = np.array(state["trained"], np.float32)
    idx.is_trained = True
    if state.get("x") is not None and len(state["x"]):
        idx.add(state["x"], state["ids"])
    return idx


def hnsw_from_numpy(state: dict, device="cuda"):
    """An HNSW index holding the JAX package's graph exactly. ``state`` has
    the keys of its ``HNSWIndex.save`` file: kind (HNSWIndex, IndexHNSWSQ,
    IndexHNSWPQ or IndexHNSW2Level), d, M, ef_search, metric, levels,
    entry, max_level, ``table{l}`` and ``g2u{l}`` a level, and ``xb`` or
    the variant's codes and codec (``sq_scale``, ``sq_vmin``,
    ``sq_codes``; ``pq_books``, ``pq_codes``; ``tl_centroids``,
    ``tl_books``, ``tl_list_ids``, ``tl_codes``); optionally ``recons``, a
    dict of the ReconstructFromNeighbors state (k, nsq, codebook, codes,
    and k_reorder if set). Kind ``BHNSW`` (the keys of its index file:
    d, M, ef_search, entry, max_level, codes, levels and the tables) gives
    a BinaryHNSWIndex."""
    if str(state.get("kind")) == "BHNSW":
        return bhnsw_from_state(state, state, device)
    idx = HNSWIndex.from_state(state, device)
    rec = state.get("recons")
    if rec is not None:
        r = ReconstructFromNeighbors(idx, k=int(rec["k"]), nsq=int(rec["nsq"]))
        r.codebook = np.array(rec["codebook"], np.float32)
        r.codes = np.array(rec["codes"], np.uint8)
        if "k_reorder" in rec:
            r.k_reorder = int(rec["k_reorder"])
        idx.reconstruct_from_neighbors = r
    return idx


def sharded_from_numpy(meta: dict, shard_states: list, traces_state,
                       device="cuda"):
    """A ShardedIVF holding the JAX package's sharded state, every shard
    on ``device``. ``meta`` has the keys of its ``meta.json`` (d, nlist,
    n_shards, storage, metric, multipler, std_m, max_topk,
    multirow_row_cap); ``shard_states`` each shard's IVFArrays fields;
    ``traces_state`` the stacked TraceSet fields ([S, T, max_bins], or
    None before ``train_profiles``). The multi-row layouts and the shared
    one-shot plan are rebuilt from the shards' arrays."""
    s = ShardedIVF(meta["d"], meta["nlist"], meta["n_shards"],
                   Metric.parse(meta["metric"]),
                   mesh=make_mesh(meta["n_shards"], devices=[device]),
                   storage=meta.get("storage", "f32"))
    s.shards = [IVFFlatIndex.from_state(st["centroids"],
                                        ivf_arrays_from_numpy(st, device),
                                        metric=s.metric)
                for st in shard_states]
    s.multipler = float(meta["multipler"])
    s.std_m = float(meta["std_m"])
    if meta.get("max_topk"):
        s.max_topk = int(meta["max_topk"])
    if traces_state is not None:
        s._set_traces({f: np.asarray(traces_state[f])
                       for f in TraceSet._fields})
    if meta.get("multirow_row_cap"):
        s.enable_multirow(int(meta["multirow_row_cap"]))
    return s
