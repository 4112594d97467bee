"""Auxiliary search structures (port of ``auncel_tpu/index/aux.py``):
range search, ID selectors, stats and the interrupt hook.

Capability parity with the reference's ``AuxIndexStructures``
(``RangeSearchResult``, ``IDSelectorRange``, ``IDSelectorBatch``,
``InterruptCallback``), the IVF ``range_search`` path
(``IndexIVF.cpp:741-860``) and the global search counters
(``indexIVF_stats``, IndexIVF.h:361-374). ``IVFFlatIndex.search`` and
``ErrorSys.search`` add to ``ivf_stats``; ``FlatIndex.range_search``
returns a ``RangeSearchResult``.

Range search returns a variable number of hits per query, so the device
scores chunks of probe slots with K2 (``kernels/scan_scores.py``), the
same scan as top-k search, and the hits are compacted per chunk of
queries in the JAX package's row-major order: the arrays come out equal,
not just the sets.
"""

from dataclasses import dataclass

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.kernels.scan_scores import scan_scores


@dataclass
class RangeSearchResult:
    """CSR-style container (reference AuxIndexStructures.h:31): query i's
    hits are labels[lims[i]:lims[i+1]] / distances[...]."""
    lims: np.ndarray        # [nq + 1] int64
    labels: np.ndarray      # [nres] int64
    distances: np.ndarray   # [nres] float32


class IDSelector:
    def is_member(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError


@dataclass
class IDSelectorRange(IDSelector):
    imin: int
    imax: int

    def is_member(self, ids):
        return (ids >= self.imin) & (ids < self.imax)


class IDSelectorBatch(IDSelector):
    def __init__(self, ids):
        self._set = np.asarray(sorted(set(np.asarray(ids).tolist())),
                               np.int64)

    def is_member(self, ids):
        ids = np.asarray(ids)
        if len(self._set) == 0:     # empty selector: legal no-op
            return np.zeros(ids.shape, bool)
        pos = np.clip(np.searchsorted(self._set, ids), 0,
                      len(self._set) - 1)
        return self._set[pos] == ids


@dataclass
class SearchStats:
    """Per-process counters, updated by the search entry points that opt
    in: ``IVFFlatIndex.search`` (``nq``, ``nlist_scanned``, ``ndis``,
    ``search_time_ms``) and ``ErrorSys``'s bounded search (``nq``,
    ``nlist_scanned``, and ``waves``, ``waves_skipped``, ``rounds`` and
    ``host_syncs``, ``tracing.py``)."""
    nq: int = 0
    nlist_scanned: int = 0
    ndis: int = 0
    search_time_ms: float = 0.0
    waves: int = 0           # engine waves that launched a scan
    waves_skipped: int = 0   # waves the skip test dropped
    rounds: int = 0          # compaction rounds
    host_syncs: int = 0      # calls that blocked the host on the card

    def reset(self):
        self.nq = self.nlist_scanned = self.ndis = 0
        self.waves = self.waves_skipped = self.rounds = self.host_syncs = 0
        self.search_time_ms = 0.0


ivf_stats = SearchStats()

# candidate slots (scores and ids) materialised per chunk of queries
RANGE_CHUNK_SLOTS = 1 << 25


def range_search(index, q: np.ndarray, radius: float,
                 nprobe: int | None = None) -> RangeSearchResult:
    """All stored vectors within ``radius`` of each query among its
    ``nprobe`` best-ranked lists (L2: squared distance < radius, the
    reference's convention, IndexIVF.cpp:741; IP: score > radius). The
    queries go through in chunks whose candidate buffer stays within
    ``RANGE_CHUNK_SLOTS``; each chunk's hits are compacted on the device."""
    metric = index.metric
    arrays = index.arrays
    nprobe = min(nprobe or index.nprobe, index.nlist)
    q = np.asarray(q, np.float32)
    nq = q.shape[0]
    _, cids = index.coarse_rank_np(q)
    dev = arrays.db.device
    per_query = _range_steps(nprobe)[0] * arrays.cap
    qb = max(1, RANGE_CHUNK_SLOTS // max(per_query, 1))
    counts, labels, dists = [], [], []
    for b0 in range(0, nq, qb):
        qd = torch.as_tensor(q[b0:b0 + qb], device=dev)
        lists = torch.as_tensor(
            cids[b0:b0 + qb, :nprobe].astype(np.int32), device=dev)
        scores, vids = _range_scan_all(arrays, qd, sqnorms(qd), lists,
                                       nprobe, metric)
        hit = scores < radius if metric is Metric.L2 else scores > radius
        mask = hit & (vids >= 0)
        counts.append(mask.sum(1).cpu().numpy())
        labels.append(vids[mask].cpu().numpy().astype(np.int64))
        dists.append(scores[mask].cpu().numpy().astype(np.float32))
    lims = np.zeros(nq + 1, np.int64)
    if nq:
        np.cumsum(np.concatenate(counts), out=lims[1:])
    return RangeSearchResult(
        lims, np.concatenate(labels) if labels else np.zeros(0, np.int64),
        np.concatenate(dists) if dists else np.zeros(0, np.float32))


def _range_steps(nprobe: int) -> tuple:
    """(probe slots of the output buffer, probe slots a chunk): chunks of
    up to 8 probe slots, the JAX package's."""
    C = max(1, min(8, nprobe))
    return -(-nprobe // C) * C, C


def _range_scan_all(arrays, q, q_sq, cids, nprobe: int, metric: Metric):
    """Scores and ids of every (query, probe slot) pair, [B, n_steps * C *
    cap] each, chunk by chunk of C probe slots in the JAX package's slot
    order. K2 scores each chunk: a probe slot past nprobe is list -1,
    and every dead slot (past nprobe, padding) carries the metric's worst
    value and id -1 (the JAX package leaves the computed score beside id
    -1 there; both are dropped by the hit mask alike). The query is taken
    as given, unrounded on bf16 storage, as the JAX function takes it."""
    B = q.shape[0]
    width, C = _range_steps(nprobe)
    slots = torch.arange(width, dtype=torch.int32, device=q.device)
    lists = torch.gather(cids, 1, slots.clamp_max(nprobe - 1).long()
                         .expand(B, width))
    lists = torch.where(slots < nprobe, lists, -1).to(torch.int32)
    codec = arrays.codec_kwargs()
    out_s, out_i = [], []
    for s0 in range(0, width, C):
        sc, ids = scan_scores(arrays.db, arrays.db_sq, arrays.vec_ids,
                              arrays.list_sizes, q.contiguous(), q_sq,
                              lists[:, s0:s0 + C].contiguous(), metric,
                              **codec)
        out_s.append(sc)
        out_i.append(ids)
    return torch.cat(out_s, 1), torch.cat(out_i, 1)


def remove_ids(index, selector: IDSelector) -> int:
    """Drop all stored vectors matched by the selector and repack
    (reference Index::remove_ids / IDSelector capability). The survivors
    are re-added decoded through the codec (``decoded_db``), with an SQ
    index's range pinned so their codes re-encode unchanged."""
    from auncel_tpu_torch.index.ivf import decoded_db, preserve_sq_range
    arrays = index.arrays
    db = decoded_db(arrays)
    ids = arrays.vec_ids.cpu().numpy()
    keep = (ids >= 0) & ~selector.is_member(ids)
    flat_x = db[keep]
    flat_ids = ids[keep].astype(np.int64)
    removed = index.ntotal - flat_x.shape[0]
    preserve_sq_range(index)
    index.reset()
    if flat_x.shape[0]:
        index.add(flat_x, ids=flat_ids)
    return removed


class InterruptCallback:
    """Cooperative interruption of long host-driven loops (reference
    ``InterruptCallback``, AuxIndexStructures.h:250: a global hook polled
    by long-running operations). Install a callback returning True and the
    next ``check()`` raises InterruptedError."""

    _instance = None

    def __init__(self, fn=None):
        self.fn = fn

    def want_interrupt(self) -> bool:
        return bool(self.fn()) if self.fn is not None else False

    @classmethod
    def install(cls, fn) -> None:
        cls._instance = cls(fn)

    @classmethod
    def clear(cls) -> None:
        cls._instance = None

    @classmethod
    def check(cls) -> None:
        if cls._instance is not None and cls._instance.want_interrupt():
            raise InterruptedError("interrupted by InterruptCallback")

    @classmethod
    def is_interrupted(cls) -> bool:
        return (cls._instance is not None
                and cls._instance.want_interrupt())
