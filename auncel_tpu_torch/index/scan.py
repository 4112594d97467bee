"""Core IVF list-scan primitives (port of ``auncel_tpu/index/scan.py``).

One probe step for a whole query batch:

    worklist of (query, list-or-row) pairs
    -> K1, the hand-written row-scan kernel: one fp32 dot per stored slot
    -> score assembly from the STORED norms, probe-limit and id masks
    -> exact top-k merge into the running result

``limit`` carries the per-query probe budget: probe slot ``ik`` contributes
iff ``ik < limit[b]``, so a batch runs one shape while each query scans
exactly its own lists.

Only float32 storage is ported. The SQ, PQ-residual and polysemous branches
of the JAX package raise ``NotImplementedError`` here.
"""

from typing import NamedTuple

import torch

from auncel_tpu_torch.types import Metric, worst_value
from auncel_tpu_torch.ops.distance import pairwise_scores, sqnorms
from auncel_tpu_torch.ops.topk import init_topk, topk_scores
from auncel_tpu_torch.kernels.rowscan import rowscan_dots


class IVFArrays(NamedTuple):
    """Device-resident IVF-Flat state: padded dense tensors, f32 storage."""
    centroids: torch.Tensor   # [nlist, d] float32
    cent_sq: torch.Tensor     # [nlist] float32
    db: torch.Tensor          # [nlist, cap, d] float32
    db_sq: torch.Tensor       # [nlist, cap] float32 stored norms (0 at pad)
    vec_ids: torch.Tensor     # [nlist, cap] int32, -1 at padding
    list_sizes: torch.Tensor  # [nlist] int32
    interdis: torch.Tensor    # [nlist, nlist] float32; L2: sqdist, IP: angle

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.db.shape[1]

    @property
    def d(self) -> int:
        return self.centroids.shape[1]


def check_f32_storage(arrays: IVFArrays) -> None:
    if arrays.db.dtype != torch.float32:
        raise NotImplementedError(
            f"only float32 storage is ported (got {arrays.db.dtype}); the "
            f"SQ/PQ/bf16 codecs are still to be ported")


def coarse_rank(arrays: IVFArrays, q: torch.Tensor, metric: Metric,
                q_sq: torch.Tensor | None = None, rank_k: int | None = None):
    """Rank centroids per query: (cdis [B, rank_k], cids [B, rank_k])
    best-first. ``rank_k < nlist`` keeps only the exact top prefix."""
    scores = pairwise_scores(q, arrays.centroids, metric,
                             y_sqnorms=arrays.cent_sq, x_sqnorms=q_sq)
    all_ids = torch.arange(arrays.nlist, dtype=torch.int32,
                           device=q.device).expand(scores.shape)
    return topk_scores(scores, all_ids, rank_k or arrays.nlist, metric)


# candidate slots materialised per chunk of a scan (scores + ids + dots)
CHUNK_SLOTS = 1 << 24


def pick_probe_chunk(batch: int, cap: int, width: int) -> int:
    """Probe slots per scan chunk: as many as keep the chunk's candidate
    buffer within CHUNK_SLOTS. Chunking regroups the same masked candidates
    between exact merges, so it never changes results."""
    return max(1, min(width, CHUNK_SLOTS // max(batch * cap, 1)))


def scan_probe_range(
    arrays: IVFArrays,
    q: torch.Tensor,            # [B, d]
    q_sq: torch.Tensor,         # [B]
    probe_lists: torch.Tensor,  # [B, n_slots] int32 ranked list (row) ids
    vals: torch.Tensor,         # [B, k] running top-k values
    ids: torch.Tensor,          # [B, k] running top-k ids
    limit: torch.Tensor,        # [B] int32 per-query probe budget
    start,                      # int or [B] int32: first probe slot
    width: int,                 # number of probe slots to scan
    metric: Metric,
    probe_chunk: int | None = None,
):
    """Scan probe slots [start, start + width) for every query; a per-query
    ``start`` lets each query advance its own frontier. The dot of every
    (query, stored slot) pair runs in K1 over a flat worklist (one entry per
    (query, probe slot)); scores use the stored ``db_sq``, so every term but
    the dot is bitwise the JAX package's."""
    check_f32_storage(arrays)
    k = vals.shape[-1]
    worst = worst_value(metric)
    B = q.shape[0]
    cap = arrays.cap
    if width <= 0 or B == 0:
        return vals, ids
    C = probe_chunk or pick_probe_chunk(B, cap, width)
    n_slots_avail = probe_lists.shape[1]
    dev = q.device
    start = torch.as_tensor(start, dtype=torch.int32, device=dev).expand(B)
    for c0 in range(0, width, C):
        Cc = min(C, width - c0)
        iks = start[:, None] + c0 + torch.arange(Cc, dtype=torch.int32,
                                                 device=dev)[None, :]
        safe_iks = iks.clamp(0, n_slots_avail - 1).long()
        lists = torch.gather(probe_lists, 1, safe_iks).clamp_min(0)  # [B,Cc]
        work_rows = lists.reshape(-1).to(torch.int32).contiguous()
        qs = q.repeat_interleave(Cc, dim=0)
        dots = rowscan_dots(arrays.db, work_rows, qs).reshape(B, Cc, cap)
        lists = lists.long()
        sub_sq = arrays.db_sq[lists]      # [B, Cc, cap]
        sub_ids = arrays.vec_ids[lists]   # [B, Cc, cap]
        if metric is Metric.L2:
            scores = (q_sq[:, None, None] + sub_sq - 2.0 * dots).clamp_min(0.0)
        else:
            scores = dots
        active = (iks[:, :, None] < limit[:, None, None]) & (sub_ids >= 0)
        scores = torch.where(active, scores, worst).reshape(B, Cc * cap)
        sub_ids = torch.where(active, sub_ids, -1).reshape(B, Cc * cap)
        vals, ids = topk_scores(torch.cat([vals, scores], dim=-1),
                                torch.cat([ids, sub_ids], dim=-1), k, metric)
    return vals, ids


def ivf_full_scan(arrays: IVFArrays, q: torch.Tensor, k: int,
                  metric: Metric):
    """Exact full scan (nprobe = nlist) without per-query gathers: each
    block of lists is read once for the whole batch and contracted with one
    fp32 matmul, then merged exactly. Its dot values match K1's within the
    kscaling tolerance (the same f32 products, summed in another order)."""
    check_f32_storage(arrays)
    B = q.shape[0]
    nlist, cap, d = arrays.db.shape
    worst = worst_value(metric)
    q_sq = sqnorms(q)
    C = max(1, min(nlist, CHUNK_SLOTS // max(B * cap, 1)))
    vals, ids = init_topk((B,), k, metric, q.device)
    for l0 in range(0, nlist, C):
        l1 = min(l0 + C, nlist)
        blk = arrays.db[l0:l1].reshape(-1, d)
        dots = (q @ blk.T).reshape(B, l1 - l0, cap)
        if metric is Metric.L2:
            scores = (q_sq[:, None, None] + arrays.db_sq[l0:l1][None]
                      - 2.0 * dots).clamp_min(0.0)
        else:
            scores = dots
        blk_ids = arrays.vec_ids[l0:l1]
        scores = torch.where((blk_ids >= 0)[None], scores, worst).reshape(
            B, -1)
        cand_ids = blk_ids.reshape(1, -1).expand(B, -1)
        vals, ids = topk_scores(torch.cat([vals, scores], dim=-1),
                                torch.cat([ids, cand_ids], dim=-1), k, metric)
    return vals, ids
