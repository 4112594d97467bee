"""Core IVF list-scan primitives (port of ``auncel_tpu/index/scan.py``).

One probe step for a whole query batch scores every stored slot of the
probed lists, masks probe slots past each query's limit and dead slots, and
merges the candidates into the exact running top-k. Two hand-written
kernels score, chosen by the layout the caller holds:

    padded lists (IVFArrays)          -> K2, kernels/scan_scores.py
    multi-row rows (RowArrays)        -> K1, kernels/rowscan.py
                                         (rowscan_scores)

Both take one contract: scores and ids of the live slots of each probed
list (row), from the STORED norms ``db_sq``, so every term but the dot is
bitwise the JAX package's; a probe slot past the query's limit is passed as
list id -1 and read by neither. Each chunk's candidates merge into the
running top-k through ``ops/topk.py::merge_topk_verified``, as the JAX
package merges them (``auncel_tpu/index/scan.py:301-308``): on the card a
third hand-written kernel (``kernels/topk_merge.py``) that selects without
building the concatenation, bitwise the stable sort's result.

``limit`` carries the per-query probe budget: probe slot ``ik`` contributes
iff ``ik < limit[b]``, so a batch runs one shape while each query scans
exactly its own lists.

Storage codecs: ``db`` holds float32 vectors, bfloat16 vectors, or uint8
scalar-quantizer codes (SQ8, SQ4 or SQ6 by the packed width) with the
per-dimension affine decode ``x = code * sq_scale + sq_bias``. Every
distance, and ``db_sq``, is on decoded values. The kernels decode inside
the scan; the dense passes decode one block at a time
(``IVFArrays.decode_block``). With bf16 storage the query is rounded to
bf16 for the dot, as the JAX package rounds it, and ``q_sq`` stays the
float32 query's. PQ storage: uint8 ``[nlist, cap, M]`` codes with
``pq_codebooks``, decoded by a codebook gather (``ops/pq.py``); with
``pq_residual`` the codes approximate ``x - centroid[list]`` and the
scores carry the probed list's centroid (L2 ``max(||q - c_l||^2 + db_sq -
2 <r, q - c_l>, 0)``, IP ``<c_l, q> + <r, q>``), as the JAX package's
residual branches write them. K2 scores PQ codes by per-(query, list)
lookup tables; the multi-row layout takes no PQ storage
(``index/multirow.py``). The polysemous Hamming filter (``qcodes``/``ht``
of ``scan_probe_range``, ``ivf_search_fixed_ht``) runs inside K2.

The dense passes (``masked_full_scan``, ``dense_stage_snapshots``) read the
row corpus once for a whole batch with one fp32 matmul per block, masked by
each list's coarse rank per query: the JAX package computes them with an
XLA einsum, not a Pallas kernel.
"""

from typing import NamedTuple

import torch

from auncel_tpu_torch.types import Metric, worst_value
from auncel_tpu_torch.ops.distance import pairwise_scores, sqnorms
from auncel_tpu_torch.ops.pq import PQCodebooks, encode_pq
from auncel_tpu_torch.ops.topk import (init_topk, merge_topk_verified,
                                       topk_scores)
from auncel_tpu_torch.kernels.rowscan import rowscan_scores
from auncel_tpu_torch.kernels.scan_scores import (
    decode_slots, popcount8, scan_scores)
from auncel_tpu_torch.tracing import K1, K2, SCAN, span, synced


class IVFArrays(NamedTuple):
    """Device-resident IVF-Flat state: padded dense tensors. ``db`` holds
    float32 or bfloat16 vectors, or uint8 SQ codes with ``sq_scale`` and
    ``sq_bias`` ([d] float32), or uint8 PQ codes with ``pq_codebooks``
    (residuals of the list's centroid when ``pq_residual``); ``db_sq`` the
    decoded norms."""
    centroids: torch.Tensor   # [nlist, d] float32
    cent_sq: torch.Tensor     # [nlist] float32
    db: torch.Tensor          # [nlist, cap, d] f32/bf16, or [.., width] u8
    db_sq: torch.Tensor       # [nlist, cap] float32 stored norms (0 at pad)
    vec_ids: torch.Tensor     # [nlist, cap] int32, -1 at padding
    list_sizes: torch.Tensor  # [nlist] int32
    interdis: torch.Tensor    # [nlist, nlist] float32; L2: sqdist, IP: angle
    sq_scale: torch.Tensor | None = None  # [d] float32 (SQ storage only)
    sq_bias: torch.Tensor | None = None   # [d] float32 (SQ storage only)
    pq_codebooks: torch.Tensor | None = None  # [M, 256, d/M] f32 (PQ only)
    pq_residual: bool = False  # PQ codes encode x - centroids[list]

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.db.shape[1]

    @property
    def d(self) -> int:
        return self.centroids.shape[1]

    def decode_block(self, sub: torch.Tensor) -> torch.Tensor:
        """Stored block -> float32 vectors: the affine decode for SQ codes,
        the codebook gather for PQ codes (residuals for residual PQ), the
        exact widening for bf16, the block itself for f32."""
        return decode_slots(sub, self.d, self.sq_scale, self.sq_bias,
                            self.pq_codebooks)

    def codec_kwargs(self) -> dict:
        """The storage codec's keywords of the scan kernels' wrappers."""
        if self.sq_scale is not None:
            return {"sq_scale": self.sq_scale, "sq_bias": self.sq_bias}
        if self.pq_codebooks is not None:
            return {"pq_codebooks": self.pq_codebooks,
                    "centroids": (self.centroids if self.pq_residual
                                  else None)}
        return {}

    def scan_query(self, q: torch.Tensor) -> torch.Tensor:
        """The query the dot takes: rounded to bf16 on bf16 storage (the
        JAX package's ``q.astype(sub.dtype)``), else ``q`` itself."""
        if self.db.dtype == torch.bfloat16:
            return q.to(torch.bfloat16).to(torch.float32)
        return q


class RowArrays(IVFArrays):
    """The multi-row layout's row tensor (``index/multirow.py``): an
    IVFArrays whose "lists" are rows. ``scan_probe_range`` scores rows with
    K1 and padded lists with K2."""
    __slots__ = ()


def check_storage(arrays: IVFArrays) -> None:
    """Raise NotImplementedError on storage the port does not scan: uint8
    codes come with an SQ range or with PQ codebooks."""
    dtype = arrays.db.dtype
    if (dtype == torch.uint8 and arrays.sq_scale is None
            and arrays.pq_codebooks is None):
        raise NotImplementedError(
            "uint8 storage without sq_scale or pq_codebooks")
    if dtype not in (torch.float32, torch.bfloat16, torch.uint8):
        raise NotImplementedError(f"storage dtype {dtype} is not ported")


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
    qcodes: torch.Tensor | None = None,  # [B, n_slots, M] per-slot codes
    ht: int | None = None,               # polysemous Hamming threshold
):
    """Scan probe slots [start, start + width) for every query; a per-query
    ``start`` lets each query advance its own frontier. Padded lists are
    scored by K2 and the rows of a ``RowArrays`` by K1; neither reads a
    probe slot past the query's limit (passed as list id -1). ``qcodes``
    and ``ht`` apply the polysemous filter on PQ storage, inside K2: a
    stored code more than ``ht`` bits from the query's code for that probe
    slot is dropped (the worst value and id -1), as the JAX package masks
    it (``auncel_tpu/index/scan.py:260-266``)."""
    with span(SCAN):
        check_storage(arrays)
        k = vals.shape[-1]
        B = q.shape[0]
        if width <= 0 or B == 0:
            return vals, ids
        rows = isinstance(arrays, RowArrays)
        if rows and qcodes is not None:
            raise ValueError("the polysemous filter takes PQ codes, which "
                             "the multi-row layout does not hold")
        C = probe_chunk or pick_probe_chunk(B, arrays.cap, width)
        n_slots_avail = probe_lists.shape[1]
        dev = q.device
        q = arrays.scan_query(q).contiguous()
        if isinstance(start, torch.Tensor):
            start = torch.as_tensor(start, dtype=torch.int32, device=dev)
        else:   # a host number, copied onto the card
            start = synced(torch.as_tensor, start, dtype=torch.int32,
                           device=dev)
        start = start.expand(B)
        codec = arrays.codec_kwargs()
        kernel, kernel_span = (rowscan_scores, K1) if rows else \
            (scan_scores, K2)
        for c0 in range(0, width, C):
            Cc = min(C, width - c0)
            iks = start[:, None] + c0 + torch.arange(Cc, dtype=torch.int32,
                                                     device=dev)[None, :]
            safe_iks = iks.clamp(0, n_slots_avail - 1).long()
            lists = torch.gather(probe_lists, 1, safe_iks)   # [B, Cc]
            # a probe slot past its query's limit is list (row) -1: read by
            # neither kernel
            lists = torch.where(iks < limit[:, None], lists,
                                -1).to(torch.int32)
            if qcodes is not None:
                codec["qcodes"] = torch.gather(
                    qcodes, 1, safe_iks[:, :, None].expand(
                        -1, -1, qcodes.shape[2])).contiguous()  # [B, Cc, M]
                codec["ht"] = int(ht)
            with span(kernel_span):
                scores, sub_ids = kernel(
                    arrays.db, arrays.db_sq, arrays.vec_ids,
                    arrays.list_sizes, q, q_sq, lists, metric, **codec)
            vals, ids = merge_topk_verified(vals, ids, scores, sub_ids, k,
                                            metric)
        return vals, ids


def ivf_full_scan(arrays: IVFArrays, q: torch.Tensor, k: int,
                  metric: Metric):
    """Exact full scan (nprobe = nlist) without per-query gathers: each
    block of lists is read once for the whole batch and contracted with one
    fp32 matmul on the block's decoded vectors, then merged exactly. Its
    dot values match K1's within the kscaling tolerance (the same f32
    products, summed in another order). Residual PQ takes each list's
    centroid through the score, as the scan kernels do: one batched product
    with the residual queries ``q - c_l`` (L2) or with ``q`` plus
    ``<c_l, q>`` (IP)."""
    check_storage(arrays)
    B = q.shape[0]
    nlist, cap = arrays.vec_ids.shape
    d = arrays.d
    worst = worst_value(metric)
    q_sq = sqnorms(q)
    q = arrays.scan_query(q)
    C = max(1, min(nlist, CHUNK_SLOTS // max(B * cap, 1)))
    vals, ids = init_topk((B,), k, metric, q.device)
    for l0 in range(0, nlist, C):
        l1 = min(l0 + C, nlist)
        blk = arrays.decode_block(arrays.db[l0:l1])          # [C, cap, d]
        if arrays.pq_residual:
            cl = arrays.centroids[l0:l1]                      # [C, d]
            if metric is Metric.L2:
                qc = q[None, :, :] - cl[:, None, :]           # [C, B, d]
                dots = torch.bmm(blk, qc.transpose(1, 2)).permute(2, 0, 1)
                scores = ((qc * qc).sum(-1).T[:, :, None]
                          + arrays.db_sq[l0:l1][None]
                          - 2.0 * dots).clamp_min(0.0)
            else:
                qr = (q @ blk.reshape(-1, d).T).reshape(B, l1 - l0, cap)
                scores = (q @ cl.T)[:, :, None] + qr
        else:
            dots = (q @ blk.reshape(-1, d).T).reshape(B, l1 - l0, cap)
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


def inverse_rank(cids: torch.Tensor, nlist: int) -> torch.Tensor:
    """[B, nlist] int32 coarse rank of each list per query, from the ranked
    prefix ``cids`` [B, r]; lists outside the prefix get rank nlist."""
    B, r = cids.shape
    ranks = torch.arange(r, dtype=torch.int32, device=cids.device)
    return torch.full((B, nlist), nlist, dtype=torch.int32,
                      device=cids.device).scatter_(
        1, cids.long(), ranks.expand(B, r).contiguous())


def _block_scores(rows: RowArrays, row_list, inv_rank, q, q_sq, s: int,
                  e: int, metric: Metric):
    """Scores [B, n, row_cap] of rows [s, e) against every query (one fp32
    matmul on the decoded block, the JAX package's einsum outside any Pallas
    kernel), their lists' per-query ranks [B, n] and the rows' live-slot
    mask [n, row_cap]."""
    B, d = q.shape
    blk = rows.decode_block(rows.db[s:e])
    dots = (rows.scan_query(q) @ blk.reshape(-1, d).T).reshape(B, e - s, -1)
    if metric is Metric.L2:
        scores = (q_sq[:, None, None] + rows.db_sq[s:e][None]
                  - 2.0 * dots).clamp_min(0.0)
    else:
        scores = dots
    lists = row_list[s:e]
    ranks = inv_rank[:, lists.clamp_min(0).long()]
    live = (rows.vec_ids[s:e] >= 0) & (lists >= 0)[:, None]
    return scores, ranks, live


def masked_full_scan(rows: RowArrays, row_list: torch.Tensor,
                     inv_rank: torch.Tensor, target: torch.Tensor,
                     q: torch.Tensor, q_sq: torch.Tensor, k: int,
                     metric: Metric, block_rows: int = 256,
                     merge_blocks: int = 1):
    """The dense crossover: the exact top-k over each query's first
    ``target[b]`` coarse-ranked lists as ONE shared pass over the row
    corpus (the reference's ``distance_compute_blas_threshold`` switch to
    a blocked GEMM, utils.cpp:538-622), instead of private row gathers. A
    (query, vector) pair is a candidate iff the vector's list ranks below
    the query's budget: the gather tail's candidate set, so the result is
    the same top-k up to the product's rounding. Blocks of ``block_rows``
    rows, ``merge_blocks`` blocks per exact merge (``merge_topk_verified``:
    the merge kernel on the card, where the JAX package keeps the stable
    sort; the same bits); a merge is skipped when no candidate in its
    window beats any query's current k-th (exact: the skipped candidates
    lose to every kept one). One host sync per merge window. Returns (vals
    [B, k], ids)."""
    check_storage(rows)
    B = q.shape[0]
    R = rows.vec_ids.shape[0]
    worst = worst_value(metric)
    W = max(1, min(block_rows, R)) * max(1, merge_blocks)
    with span(SCAN):
        vals, ids = init_topk((B,), k, metric, q.device)
        for s in range(0, R, W):
            e = min(s + W, R)
            scores, ranks, live = _block_scores(rows, row_list, inv_rank, q,
                                                q_sq, s, e, metric)
            active = (ranks < target[:, None])[:, :, None] & live[None]
            scores = torch.where(active, scores, worst).reshape(B, -1)
            sub_ids = torch.where(active, rows.vec_ids[s:e][None],
                                  -1).reshape(B, -1)
            if metric.lower_is_better:
                improving = (scores.amin(1) < vals[:, k - 1]).any()
            else:
                improving = (scores.amax(1) > vals[:, k - 1]).any()
            if synced(bool, improving):
                vals, ids = merge_topk_verified(vals, ids, scores, sub_ids,
                                                k, metric)
        return vals, ids


def dense_stage_snapshots(rows: RowArrays, row_list: torch.Tensor,
                          inv_rank: torch.Tensor, q: torch.Tensor,
                          q_sq: torch.Tensor, stages: tuple, k: int,
                          metric: Metric, block_rows: int = 128
                          ) -> torch.Tensor:
    """Per-stage top-k VALUE snapshots from ONE shared corpus pass:
    [B, len(stages), k] sorted best-first, entry j the exact top-k values
    over each query's first ``stages[j]`` coarse-ranked lists (the snapshot
    the termination predicate reads at that boundary, IndexIVF.cpp:551-568).
    Each candidate lands in the rank bucket stages[j-1] <= rank < stages[j]
    of its list; buckets are disjoint, so one running top-k per bucket and
    a cumulative union after the pass give every stage. A bucket's merge is
    skipped when no candidate of the block beats any query's k-th in it
    (one host sync per block)."""
    check_storage(rows)
    B = q.shape[0]
    R = rows.vec_ids.shape[0]
    worst = worst_value(metric)
    lower = metric.lower_is_better
    n_st = len(stages)
    with span(SCAN):
        bounds = synced(torch.tensor, stages, dtype=torch.long,
                        device=q.device)
        snap = [torch.full((B, k), worst, dtype=torch.float32,
                           device=q.device) for _ in range(n_st)]
        C = max(1, min(block_rows, R))
        for s in range(0, R, C):
            e = min(s + C, R)
            scores, ranks, live = _block_scores(rows, row_list, inv_rank, q,
                                                q_sq, s, e, metric)
            flat = torch.where(live[None], scores, worst).reshape(B, -1)
            # bucket j = #(stages <= rank); n_st is past the last stage
            bucket = torch.bucketize(ranks.long(), bounds, right=True)
            bucket = bucket[:, :, None].expand(scores.shape).reshape(B, -1)
            best = torch.full((B, n_st + 1), worst, dtype=torch.float32,
                              device=q.device).scatter_reduce(
                1, bucket, flat, "amin" if lower else "amax")
            kth = torch.stack([sn[:, k - 1] for sn in snap], dim=1)
            gain = (best[:, :n_st] < kth) if lower else \
                (best[:, :n_st] > kth)
            for j, improving in enumerate(
                    synced(torch.Tensor.tolist, gain.any(0))):
                if improving:
                    cand = torch.cat([snap[j], torch.where(
                        bucket == j, flat, worst)], dim=-1)
                    snap[j] = torch.topk(cand, k, dim=-1, largest=not lower,
                                         sorted=True).values
    outs = []
    run = torch.full((B, k), worst, dtype=torch.float32, device=q.device)
    for j in range(n_st):
        run = torch.topk(torch.cat([run, snap[j]], dim=-1), k, dim=-1,
                         largest=not lower, sorted=True).values
        outs.append(run)
    return torch.stack(outs, dim=1)


def maxcodes_limit(sizes: torch.Tensor, nprobe: int, max_codes: int
                   ) -> torch.Tensor:
    """Per-query probe limit [B] int32 under a code-visit budget: the
    reference scans list ik, then breaks once ``nscan >= max_codes``
    (IndexIVF.cpp:539-541), so a query scans 1 + #(strict prefix sums <
    max_codes) lists, at most nprobe. ``sizes`` [B, nprobe] are the probed
    lists' code counts in rank order; ``max_codes`` 0 disables."""
    if max_codes <= 0:
        return torch.full(sizes.shape[:1], nprobe, dtype=torch.int32,
                          device=sizes.device)
    cum = torch.cumsum(sizes, dim=1)
    return ((cum < max_codes).sum(1) + 1).clamp_max(nprobe).to(torch.int32)


def ivf_search_fixed(arrays: IVFArrays, q: torch.Tensor, k: int,
                     nprobe: int, metric: Metric, max_codes: int = 0):
    """Fixed-nprobe search over the padded lists: (vals [B, k], ids [B, k])
    best-first. ``max_codes`` > 0 stops each query after the ranked list
    that crosses the code budget (IndexIVF.h:69)."""
    B = q.shape[0]
    q_sq = sqnorms(q)
    _, cids = coarse_rank(arrays, q, metric, q_sq=q_sq)
    vals, ids = init_topk((B,), k, metric, q.device)
    limit = maxcodes_limit(arrays.list_sizes[cids[:, :nprobe].long()],
                           nprobe, max_codes)
    return scan_probe_range(arrays, q, q_sq, cids, vals, ids, limit, 0,
                            nprobe, metric)


def ivf_search_fixed_ht(arrays: IVFArrays, q: torch.Tensor, k: int,
                        nprobe: int, ht: int, metric: Metric):
    """Fixed-nprobe IVF-PQ search with the polysemous Hamming filter
    (``auncel_tpu/index/scan.py:636-667``): the query is encoded once per
    probed list (residual PQ: the code of ``q - centroid[list]``, which
    the stored codes approximate), and a stored code more than ``ht`` bits
    from it is dropped before its distance counts."""
    B, d = q.shape
    q_sq = sqnorms(q)
    _, cids = coarse_rank(arrays, q, metric, q_sq=q_sq)
    lists = cids[:, :nprobe]
    pq = PQCodebooks(arrays.pq_codebooks)
    if arrays.pq_residual:
        target = q[:, None, :] - arrays.centroids[lists.long()]
    else:
        target = q[:, None, :].expand(B, nprobe, d)
    qcodes = encode_pq(pq, target.reshape(B * nprobe, d)).reshape(
        B, nprobe, -1)
    vals, ids = init_topk((B,), k, metric, q.device)
    limit = torch.full((B,), nprobe, dtype=torch.int32, device=q.device)
    return scan_probe_range(arrays, q, q_sq, lists, vals, ids, limit, 0,
                            nprobe, metric, qcodes=qcodes, ht=ht)
