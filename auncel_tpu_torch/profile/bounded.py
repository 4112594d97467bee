"""Bounded (early-terminating) search over the padded layout (port of
``auncel_tpu/profile/bounded.py``), and the helpers the multi-row engine
shares: wave boundaries, the stage -> trace map and the per-boundary recall
estimate.

Decision semantics are the reference's ``tune`` branch
(IndexIVF.cpp:497-673), evaluated batch-wide at wave boundaries: probes are
scanned in waves ending at the power-of-two trace stages (1, 2, ...,
nlist/8) and then in scan-only waves of nlist/8 up to nlist. A query that
meets its bound at a boundary decides ``my_nprobe = floor(stage *
multipler)`` and from then on scans only probe slots below it (the
``limit`` of ``scan_probe_range``, which K2 turns into unread inactive
slots). A wave nobody needs is skipped; deciding that costs one host sync
per wave (a Python ``if`` where the JAX package has ``lax.cond``).

``bounded_search`` is the single-phase engine. The two-phase path runs
``bounded_search_decide`` (the decision waves only, on a ranking prefix)
and then ``finish_scan`` over each query's remaining budget. Not ported
yet: the profile-mode true-recall count (``with_true_recall``), the
externally ranked on-disk decide phase, and the budgeted and fixed-count
searches.
"""

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.scan import IVFArrays, coarse_rank, \
    scan_probe_range
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.profile.geometry import boundary_distances, \
    n_boundaries, sum_angle
from auncel_tpu_torch.profile.trace import TraceSet, trace_lookup
from auncel_tpu_torch.profile.trainer import train_stages

FULL_OK_SLACK = 1.005       # cur_num's all-k fast path (IVF_pro.cpp:276)
STAGNATION_FACTOR = 12.0    # stops = require_acc * 12 (IndexIVF.cpp:575)


def wave_boundaries(nlist: int) -> list[int]:
    """Decision boundaries (powers of two to nlist/8) + scan-only
    boundaries (steps of nlist/8 up to nlist)."""
    bounds = train_stages(nlist)
    step = max(nlist // 8, 1)
    b = bounds[-1] + step
    while b <= nlist:
        bounds.append(b)
        b += step
    return bounds


def stage_to_trace(stage: int, nlist: int) -> int:
    """Smallest ind with 2^ind >= min(stage, nlist/8 - 1)
    (IndexIVF.cpp:555-558)."""
    tmp = min(stage, nlist // 8 - 1)
    ind = 0
    while tmp > (1 << ind):
        ind += 1
    return ind


def _simulate_cur_num(p: torch.Tensor, first_ok: torch.Tensor,
                      query_k: int) -> torch.Tensor:
    """Replay of the reference's binary search over candidate ranks
    (``error_pro::cur_num``, IVF_pro.cpp:258-291). ``p[b, m]`` is the
    predicate (m+1) * U(phi(D_m)) <= query_k, which is not guaranteed
    monotone, so the exact binary-search result is replayed instead of a
    count."""
    B = p.shape[0]
    dev = p.device
    low = torch.zeros(B, dtype=torch.int32, device=dev)
    high = torch.full((B,), query_k - 1, dtype=torch.int32, device=dev)
    done = first_ok.clone()
    result = torch.where(first_ok, query_k, 0).to(torch.int32)
    n_iter = max(int(np.ceil(np.log2(max(query_k, 2)))) + 1, 10)
    for _ in range(n_iter):
        active = (~done) & (low <= high)
        middle = torch.div(low + high, 2, rounding_mode="floor")
        ret0 = active & (middle <= 0)
        result = torch.where(ret0, 0, result)
        done = done | ret0
        pm = torch.gather(p, 1, middle.clamp(0, query_k - 1).long()[:, None]
                          )[:, 0]
        go = active & ~ret0
        low = torch.where(go & pm, middle + 1, low)
        high = torch.where(go & ~pm, middle - 1, high)
    return torch.where(done, result, low + 1)


def _recall_estimate(traces: TraceSet, dtb: torch.Tensor, tval: torch.Tensor,
                     ind: int, k: int, std_m: torch.Tensor) -> torch.Tensor:
    """phi -> U -> cur_num -> predicted recall at width ``k`` (the
    reference's per-boundary estimate, IVF_pro.cpp:258-291)."""
    kf = float(k)
    mrange = torch.arange(1, k + 1, dtype=torch.float32,
                          device=tval.device)[None, :]
    phi = sum_angle(tval[:, :k], dtb, (1 << ind) - 1)
    U = trace_lookup(traces, ind, phi, std_m)
    p = (mrange * U) <= kf
    first_ok = kf * U[:, k - 1] <= kf * FULL_OK_SLACK
    pre_num = _simulate_cur_num(p, first_ok, k)
    return pre_num.to(torch.float32) / kf


def exact_topk_mask(require_acc: torch.Tensor, query_k: int) -> torch.Tensor:
    """Queries whose bound demands the exact top-k: ceil(acc*k) == k <=>
    acc*k > k-1 (1e-4 slack for the f32 representation of 1 - eps)."""
    return require_acc * float(query_k) > float(query_k) - 1.0 + 1e-4


def _decide_at_stage(traces, dtb, vals, stage, nlist, query_k, max_topk,
                     std_m, metric, exact_mask=None):
    """The per-boundary termination predicate (IndexIVF.cpp:551-568) on the
    sorted top-k snapshot after exactly ``stage`` lists. ``exact_mask``
    marks queries whose bound demands the exact top-k: they also evaluate
    at width query_k + 1 and take the minimum (one spare neighbour)."""
    ind = stage_to_trace(stage, nlist)
    tval = vals
    if metric is Metric.IP:
        tval = torch.arccos(vals.clamp(-1.0, 1.0))
    recall = _recall_estimate(traces, dtb, tval, ind, query_k, std_m)
    if exact_mask is not None and query_k + 1 <= max_topk:
        r2 = _recall_estimate(traces, dtb, tval, ind, query_k + 1, std_m)
        recall = torch.where(exact_mask, torch.minimum(recall, r2), recall)
    return recall


def bounded_search(
    arrays: IVFArrays,
    traces: TraceSet,
    q: torch.Tensor,            # [B, d]
    require_acc: torch.Tensor,  # [B] float32 per-query required recall
    multipler: torch.Tensor,    # 0-d float32 calibration
    std_m: torch.Tensor,        # 0-d float32 conservativeness
    query_k: int,
    max_topk: int,
    metric: Metric,
    with_true_recall: bool = False,
    decide_margin: bool = False,
):
    """Single-phase bounded search over the padded lists. Returns (vals
    [B, max_topk], ids, my_nprobe [B], n_scanned [B])."""
    if with_true_recall:
        raise NotImplementedError(
            "profile mode (the true-recall count) is not ported yet")
    return _bounded_impl(arrays, traces, q, require_acc, multipler, std_m,
                         query_k, max_topk, metric, decide_only=False,
                         decide_margin=decide_margin)


def bounded_search_decide(
    arrays: IVFArrays,
    traces: TraceSet,
    q: torch.Tensor,
    require_acc: torch.Tensor,
    multipler: torch.Tensor,
    std_m: torch.Tensor,
    query_k: int,
    max_topk: int,
    metric: Metric,
    decide_margin: bool = False,
):
    """Phase A of the two-phase path: the decision waves only (stages 1 ..
    nlist/8). Returns (vals, ids, my_nprobe, decided_at, cids, q_sq);
    ``finish_scan`` completes each straggler's own budget."""
    return _bounded_impl(arrays, traces, q, require_acc, multipler, std_m,
                         query_k, max_topk, metric, decide_only=True,
                         decide_margin=decide_margin)


def finish_scan(arrays: IVFArrays, q: torch.Tensor, q_sq: torch.Tensor,
                vals: torch.Tensor, ids: torch.Tensor, my_np: torch.Tensor,
                start: int, width: int, metric: Metric):
    """Phase B: scan probe slots [start, start + width) under the limit
    ``my_np``. Re-ranks the full centroid set for this straggler subset
    (phase A ranked only a prefix); exact top-k prefixes agree, so the
    already-scanned slots line up."""
    _, cids = coarse_rank(arrays, q, metric, q_sq=q_sq)
    return scan_probe_range(arrays, q, q_sq, cids, vals, ids, my_np, start,
                            width, metric)


def _bounded_impl(arrays, traces, q, require_acc, multipler, std_m, query_k,
                  max_topk, metric, decide_only, decide_margin=False):
    B = q.shape[0]
    dev = q.device
    nlist = arrays.nlist
    q_sq = sqnorms(q)
    # decide-only needs the ranking prefix only: nlist/8 probe slots and
    # the boundary window; finish_scan ranks all lists for the stragglers
    rank_k = min(nlist, n_boundaries(nlist) + 1) if decide_only else nlist
    rank_k = max(rank_k, min(nlist, nlist // 8))
    cdis, cids = coarse_rank(arrays, q, metric, q_sq=q_sq, rank_k=rank_k)
    dtb = boundary_distances(cdis, cids, arrays.interdis, metric)
    vals, ids = init_topk((B,), max_topk, metric, dev)

    def zeros_i():
        return torch.zeros(B, dtype=torch.int32, device=dev)

    my_np, decided_at, stoped = zeros_i(), zeros_i(), zeros_i()  # 0: undecided
    pre_val = torch.zeros(B, dtype=torch.float32, device=dev)
    stops = torch.floor(require_acc * STAGNATION_FACTOR).to(torch.int32)
    exact_mask = None
    if decide_margin and query_k + 1 <= max_topk:
        exact_mask = exact_topk_mask(require_acc, query_k)

    boundaries = wave_boundaries(nlist)
    if decide_only:
        boundaries = [b for b in boundaries if b <= nlist // 8]
    prev = 0
    for wave_i, stage in enumerate(boundaries):
        width = stage - prev
        wave_prev, prev = prev, stage
        # one host sync per wave. A wave is needed while a query is
        # undecided or has budget beyond the wave's start; decided budgets
        # never change, so once a wave is not needed no later one is.
        undecided = my_np == 0
        need, any_undecided = torch.stack(
            [(undecided | (my_np > wave_prev)).any(),
             undecided.any()]).tolist()
        if not need:
            break
        limit = torch.where(my_np > 0, my_np, nlist)
        vals, ids = scan_probe_range(arrays, q, q_sq, cids, vals, ids, limit,
                                     wave_prev, width, metric)
        # the predicate only decides undecided queries
        if stage > nlist // 8 or not any_undecided:
            continue
        recall = _decide_at_stage(traces, dtb, vals, stage, nlist, query_k,
                                  max_topk, std_m, metric, exact_mask)
        max_val = vals[:, max_topk - 1]  # worst of the running top-k
        if wave_i > 0:
            stoped = torch.where(max_val == pre_val, stoped + width, 0)
            recall = torch.where(stoped >= stops, 1.0, recall)
        pre_val = max_val
        sat = (recall >= require_acc) & (my_np == 0)
        if stage >= nlist // 8:  # the forced decision (IndexIVF.cpp:619)
            sat = sat | (my_np == 0)
        new_np = torch.floor(stage * multipler).to(torch.int32)
        eff = sat & (new_np > 0)
        my_np = torch.where(eff, new_np, my_np)
        decided_at = torch.where(eff, stage, decided_at)

    if decide_only:
        return vals, ids, my_np, decided_at, cids, q_sq
    n_scanned = torch.maximum(my_np, decided_at).clamp_max(nlist)
    return vals, ids, my_np, n_scanned
