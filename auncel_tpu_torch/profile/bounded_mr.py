"""Bounded wave search over the multi-row layout (port of the single-phase
engine in ``auncel_tpu/profile/bounded_mr.py``).

Decision semantics are the reference's ``tune`` branch
(IndexIVF.cpp:497-673), evaluated batch-wide at wave boundaries: each query
advances a private row frontier, decides ``my_nprobe = floor(stage *
multipler)`` once its predicted recall meets its bound (or is forced to at
nlist/8), and then scans only its own budget. A wave nobody needs is
skipped; deciding that costs one host sync per wave (a Python ``if`` where
the JAX package has ``lax.cond``).

The wave planners ``plan_mr_waves`` and ``plan_latency`` are the JAX
package's numpy code, copied. The one-shot engine, the dense paths, the
resumable decide phases and the profile-mode true-recall count are not
ported yet.
"""

from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.scan import IVFArrays, coarse_rank, \
    scan_probe_range
from auncel_tpu_torch.index.multirow import MultiRowArrays, expand_probes
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.profile.geometry import boundary_distances, \
    n_boundaries
from auncel_tpu_torch.profile.trace import TraceSet
from auncel_tpu_torch.profile.bounded import (
    STAGNATION_FACTOR, wave_boundaries, stage_to_trace, _recall_estimate,
    exact_topk_mask)


class MRPlan(NamedTuple):
    """Static wave schedule. waves: ((stage, width_rows, decide, is_main),
    ...); S: ranked list slots expanded; out_slots: row slots expanded (the
    worst case over any query, so expansion never truncates)."""
    waves: tuple
    S: int
    out_slots: int


def plan_mr_waves(rows_per_list: np.ndarray, nlist: int, decide_only: bool,
                  slack: float = 1.35, min_width: int = 8,
                  min_stage: int = 0, max_stage: int | None = None,
                  exact_cover: bool = False,
                  min_decide_stage: int = 1) -> MRPlan:
    """Plan the waves from the per-list row counts: width per stage ~
    slack * mean rows/list * stage-delta, plus catch-up waves until the
    stage group covers the worst possible row increment of that stage, so
    every query completes each stage inside its group.
    ``min_decide_stage`` drops decision boundaries below it (their rows
    fold into the first kept stage; strictly bound-conservative)."""
    rpl = np.asarray(rows_per_list, np.int64)
    desc = np.sort(rpl)[::-1]
    sum_top = np.concatenate([[0], np.cumsum(desc)])
    mean_rpl = float(rpl.mean()) if rpl.size else 1.0
    cap_stage = max(nlist // 8, 1)
    bounds = wave_boundaries(nlist)
    if decide_only:
        bounds = [b for b in bounds if b <= cap_stage]
    if max_stage is not None:
        bounds = [b for b in bounds if b <= max_stage]
    if min_decide_stage > 1 and bounds:
        keep_from = min(int(min_decide_stage), cap_stage, bounds[-1])
        bounds = [b for b in bounds if b >= keep_from]
    S = bounds[-1] if decide_only else nlist
    out_slots = int(sum_top[min(S, nlist)])
    waves = []
    prev = min_stage
    for s in bounds:
        if s <= min_stage:
            prev = s
            continue
        delta = s - prev
        worst = int(sum_top[min(delta, len(desc))])
        if exact_cover:
            W = max(min_width, worst)
        else:
            W = max(min_width, int(np.ceil(delta * mean_rpl * slack)))
        n = max(1, -(-worst // W))
        decide = s <= cap_stage
        for j in range(n):
            waves.append((s, W, decide, j == 0))
        prev = s
    return MRPlan(tuple(waves), S, out_slots)


def plan_latency(rows_per_list: np.ndarray, nlist: int,
                 decide_stages: tuple = (4, 16, 64),
                 serve_base: int = 64) -> MRPlan:
    """Batch-1-shaped plan: a thinned decide ladder (``decide_stages`` plus
    the forced nlist/8, each one exact-cover wave) and a geometric serve
    tail (serve_base, 2*serve_base, ...) up to a full scan. Bound-
    conservative: a dropped stage's decision lands at the next kept one."""
    rpl = np.asarray(rows_per_list, np.int64)
    desc = np.sort(rpl)[::-1]
    sum_top = np.concatenate([[0], np.cumsum(desc)])
    cap_stage = max(nlist // 8, 1)
    allowed = {b for b in wave_boundaries(nlist) if b <= cap_stage}
    bad = [s for s in decide_stages
           if int(s) < cap_stage and int(s) not in allowed]
    if bad:
        raise ValueError(
            f"decide_stages {bad} are not trained boundaries "
            f"(powers of two below nlist/8 = {cap_stage})")
    stages = sorted({int(s) for s in decide_stages
                     if int(s) in allowed and int(s) < cap_stage})
    stages.append(cap_stage)
    waves = []
    prev = 0
    for s in stages:
        delta = s - prev
        W = max(8, int(sum_top[min(delta, len(desc))]))
        waves.append((s, W, True, True))
        prev = s
    total = max(int(rpl.sum()), 1)
    cum, w = 0, max(int(serve_base), 8)
    while cum < total:
        waves.append((nlist, w, False, False))
        cum += w
        w = min(w * 2, max(total - cum, 1))
    return MRPlan(tuple(waves), nlist, total)


def _goal_rows(offsets: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Rows covering each query's first g ranked lists (g in [1, S])."""
    return torch.gather(offsets, 1, (g - 1).long()[:, None])[:, 0]


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


def bounded_search_mr(
    arrays: IVFArrays,        # list-level state (centroids, interdis)
    mr: MultiRowArrays,
    traces: TraceSet,
    q: torch.Tensor,            # [B, d]
    require_acc: torch.Tensor,  # [B] float32
    multipler: torch.Tensor,    # 0-d float32
    std_m: torch.Tensor,        # 0-d float32
    query_k: int,
    max_topk: int,
    metric: Metric,
    plan: MRPlan,
    decide_margin: bool = False,
):
    """Single-phase bounded search over rows. Returns (vals [B, max_topk],
    ids, my_nprobe [B] in list units, n_scanned [B]).
    The decision arithmetic stays float32, as in the JAX package:
    ``floor(stage * multipler)`` in float64 would flip budgets."""
    B = q.shape[0]
    dev = q.device
    nlist = arrays.nlist
    cap_stage = max(nlist // 8, 1)
    exact_mask = None
    if decide_margin and query_k + 1 <= max_topk:
        exact_mask = exact_topk_mask(require_acc, query_k)
    q_sq = sqnorms(q)
    rank_k = min(nlist, max(plan.S, n_boundaries(nlist) + 1))
    cdis, cids = coarse_rank(arrays, q, metric, q_sq=q_sq, rank_k=rank_k)
    dtb = boundary_distances(cdis, cids, arrays.interdis, metric)
    row_slots, offsets = expand_probes(mr, cids, plan.S, plan.out_slots)
    safe_rows = row_slots.clamp_min(0)

    def zeros_i():
        return torch.zeros(B, dtype=torch.int32, device=dev)

    vals, ids = init_topk((B,), max_topk, metric, dev)
    my_np, decided_at, stoped = zeros_i(), zeros_i(), zeros_i()
    last_stage, frontier = zeros_i(), zeros_i()
    pre_val = torch.zeros(B, dtype=torch.float32, device=dev)
    stops = torch.floor(require_acc * STAGNATION_FACTOR).to(torch.int32)

    def cur_goal(my_np, stage):
        """Row target now: a decided query's own budget, else this stage."""
        g = torch.where(my_np > 0, my_np.clamp_max(plan.S),
                        min(stage, plan.S))
        return _goal_rows(offsets, g.clamp_min(1))

    for (stage, width, decide, _is_main) in plan.waves:
        goal = cur_goal(my_np, stage)
        # skip a wave nobody needs: an undecided query always has rows
        # left before its next boundary, so frontier < goal covers it
        if not bool((frontier < goal).any()):
            continue
        vals, ids = scan_probe_range(mr.rows, q, q_sq, safe_rows, vals, ids,
                                     goal, frontier, width, metric)
        frontier = torch.minimum(goal, frontier + width)
        if not decide:
            continue
        is_forced = stage >= cap_stage
        complete = frontier >= offsets[:, min(stage, plan.S) - 1]
        recall = _decide_at_stage(traces, dtb, vals, stage, nlist, query_k,
                                  max_topk, std_m, metric, exact_mask)
        # stagnation advances by the list gap since the last COMPLETE
        # boundary (the worst top-k value is monotone)
        max_val = vals[:, max_topk - 1]
        seen = last_stage > 0
        cmp_ok = complete & seen
        stoped = torch.where(cmp_ok & (max_val == pre_val),
                             stoped + (stage - last_stage),
                             torch.where(cmp_ok, 0, stoped))
        recall = torch.where((stoped >= stops) & seen, 1.0, recall)
        pre_val = torch.where(complete, max_val, pre_val)
        last_stage = torch.where(complete, stage, last_stage)

        sat = complete & (recall >= require_acc) & (my_np == 0)
        if is_forced:
            sat = sat | (complete & (my_np == 0))
        new_np = torch.floor(stage * multipler).to(torch.int32)
        if is_forced:
            # the forced decision must take effect; its conservative floor
            # is a full scan, as in the reference's control flow
            new_np = torch.where(new_np > 0, new_np, nlist)
        eff = sat & (new_np > 0)
        my_np = torch.where(eff, new_np, my_np)
        decided_at = torch.where(eff, stage, decided_at)

    n_scanned = torch.maximum(my_np, decided_at).clamp_max(nlist)
    return vals, ids, my_np, n_scanned
