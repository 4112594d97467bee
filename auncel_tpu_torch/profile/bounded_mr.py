"""Bounded wave search over the multi-row layout (port of
``auncel_tpu/profile/bounded_mr.py``).

Decision semantics are the reference's ``tune`` branch
(IndexIVF.cpp:497-673), evaluated batch-wide at wave boundaries: each query
advances a private row frontier, decides ``my_nprobe = floor(stage *
multipler)`` once its predicted recall meets its bound (or is forced to at
nlist/8), and then scans only its own budget. A wave nobody needs is
skipped; deciding that costs one host sync per wave (a Python ``if`` where
the JAX package has ``lax.cond``).

Engines:

  * ``bounded_search_mr``: single phase, one plan for the whole window
    (``plan_latency`` at batch 1). With ``with_true_recall`` it also counts
    each query's achieved recall (profile mode).
  * ``bounded_oneshot_mr``: the production engine for larger windows. A1
    runs the early decision stages on the full batch; A2 compacts the
    undecided queries into ``a2_cap``-wide sub-batches for the late stages;
    the tail compacts the unfinished queries into ``tail_cap``-wide
    sub-batches, largest remaining work first, and scans each to its own
    budget. A query whose budget covers at least ``dense_cut`` of the
    corpus rows is served instead by a shared masked corpus pass
    (``index/scan.py::masked_full_scan``), and ``dense_decide`` replays the
    whole decision ladder from one such pass. Decisions and ids equal the
    single-phase engine's on the gather route.
  * ``bounded_search_decide_mr`` / ``bounded_resume_mr`` / ``finish_scan_mr``:
    the resumable phases (decide on a stage window, resume a re-batched
    subset, finish each straggler's budget).
  * ``nprobe_search_mr`` / ``budgeted_search_mr``: exact per-query probe
    counts, and latency budgets converted to counts (the time-budget mode).

The JAX package's ``lax.while_loop`` compaction loops are host loops here,
one sync per round. Each round provably finishes its sub-batch (A2 by the
forced decision at nlist/8, the tail by scanning to each budget), so a
loop that runs more rounds than that raises ``RuntimeError`` instead of
spinning. The planners (``plan_mr_waves``, ``plan_latency``,
``plan_finish_waves``, ``plan_oneshot``) are the JAX package's numpy code,
copied.
"""

from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.aux import ivf_stats
from auncel_tpu_torch.index.scan import (
    IVFArrays, coarse_rank, dense_stage_snapshots, inverse_rank,
    masked_full_scan, scan_probe_range)
from auncel_tpu_torch.index.multirow import MultiRowArrays, expand_probes
from auncel_tpu_torch.kernels.decide import MRDecide
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.profile.geometry import boundary_distances, \
    n_boundaries
from auncel_tpu_torch.profile.trace import TraceSet
from auncel_tpu_torch.profile.bounded import (
    STAGNATION_FACTOR, wave_boundaries, decision_step, exact_topk_mask,
    true_recall)
from auncel_tpu_torch.tracing import DECIDE, RANK, ROUND, WAVE, span, synced


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


def plan_finish_waves(rows_per_list: np.ndarray, nlist: int, w: int,
                      n_waves: int = 8, base_stage: int | None = None
                      ) -> tuple:
    """Equal row widths for ``finish_scan_mr`` on stragglers whose targets
    are <= w lists: their sum covers the worst row increment beyond the
    decide phase's frontier (the first ``base_stage`` ranked lists are
    complete, so at most the w - base_stage largest lists' rows remain)."""
    rpl = np.asarray(rows_per_list, np.int64)
    desc = np.sort(rpl)[::-1]
    base = base_stage if base_stage is not None else max(nlist // 8, 1)
    span = max(int(desc[: min(max(w - base, 1), len(desc))].sum()), 1)
    W = -(-span // n_waves)
    return tuple([W] * n_waves)




def _goal_rows(offsets: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Rows covering each query's first g ranked lists (g in [1, S])."""
    return torch.gather(offsets, 1, (g - 1).long()[:, None])[:, 0]


def _zeros_i(B: int, dev) -> torch.Tensor:
    return torch.zeros(B, dtype=torch.int32, device=dev)


def _round_guard(rounds: int, most: int, what: str) -> None:
    """Every compaction round finishes its sub-batch, so a loop past
    ``most`` rounds means a corrupted state or plan: fail, never spin."""
    if rounds > most:
        raise RuntimeError(
            f"{what}: round {rounds} of at most {most} left queries "
            f"unfinished (corrupted state or plan)")


def bounded_search_mr(
    arrays: IVFArrays,        # list-level state (centroids, interdis)
    mr: MultiRowArrays,
    traces: TraceSet,
    q: torch.Tensor,            # [B, d]
    require_acc: torch.Tensor,  # [B] float32
    multipler: torch.Tensor,    # 0-d float32
    std_m: torch.Tensor,        # 0-d float32
    gt_kth: torch.Tensor,       # [B] GT k-th distance (profile mode) or zeros
    query_k: int,
    max_topk: int,
    metric: Metric,
    plan: MRPlan,
    with_true_recall: bool = False,
    decide_margin: bool = False,
):
    """Single-phase bounded search over rows. Returns (vals [B, max_topk],
    ids, my_nprobe [B] in list units, n_scanned [B], true_recall [B])."""
    return _mr_impl(arrays, mr, traces, q, require_acc, multipler, std_m,
                    gt_kth, query_k, max_topk, metric, plan,
                    with_true_recall, decide_only=False,
                    decide_margin=decide_margin)


def bounded_search_decide_mr(arrays, mr, traces, q, require_acc, multipler,
                             std_m, query_k: int, max_topk: int,
                             metric: Metric, plan: MRPlan,
                             decide_margin: bool = False):
    """Decision waves over the plan's stage window. Returns the resumable
    state (vals, ids, my_nprobe, decided_at, stoped, pre_val, last_stage,
    row_frontier) and q_sq; continue with ``bounded_resume_mr`` and/or
    ``finish_scan_mr``."""
    z = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    return _mr_impl(arrays, mr, traces, q, require_acc, multipler, std_m,
                    z, query_k, max_topk, metric, plan, False,
                    decide_only=True, decide_margin=decide_margin)


def bounded_resume_mr(arrays, mr, traces, q, require_acc, multipler, std_m,
                      state: tuple, query_k: int, max_topk: int,
                      metric: Metric, plan: MRPlan,
                      decide_margin: bool = False):
    """Resume the decision waves of a re-batched subset on the stage window
    (min_stage, max_stage] of ``plan``: the carried 8-tuple ``state``
    supplies its top-k, stagnation counters and row frontier."""
    z = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    return _mr_impl(arrays, mr, traces, q, require_acc, multipler, std_m,
                    z, query_k, max_topk, metric, plan, False,
                    decide_only=True, init=state, decide_margin=decide_margin)


def _mr_impl(arrays, mr, traces, q, require_acc, multipler, std_m, gt_kth,
             query_k, max_topk, metric, plan, with_true_recall, decide_only,
             init=None, decide_margin=False):
    """The wave engine. The decision arithmetic stays float32, as in the
    JAX package: ``floor(stage * multipler)`` in float64 would flip
    budgets. A deciding wave's estimate and state update are one
    ``decision_step`` (one kernel launch on the card)."""
    B = q.shape[0]
    dev = q.device
    nlist = arrays.nlist
    cap_stage = max(nlist // 8, 1)
    with span(RANK):
        exact_mask = None
        if decide_margin and query_k + 1 <= max_topk:
            exact_mask = exact_topk_mask(require_acc, query_k)
        q_sq = sqnorms(q)
        rank_k = min(nlist, max(plan.S, n_boundaries(nlist) + 1))
        cdis, cids = coarse_rank(arrays, q, metric, q_sq=q_sq, rank_k=rank_k)
        dtb = boundary_distances(cdis, cids, arrays.interdis, metric)
        row_slots, offsets = expand_probes(mr, cids, plan.S, plan.out_slots)
        safe_rows = row_slots.clamp_min(0)
        if init is None:
            vals, ids = init_topk((B,), max_topk, metric, dev)
            my_np, decided_at, stoped = _zeros_i(B, dev), _zeros_i(B, dev), \
                _zeros_i(B, dev)
            last_stage, frontier = _zeros_i(B, dev), _zeros_i(B, dev)
            pre_val = torch.zeros(B, dtype=torch.float32, device=dev)
        else:
            (vals, ids, my_np, decided_at, stoped, pre_val, last_stage,
             frontier) = init
        stops = torch.floor(require_acc * STAGNATION_FACTOR).to(torch.int32)

    def cur_goal(my_np, stage):
        """Row target now: a decided query's own budget, else this stage."""
        g = torch.where(my_np > 0, my_np.clamp_max(plan.S),
                        min(stage, plan.S))
        return _goal_rows(offsets, g.clamp_min(1))

    for (stage, width, decide, _is_main) in plan.waves:
        with span(WAVE):
            goal = cur_goal(my_np, stage)
            # skip a wave nobody needs: an undecided query always has rows
            # left before its next boundary, so frontier < goal covers it
            if not synced(bool, (frontier < goal).any()):
                ivf_stats.waves_skipped += 1
                continue
            ivf_stats.waves += 1
            vals, ids = scan_probe_range(mr.rows, q, q_sq, safe_rows, vals,
                                         ids, goal, frontier, width, metric)
            frontier = torch.minimum(goal, frontier + width)
            if not decide:
                continue
            with span(DECIDE):
                (_, my_np, decided_at, stoped, pre_val,
                 last_stage) = decision_step(
                    traces, dtb, vals, stage, nlist, query_k, max_topk,
                    std_m, metric, exact_mask, MRDecide(
                        frontier, offsets[:, min(stage, plan.S) - 1],
                        require_acc, stops, multipler, my_np, decided_at,
                        stoped, pre_val, last_stage, stage,
                        stage >= cap_stage, nlist))

    if decide_only:
        return (vals, ids, my_np, decided_at, stoped, pre_val, last_stage,
                frontier), q_sq
    n_scanned = torch.maximum(my_np, decided_at).clamp_max(nlist)
    if with_true_recall:
        t_rec = true_recall(vals, gt_kth, my_np, query_k, nlist, metric)
    else:
        t_rec = torch.zeros(B, dtype=torch.float32, device=dev)
    return vals, ids, my_np, n_scanned, t_rec


class MROneShotPlan(NamedTuple):
    """Schedule of ``bounded_oneshot_mr`` (fields as in the JAX package)."""
    a1: MRPlan        # full-batch decide waves, stages <= split
    a2: MRPlan        # compacted decide waves, stages (split, nlist/8]
    tail_widths: tuple  # row widths per compacted tail round
    split: int
    a2_cap: int       # compacted sub-batch for late decide waves
    tail_cap: int     # compacted sub-batch for tail scans
    tail_out: int     # out_slots of the full-nlist tail expansion
    # per-query dense crossover (the reference's
    # distance_compute_blas_threshold, utils.cpp:538-622): a query whose
    # decided budget covers >= dense_cut_rows corpus rows is served by a
    # shared masked corpus pass; < 0 disables
    dense_cut_rows: int = -1
    dense_cap: int = 256    # compacted sub-batch for dense rounds
    mean_rpl: float = 1.0   # rows-per-list mean: list -> row unit estimate
    dense_block: int = 256  # corpus rows per dense-scan block
    dense_merge: int = 1    # dense blocks per exact top-k merge
    # serve the decision ladder from one shared corpus pass
    # (dense_stage_snapshots) instead of the A1/A2 gather waves
    dense_decide: bool = False
    decide_block: int = 128  # corpus rows per snapshot block


def plan_oneshot(rows_per_list: np.ndarray, nlist: int, split: int = 8,
                 a2_cap: int = 64, tail_cap: int = 256,
                 slack: float = 1.35, min_width: int = 8,
                 tail_waves: int | None = None,
                 min_decide_stage: int = 1,
                 dense_cut: float | None = None,
                 dense_cap: int = 256,
                 dense_block: int = 256,
                 dense_merge: int = 1,
                 dense_decide: bool = False,
                 decide_block: int = 128) -> MROneShotPlan:
    """``dense_cut`` enables the dense crossover: a query goes dense when
    its own decided row budget reaches ``dense_cut`` x the corpus rows (0.0
    = every query dense; None disables). ``tail_waves`` gives equal tail
    widths; the default is a geometric ladder 64, 128, ... so a small
    straggler runs only small waves."""
    rpl = np.asarray(rows_per_list, np.int64)
    cap_stage = max(nlist // 8, 1)
    split = min(split, cap_stage)
    a1 = plan_mr_waves(rpl, nlist, True, slack, min_width, 0, split,
                       exact_cover=True,
                       min_decide_stage=min_decide_stage)
    if split < cap_stage:
        a2 = plan_mr_waves(rpl, nlist, True, slack, min_width,
                           split, cap_stage, exact_cover=True,
                           min_decide_stage=min_decide_stage)
    else:
        a2 = MRPlan((), cap_stage, int(np.sort(rpl)[::-1][
            :min(cap_stage, rpl.size)].sum()))
    n_rows = int(rpl.sum())
    if tail_waves is not None:
        W = max(1, -(-n_rows // tail_waves))
        tail = tuple([W] * tail_waves)
    else:
        tail, w, cum = [], 64, 0
        while cum < n_rows:
            tail.append(w)
            cum += w
            w = min(w * 2, max(n_rows - cum, 1))
        tail = tuple(tail)
    mean_rpl = float(rpl.mean()) if rpl.size else 1.0
    cut_rows = -1 if dense_cut is None else int(dense_cut * n_rows)
    return MROneShotPlan(a1, a2, tail, split, a2_cap, tail_cap, n_rows,
                         cut_rows, dense_cap, mean_rpl, dense_block,
                         dense_merge, bool(dense_decide), decide_block)


def _dense_decide(arrays, mr, traces, q, q_sq, require_acc, multipler,
                  std_m, query_k, max_topk, metric, plan,
                  decide_margin=False):
    """The decision phase as ONE shared corpus pass and a replay of the
    ladder: ``dense_stage_snapshots`` gives the exact top-k values after
    each of the plan's decide stages, and the predicate, stagnation by list
    gap and the forced decision run on them as the wave engine runs them
    at each complete boundary. Decisions can differ from the gather waves'
    only where a query's predicate sits within the dense product's
    rounding of its threshold. Returns (my_np, decided_at)."""
    B = q.shape[0]
    dev = q.device
    nlist = arrays.nlist
    cap_stage = max(nlist // 8, 1)
    # the plan's decide boundaries, so that coalesced (min_decide_stage)
    # ladders decide at exactly the gather engine's stages
    stages = tuple(sorted({s for (s, _, dec, _) in
                           plan.a1.waves + plan.a2.waves if dec}))
    if not stages:
        stages = tuple(b for b in wave_boundaries(nlist) if b <= cap_stage)
    with span(RANK):
        rank_k = min(nlist, max(cap_stage, n_boundaries(nlist) + 1))
        cdis, cids = coarse_rank(arrays, q, metric, q_sq=q_sq, rank_k=rank_k)
        dtb = boundary_distances(cdis, cids, arrays.interdis, metric)
        # lists outside the decide window get rank nlist (outside every
        # stage)
        inv_rank = inverse_rank(cids[:, :cap_stage], nlist)
        stops = torch.floor(require_acc * STAGNATION_FACTOR).to(torch.int32)
        exact_mask = None
        if decide_margin and query_k + 1 <= max_topk:
            exact_mask = exact_topk_mask(require_acc, query_k)
        my_np, decided_at, stoped = _zeros_i(B, dev), _zeros_i(B, dev), \
            _zeros_i(B, dev)
        pre_val = torch.zeros(B, dtype=torch.float32, device=dev)
    # the ladder's one shared pass stands for its waves
    ivf_stats.waves += 1
    with span(WAVE):
        snaps = dense_stage_snapshots(
            mr.rows, mr.row_list, inv_rank, q, q_sq, stages, max_topk,
            metric, plan.decide_block)

    last_stage = 0
    for si, stage in enumerate(stages):
        with span(DECIDE):
            vals = snaps[:, si]
            recall = decision_step(traces, dtb, vals, stage, nlist,
                                   query_k, max_topk, std_m, metric,
                                   exact_mask)
            max_val = vals[:, max_topk - 1]
            if last_stage > 0:   # every boundary is complete here
                stoped = torch.where(max_val == pre_val,
                                     stoped + (stage - last_stage), 0)
                recall = torch.where(stoped >= stops, 1.0, recall)
            pre_val = max_val
            last_stage = stage
            is_forced = stage >= cap_stage
            sat = (recall >= require_acc) & (my_np == 0)
            if is_forced:
                sat = sat | (my_np == 0)
            new_np = torch.floor(stage * multipler).to(torch.int32)
            if is_forced:
                new_np = torch.where(new_np > 0, new_np, nlist)
            eff = sat & (new_np > 0)
            my_np = torch.where(eff, new_np, my_np)
            decided_at = torch.where(eff, stage, decided_at)
    # a ladder without a forced boundary floors to a full scan
    my_np = torch.where(my_np == 0, nlist, my_np)
    return my_np, decided_at


def _dense_rounds(arrays, mr, q, q_sq, vals, ids, pending, target,
                  max_topk, metric, plan):
    """Serve ``pending`` queries by compacted shared corpus passes: sort
    them to the front, run one ``masked_full_scan`` over a
    ``dense_cap``-wide sub-batch, and write the fresh top-k back, until
    none is left. The dense result REPLACES the running top-k: rank <
    target covers every row the decision phases scanned. A query's values
    depend only on its own rows and budget, never on its sub-batch."""
    nlist = arrays.nlist
    cap = plan.dense_cap
    n_left = synced(int, pending.sum())
    most = -(-n_left // max(cap, 1))
    rounds = 0
    while n_left:
        rounds += 1
        _round_guard(rounds, most, "dense rounds")
        ivf_stats.rounds += 1
        with span(ROUND):
            # pending first; a stable sort on an integer key, as
            # jnp.argsort
            idx = torch.argsort((~pending).to(torch.int32),
                                stable=True)[:cap]
            take = pending[idx]
            subq, sub_sq = q[idx], q_sq[idx]
            with span(RANK):
                _, cids_full = coarse_rank(arrays, subq, metric, q_sq=sub_sq)
                inv_rank = inverse_rank(cids_full, nlist)
            tgt = torch.where(take, target[idx].clamp(1, nlist), 0)
            v, i = masked_full_scan(mr.rows, mr.row_list, inv_rank, tgt,
                                    subq, sub_sq, max_topk, metric,
                                    plan.dense_block, plan.dense_merge)
            vals = vals.index_copy(0, idx, torch.where(take[:, None], v,
                                                       vals[idx]))
            ids = ids.index_copy(0, idx, torch.where(take[:, None], i,
                                                     ids[idx]))
            pending = pending.index_fill(0, idx, False)
            n_left = synced(int, pending.sum())
    return vals, ids


def _tail_dispatch(arrays, mr, q, q_sq, vals, ids, frontier, covered,
                   target, max_topk, metric, plan):
    """Tail scanning with the per-query dense crossover: queries whose
    budget covers >= plan.dense_cut_rows corpus rows ride compacted shared
    passes, the rest the compacted gather rounds. Both give the exact top-k
    of each query's first ``target`` ranked lists."""
    if plan.dense_cut_rows >= 0:
        # float32, as the JAX package compares
        est_rows = (target.clamp(0, arrays.nlist).to(torch.float32)
                    * float(np.float32(plan.mean_rpl)))
        sel = est_rows >= float(np.float32(plan.dense_cut_rows))
        vals, ids = _dense_rounds(arrays, mr, q, q_sq, vals, ids, sel,
                                  target, max_topk, metric, plan)
        # dense-served queries leave the gather rounds finished, with the
        # row frontier past every slot, so riding a later round as padding
        # never rescans (and merges twice) rows their top-k already holds
        covered = torch.where(sel, target, covered)
        frontier = torch.where(sel, plan.tail_out, frontier)
    vals, ids, _, _ = _tail_rounds(arrays, mr, q, q_sq, vals, ids, frontier,
                                   covered, target, plan.tail_widths,
                                   plan.tail_cap, plan.tail_out, metric)
    return vals, ids


def _tail_rounds(arrays, mr, q, q_sq, vals, ids, frontier, covered, target,
                 tail_widths, tail_cap, tail_out, metric):
    """Compacted tail scanning: while some query has covered fewer lists
    than its target, sort the unfinished ones to the front, largest
    remaining work first (so later rounds skip most of the width ladder),
    advance a ``tail_cap``-wide sub-batch's row frontiers to their own
    targets over the widths, skipping the widths nobody needs, and write
    back. Returns (vals, ids, frontier, covered)."""
    nlist = arrays.nlist
    unfinished = covered < target
    n_left = synced(int, unfinished.sum())
    most = -(-n_left // max(tail_cap, 1))
    rounds = 0
    while n_left:
        rounds += 1
        _round_guard(rounds, most, "tail rounds")
        ivf_stats.rounds += 1
        with span(ROUND):
            key = ((~unfinished).to(torch.int32) * (2 * nlist)
                   - (target - covered))
            idx = torch.argsort(key, stable=True)[:tail_cap]
            subq, sub_sq = q[idx], q_sq[idx]
            with span(RANK):
                _, cids = coarse_rank(arrays, subq, metric, q_sq=sub_sq)
                row_slots, offsets = expand_probes(mr, cids, nlist, tail_out)
                safe_rows = row_slots.clamp_min(0)
                goal = _goal_rows(offsets, target[idx])
                v, i, f = vals[idx], ids[idx], frontier[idx]
            for width in tail_widths:
                with span(WAVE):
                    # frontiers only grow: no later width is needed
                    if not synced(bool, (f < goal).any()):
                        ivf_stats.waves_skipped += 1
                        break
                    ivf_stats.waves += 1
                    v, i = scan_probe_range(mr.rows, subq, sub_sq, safe_rows,
                                            v, i, goal, f, width, metric)
                    f = torch.minimum(goal, f + width)
            vals = vals.index_copy(0, idx, v)
            ids = ids.index_copy(0, idx, i)
            frontier = frontier.index_copy(0, idx, f)
            covered = covered.index_copy(0, idx, target[idx])
            unfinished = covered < target
            n_left = synced(int, unfinished.sum())
    return vals, ids, frontier, covered


def _a2_rounds(arrays, mr, traces, q, require_acc, multipler, std_m, state,
               query_k, max_topk, metric, plan, decide_margin=False):
    """The late decision stages (split, nlist/8] for the queries A1 left
    undecided. When most of the batch is undecided, the stages run once on
    the full batch first (compaction would multiply the per-wave fixed
    costs for the same rows); then, while any query is undecided, the
    undecided are sorted to the front and an ``a2_cap``-wide sub-batch
    runs the stages from its carried state. Every round decides its
    sub-batch (the forced decision at nlist/8), so the rounds are at most
    ceil(undecided / a2_cap)."""
    B = q.shape[0]
    n_und = synced(int, (state[2] == 0).sum())
    if n_und > B // 2:
        z = torch.zeros(B, dtype=torch.float32, device=q.device)
        state, _ = _mr_impl(arrays, mr, traces, q, require_acc, multipler,
                            std_m, z, query_k, max_topk, metric, plan.a2,
                            False, decide_only=True, init=state,
                            decide_margin=decide_margin)
        n_und = synced(int, (state[2] == 0).sum())
    most = -(-n_und // max(plan.a2_cap, 1))
    rounds = 0
    while n_und:
        rounds += 1
        _round_guard(rounds, most, "A2 rounds")
        ivf_stats.rounds += 1
        with span(ROUND):
            idx = torch.argsort((state[2] != 0).to(torch.int32),
                                stable=True)[:plan.a2_cap]  # undecided first
            sub = tuple(x[idx] for x in state)
            zs = torch.zeros(idx.shape[0], dtype=torch.float32,
                             device=q.device)
            sub_out, _ = _mr_impl(arrays, mr, traces, q[idx],
                                  require_acc[idx], multipler, std_m, zs,
                                  query_k, max_topk, metric, plan.a2, False,
                                  decide_only=True, init=sub,
                                  decide_margin=decide_margin)
            state = tuple(x.index_copy(0, idx, y)
                          for x, y in zip(state, sub_out))
            n_und = synced(int, (state[2] == 0).sum())
    return state


def budgeted_search_mr(arrays, mr: MultiRowArrays, q: torch.Tensor,
                       budget_ms: torch.Tensor, per_probe_ms: torch.Tensor,
                       max_topk: int, metric: Metric, plan: MROneShotPlan):
    """Latency-budget mode over the rows (reference ``time_search``,
    IndexIVF.cpp:545-549): budgets convert up front to probe counts,
    ceil(0.95 * budget / per_probe_ms - 1) in float32 as in the JAX package,
    then scan through the compacted tail rounds."""
    n_budget = torch.ceil(0.95 * budget_ms / per_probe_ms - 1.0)
    return nprobe_search_mr(arrays, mr, q, n_budget, max_topk, metric, plan)


def nprobe_search_mr(arrays, mr: MultiRowArrays, q: torch.Tensor,
                     n_probes: torch.Tensor, max_topk: int, metric: Metric,
                     plan: MROneShotPlan):
    """Exact per-query probe-count scan (the replay entry point: callers
    pass counts, since inverting the budget -> probe ceil in float32 is off
    by one for some counts). Returns (vals, ids, n_probes in [1, nlist])."""
    B = q.shape[0]
    dev = q.device
    q_sq = sqnorms(q)
    n_probes = n_probes.clamp(1, arrays.nlist).to(torch.int32)
    vals, ids = init_topk((B,), max_topk, metric, dev)
    vals, ids = _tail_dispatch(arrays, mr, q, q_sq, vals, ids,
                               _zeros_i(B, dev), _zeros_i(B, dev), n_probes,
                               max_topk, metric, plan)
    return vals, ids, n_probes


def bounded_oneshot_mr(
    arrays: IVFArrays,
    mr: MultiRowArrays,
    traces: TraceSet,
    q: torch.Tensor,
    require_acc: torch.Tensor,
    multipler: torch.Tensor,
    std_m: torch.Tensor,
    gt_kth: torch.Tensor,
    query_k: int,
    max_topk: int,
    metric: Metric,
    plan: MROneShotPlan,
    with_true_recall: bool = False,
    decide_margin: bool = False,
):
    """The production bounded search: A1 decision waves on the full batch,
    the A2 rounds for the undecided, then the tail (gather rounds or dense
    passes) to each query's own budget. With ``plan.dense_decide`` the
    decisions come from one shared corpus pass instead and the tail serves
    each budget from a fresh top-k. Decisions equal ``bounded_search_mr``'s
    on the same stages. Returns (vals, ids, my_nprobe, n_scanned,
    true_recall), as ``bounded_search_mr`` does."""
    B = q.shape[0]
    dev = q.device
    nlist = arrays.nlist
    cap_stage = max(nlist // 8, 1)
    if plan.dense_decide:
        q_sq = sqnorms(q)
        my_np, decided_at = _dense_decide(
            arrays, mr, traces, q, q_sq, require_acc, multipler, std_m,
            query_k, max_topk, metric, plan, decide_margin)
        target = torch.maximum(my_np, decided_at).clamp(1, nlist)
        vals, ids = init_topk((B,), max_topk, metric, dev)
        vals, ids = _tail_dispatch(arrays, mr, q, q_sq, vals, ids,
                                   _zeros_i(B, dev), _zeros_i(B, dev),
                                   target, max_topk, metric, plan)
    else:
        z = torch.zeros(B, dtype=torch.float32, device=dev)
        state, q_sq = _mr_impl(arrays, mr, traces, q, require_acc,
                               multipler, std_m, z, query_k, max_topk,
                               metric, plan.a1, False, decide_only=True,
                               decide_margin=decide_margin)
        if plan.a2.waves:
            state = _a2_rounds(arrays, mr, traces, q, require_acc, multipler,
                               std_m, state, query_k, max_topk, metric, plan,
                               decide_margin)
        vals, ids, my_np, decided_at, _, _, _, frontier = state
        target = torch.maximum(my_np, decided_at).clamp(1, nlist)
        # lists certainly covered: decided in A1 -> min(budget, split), in
        # A2 -> min(budget, nlist/8); a query that rode an A2 round as
        # padding may be further along, and its tail round then scans
        # nothing
        covered = torch.minimum(target, torch.where(
            decided_at <= plan.split, plan.split, cap_stage).to(torch.int32))
        vals, ids = _tail_dispatch(arrays, mr, q, q_sq, vals, ids, frontier,
                                   covered, target, max_topk, metric, plan)
    if with_true_recall:
        t_rec = true_recall(vals, gt_kth, my_np, query_k, nlist, metric)
    else:
        t_rec = torch.zeros(B, dtype=torch.float32, device=dev)
    return vals, ids, my_np, target, t_rec


def finish_scan_mr(arrays, mr: MultiRowArrays, q: torch.Tensor,
                   q_sq: torch.Tensor, vals: torch.Tensor, ids: torch.Tensor,
                   my_np: torch.Tensor, frontier: torch.Tensor, w: int,
                   out_slots: int, widths: tuple, metric: Metric):
    """Complete each straggler's own row budget (at most ``w`` lists,
    expanded to ``out_slots`` rows) over the row ``widths``
    (``plan_finish_waves``). Re-ranks every centroid for this subset: exact
    top-k prefixes agree with the decide phase's ranking, so the frontiers
    line up. Returns (vals, ids, frontier)."""
    _, cids = coarse_rank(arrays, q, metric, q_sq=q_sq)
    row_slots, offsets = expand_probes(mr, cids, w, out_slots)
    safe_rows = row_slots.clamp_min(0)
    goal = _goal_rows(offsets, my_np.clamp(1, w))
    for width in widths:
        if not bool((frontier < goal).any()):
            break   # frontiers only grow: no later width is needed
        vals, ids = scan_probe_range(mr.rows, q, q_sq, safe_rows, vals, ids,
                                     goal, frontier, width, metric)
        frontier = torch.minimum(goal, frontier + width)
    return vals, ids, frontier
