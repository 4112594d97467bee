"""User-facing error-bounded search system (port of
``auncel_tpu/profile/error_sys.py``; reference ``Error_sys``,
profile.{h,cpp}).

Holds the ground truth, trains the offline profile (``sys_train``), binds
queries with per-query required recalls or latency budgets
(``set_queries``), auto-tunes (multipler, std_m) (``calibrate``) and serves
bounded searches (``search``, ``search_stream``) or latency-budgeted ones
(``time_search``), recording each query's ``my_nprobe`` and ``n_scanned``,
and in profile mode (``profile = True``) its achieved recall
(``t_recalls``).

Routes, as in the JAX package. With the multi-row layout, a window of at
most ``lat_bucket_max`` queries runs the single-phase wave engine under the
batch-1-shaped ``plan_latency``; a larger one runs the one-shot engine
(``bounded_oneshot_mr``), whose tail serves a query dense once its budget
covers ``dense_cut`` of the corpus rows, and serves the whole window dense
from the window size that ``calibrate`` measured to favour the shared pass
(``dense_auto``). Without the multi-row layout the padded engines run:
single-phase ``bounded_search`` for windows of at most 8 queries, else the
two-phase path (decision waves, then each straggler's remaining budget in
probe-width buckets).

The JAX package pads every window to a batch bucket (1, 16, 128, 1024);
the port runs each window at its own size. That moves only which route a
window takes (the A2 full-batch test and the dense flip compare the window
size), never its ids or decisions.
"""

import time

import numpy as np
import torch

from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.profile import hyper
from auncel_tpu_torch.profile.trainer import train_profile
from auncel_tpu_torch.profile.trace import (
    TraceSet, save_trace_set, load_trace_set)
from auncel_tpu_torch.profile.bounded import (
    bounded_search, bounded_search_decide, budgeted_search, finish_scan,
    nprobe_search, true_recall)
from auncel_tpu_torch.profile.bounded_mr import (
    bounded_oneshot_mr, bounded_search_mr, budgeted_search_mr,
    nprobe_search_mr, plan_latency, plan_oneshot)

# multi-row layouts below this many rows keep the gather tail (the shared
# corpus pass gains nothing on small corpora); dense_cut == 0.0 bypasses it
DENSE_MIN_ROWS = 2048


class ErrorSys:
    def __init__(self, index: IVFFlatIndex, train_num: int, max_topk: int):
        if train_num % 10 != 0:
            raise ValueError("train_num must be divisible by 10")
        if not isinstance(index, IVFFlatIndex):
            raise TypeError("ErrorSys requires an IVFFlatIndex")
        if index.is_trained:
            index.ensure_interdis()
        self.index = index
        self.train_num = train_num
        self.max_topk = max_topk
        self.is_trained = False
        self.traces: TraceSet | None = None
        self.raw_pairs = None
        self.multipler = hyper.DEFAULT_MULTIPLER
        self.std_m = hyper.DEFAULT_STD_M
        self.profile = False           # record t_recalls (effect_error mode)
        self.query_topk = max_topk
        # time-budget mode: the linear per-probe cost, and the measured
        # batch-1 cost table (calibrate_time; cost of i+1 lists at [i])
        self.per_probe_ms: float | None = None
        self._time_cost_table: np.ndarray | None = None
        # coalesce decision stages below this (plan_mr_waves)
        self.min_decide_stage = 1
        # per-query dense crossover: a query whose budget covers >= this
        # fraction of the corpus rows is served by a shared masked corpus
        # pass (None disables, 0.0 = always)
        self.dense_cut: float | None = 0.25
        # serve the decision ladder from one shared corpus pass
        self.dense_decide: bool = False
        # serve a whole window dense from the window size calibrate()
        # measured the shared pass to win at (_dense_min_bsz)
        self.dense_auto: bool = True
        self._cal_mean_scan: float | None = None
        self._dense_min_bsz: int | None = None
        # extra plan_oneshot kwargs (a2_cap, tail_cap, split, ...)
        self.plan_overrides: dict = {}
        # windows of at most this many queries ride plan_latency
        self.lat_bucket_max: int = 1
        self.lat_decide_stages: tuple = (16,)
        self.lat_serve_base: int = 256
        # k+1 exact-top-k decide margin: "auto" = on when some bound
        # demands the exact top-k
        self.decide_margin: bool | str = "auto"
        self.gt_D: np.ndarray | None = None
        self.gt_I: np.ndarray | None = None
        self.queries: np.ndarray | None = None
        self.require_acc: np.ndarray | None = None
        self.my_nprobe: np.ndarray | None = None
        self.n_scanned: np.ndarray | None = None
        self.t_recalls: np.ndarray | None = None
        self._mr_obj = None
        self._mr_plans: dict = {}

    # ------------------------------------------------------------ offline

    def set_gt(self, gt_D: np.ndarray, gt_I: np.ndarray) -> None:
        gt_D = np.asarray(gt_D, np.float32)
        gt_I = np.asarray(gt_I, np.int64)
        assert gt_D.shape[1] >= self.max_topk
        self.gt_D = gt_D[:, :self.max_topk].copy()
        self.gt_I = gt_I[:, :self.max_topk].copy()

    def sys_train(self, nq: int, xq: np.ndarray, bs: int = 250) -> None:
        """Train the phi -> U maps on the first ``nq`` queries."""
        assert self.gt_D is not None, "set_gt before sys_train"
        assert nq <= self.train_num
        self.index.ensure_interdis()
        xq = np.asarray(xq, np.float32)
        self.traces, self.raw_pairs = train_profile(
            self.index.arrays, xq[:nq], self.gt_D[:nq], self.max_topk,
            self.index.metric, bs=bs)
        self.is_trained = True

    def save_profile(self, path: str) -> None:
        assert self.is_trained
        save_trace_set(self.traces, path)

    def load_profile(self, path: str) -> None:
        self.traces = load_trace_set(path, self.index.device)
        self.is_trained = True

    # ------------------------------------------------------------- online

    def set_queries(self, n: int, queries: np.ndarray,
                    require_acc: np.ndarray,
                    alloc_size: int | None = None) -> None:
        """Bind the query set and per-query bounds (recalls, or budgets in
        ms for ``time_search``), indexed by absolute query id."""
        self.num = n
        self.queries = np.asarray(queries, np.float32)
        self.require_acc = np.asarray(require_acc, np.float32)
        if self.require_acc.shape[0] < self.queries.shape[0]:
            raise ValueError(
                f"require_acc has {self.require_acc.shape[0]} entries for "
                f"{self.queries.shape[0]} queries")
        alloc = alloc_size or self.require_acc.shape[0]
        self.my_nprobe = np.zeros(alloc, np.int64)
        self.n_scanned = np.zeros(alloc, np.int64)
        self.t_recalls = np.zeros(alloc, np.float32)

    def set_topk(self, k: int) -> None:
        assert k <= self.max_topk
        self.query_topk = k

    def setparam(self, figure_id: int) -> None:
        self.multipler, self.std_m = hyper.get_params(figure_id)
        self.profile = False  # reference setparam side effect

    def set_hyper(self, multipler: float, std_m: float) -> None:
        self.multipler, self.std_m = float(multipler), float(std_m)

    def _decide_margin_flag(self) -> bool:
        if self.query_topk + 1 > self.max_topk:
            return False
        if self.decide_margin == "auto":
            if self.require_acc is None:
                return False
            k = self.query_topk
            return bool(np.any(self.require_acc * k > k - 1 + 1e-4))
        return bool(self.decide_margin)

    # ------------------------------------------------- multirow plumbing

    def _mr(self):
        """The index's multi-row layout (or None), with the wave plans
        cached per layout object."""
        mr = self.index.multirow
        if mr is None:
            return None
        if self._mr_obj is not mr:
            self._mr_obj = mr
            self._mr_rpl = mr.rows_per_list.cpu().numpy()
            self._mr_plans = {}
        return mr

    def _mr_oneshot_plan(self, bsz: int | None = None):
        """The one-shot plan for a window of ``bsz`` queries (None: no
        window, as the time-budget engines use it)."""
        assert self._mr() is not None, "multirow layout not enabled"
        cut = None if self.dense_cut is None else float(self.dense_cut)
        if cut and self._mr_obj.rows.db.shape[0] < DENSE_MIN_ROWS:
            cut = None
        if (cut and bsz is not None and self.dense_auto
                and self._dense_min_bsz is not None
                and bsz >= self._dense_min_bsz):
            cut = 0.0  # the whole window dense
        dd = bool(self.dense_decide) and cut is not None
        key = ("oneshot", int(self.min_decide_stage), cut, dd,
               tuple(sorted(self.plan_overrides.items())))
        if key not in self._mr_plans:
            self._mr_plans[key] = plan_oneshot(
                self._mr_rpl, self.index.nlist,
                min_decide_stage=int(self.min_decide_stage),
                dense_cut=cut, dense_decide=dd, **self.plan_overrides)
        return self._mr_plans[key]

    def _mr_latency_plan(self):
        assert self._mr() is not None, "multirow layout not enabled"
        key = ("latency", tuple(self.lat_decide_stages),
               int(self.lat_serve_base))
        if key not in self._mr_plans:
            self._mr_plans[key] = plan_latency(
                self._mr_rpl, self.index.nlist,
                decide_stages=tuple(self.lat_decide_stages),
                serve_base=int(self.lat_serve_base))
        return self._mr_plans[key]

    @staticmethod
    def _width_buckets(need: np.ndarray, target: np.ndarray, base: int,
                       nlist: int):
        """Group straggler rows into geometric target-width buckets
        (4·base, 16·base, ..., nlist]: a straggler scans up to its bucket's
        width under its own limit, so the buckets change how many scans
        run, not their results."""
        widths = []
        w = max(base, 1) * 4
        while w < nlist:
            widths.append(w)
            w *= 4
        widths.append(nlist)
        lo = base
        for w in widths:
            rows = need[(target[need] > lo) & (target[need] <= w)]
            if rows.size:
                yield w, rows
            lo = w

    def _two_phase(self, q, acc, multipler, std_m, margin: bool):
        """Decision waves for the whole window, then ``finish_scan`` for the
        stragglers whose budget passes nlist/8, one scan per width
        bucket."""
        arrays = self.index.arrays
        metric = self.index.metric
        nlist = self.index.nlist
        cap_stage = nlist // 8
        vals, ids, my_np, decided, _, q_sq = bounded_search_decide(
            arrays, self.traces, q, acc, multipler, std_m, self.query_topk,
            self.max_topk, metric, decide_margin=margin)
        target = torch.maximum(my_np, decided).clamp_max(nlist)
        target_np = target.cpu().numpy()
        need = np.where(target_np > cap_stage)[0]
        for w, rows in self._width_buckets(need, target_np, cap_stage,
                                           nlist):
            sel = torch.as_tensor(rows, device=q.device)
            vals[sel], ids[sel] = finish_scan(
                arrays, q[sel], q_sq[sel], vals[sel], ids[sel], my_np[sel],
                cap_stage, w - cap_stage, metric)
        return vals, ids, my_np, target

    def _window(self, start: int, size: int, want_true: bool):
        """Device tensors of one window: queries, bounds, the GT k-th
        distances (profile mode; zeros otherwise), multipler and std_m."""
        dev = self.index.device
        f32 = torch.float32
        q = torch.as_tensor(self.queries[start:start + size], device=dev)
        acc = torch.as_tensor(self.require_acc[start:start + size],
                              device=dev)
        gt_kth = np.zeros(size, np.float32)
        if want_true:
            g = self.gt_D[start:start + size, self.query_topk - 1]
            gt_kth[:g.shape[0]] = g
        return (q, acc, torch.as_tensor(gt_kth, device=dev),
                torch.tensor(self.multipler, dtype=f32, device=dev),
                torch.tensor(self.std_m, dtype=f32, device=dev))

    def _record(self, start: int, size: int, out, want_true: bool):
        """Copy one window's results to the host, record my_nprobe,
        n_scanned (and t_recalls in profile mode) at absolute positions and
        return numpy (D [size, query_topk], I)."""
        vals, ids, my_np, n_scanned, t_rec = out
        k = self.query_topk
        if want_true:
            self.t_recalls[start:start + size] = t_rec.cpu().numpy()
        self.my_nprobe[start:start + size] = my_np.cpu().numpy()
        self.n_scanned[start:start + size] = n_scanned.cpu().numpy()
        return (vals[:, :k].cpu().numpy(),
                ids[:, :k].cpu().numpy().astype(np.int64))

    def search(self, start: int, search_size: int = -1):
        """Bounded search over queries[start : start + size]. Returns numpy
        (D [size, query_topk], I [size, query_topk]) and records my_nprobe,
        n_scanned and, in profile mode, t_recalls at absolute positions
        (see the module docstring for the routes)."""
        assert self.is_trained, "sys_train before search"
        size = self.num if search_size == -1 else search_size
        want_true = self.profile and self.gt_D is not None
        q, acc, gt_kth, multipler, std_m = self._window(start, size,
                                                        want_true)
        margin = self._decide_margin_flag()
        arrays, metric = self.index.arrays, self.index.metric
        mr = self._mr()
        if mr is not None:
            if size <= self.lat_bucket_max:
                engine, plan = bounded_search_mr, self._mr_latency_plan()
            else:
                engine, plan = bounded_oneshot_mr, self._mr_oneshot_plan(size)
            out = engine(arrays, mr, self.traces, q, acc, multipler, std_m,
                         gt_kth, self.query_topk, self.max_topk, metric,
                         plan, want_true, margin)
        elif size > 8:
            vals, ids, my_np, n_scanned = self._two_phase(
                q, acc, multipler, std_m, margin)
            t_rec = (true_recall(vals, gt_kth, my_np, self.query_topk,
                                 self.index.nlist, metric)
                     if want_true else None)
            out = (vals, ids, my_np, n_scanned, t_rec)
        else:
            out = bounded_search(
                arrays, self.traces, q, acc, multipler, std_m, gt_kth,
                self.query_topk, self.max_topk, metric,
                with_true_recall=want_true, decide_margin=margin)
        return self._record(start, size, out, want_true)

    def search_stream(self, start: int, total: int,
                      window: int | None = None, depth: int = 2):
        """Serve queries[start : start + total] as consecutive one-shot
        windows of ``window`` queries (default 1024), with up to ``depth``
        dispatched before the oldest is collected. Results and bookkeeping
        equal looping ``search`` over the same windows. The engine syncs
        with the host at every wave and compaction round, so what overlaps
        the next window is only a window's result copy. Without the
        multi-row layout it is ``search`` over the whole range."""
        if self._mr() is None:
            return self.search(start, total)
        window = window or 1024
        outs, in_flight = [], []
        for off in range(0, total, window):
            size = min(window, total - off)
            in_flight.append(self.dispatch_bounded(start + off, size))
            if len(in_flight) >= depth:
                outs.append(self.finish_bounded(in_flight.pop(0)))
        while in_flight:
            outs.append(self.finish_bounded(in_flight.pop(0)))
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    def dispatch_bounded(self, start: int, size: int):
        """Run ONE bounded window on the one-shot engine and leave its
        results on the device: an opaque handle for ``finish_bounded``."""
        mr = self._mr()
        if mr is None:
            raise ValueError("dispatch_bounded needs the multi-row layout")
        want_true = self.profile and self.gt_D is not None
        q, acc, gt_kth, multipler, std_m = self._window(start, size,
                                                        want_true)
        out = bounded_oneshot_mr(
            self.index.arrays, mr, self.traces, q, acc, multipler, std_m,
            gt_kth, self.query_topk, self.max_topk, self.index.metric,
            self._mr_oneshot_plan(size), want_true,
            self._decide_margin_flag())
        return (start, size, want_true, out)

    def finish_bounded(self, handle):
        """Fetch one ``dispatch_bounded`` handle's results and record the
        per-query bookkeeping (my_nprobe / n_scanned / t_recalls)."""
        start, size, want_true, out = handle
        return self._record(start, size, out, want_true)

    # -------------------------------------------------------- time budget

    def _nprobe_engine(self, q: torch.Tensor, probes: torch.Tensor):
        """The exact-count scan time_search spends budgets on."""
        arrays, metric = self.index.arrays, self.index.metric
        mr = self._mr()
        if mr is not None:
            return nprobe_search_mr(arrays, mr, q, probes, self.max_topk,
                                    metric, self._mr_oneshot_plan())
        return nprobe_search(arrays, q, probes, self.max_topk, metric)

    def calibrate_time(self, reps: int = 5, sample_q: int = 4,
                       grid: list | None = None) -> float:
        """Measure the batch-1 cost curve of the engine ``time_search``
        spends budgets on (the reference budgets the loop it times,
        IndexIVF.cpp:545-549): exact probe counts over a geometric grid on
        ``sample_q`` queries, the minimum of ``reps`` calls each (every
        call waits for its result), each query's n = 1 time subtracted,
        the maximum over queries (overpricing underspends, never
        overshoots), interpolated to a monotone table for n = 1..nlist.
        Returns the large-n marginal slope, also kept as per_probe_ms."""
        nlist = self.index.nlist
        if grid is None:
            grid = [1]
            while grid[-1] < nlist:
                grid.append(min(grid[-1] * 2, nlist))
        nq_avail = 0 if self.queries is None else self.queries.shape[0]
        sample_q = max(1, min(sample_q, max(nq_avail, 1)))
        dev = self.index.device

        def run(nprobe, qrow):
            q = torch.as_tensor(qrow[None], device=dev)
            probes = torch.full((1,), nprobe, dtype=torch.int32, device=dev)
            self._nprobe_engine(q, probes)[0].cpu()   # waits for the device

        qrows = (self.queries[:sample_q] if nq_avail
                 else np.zeros((1, self.index.d), np.float32))
        run(1, qrows[0])
        t = np.zeros((len(grid), len(qrows)), np.float64)
        for gi, n in enumerate(grid):
            for qi, qrow in enumerate(qrows):
                samples = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    run(n, qrow)
                    samples.append(time.perf_counter() - t0)
                t[gi, qi] = float(np.min(samples)) * 1e3
        cost = np.maximum(t - t[0][None, :], 0.0)
        cost_grid = np.maximum.accumulate(cost.max(axis=1))
        dense = np.interp(np.arange(1, nlist + 1, dtype=np.float64),
                          np.asarray(grid, np.float64), cost_grid)
        self._time_cost_table = np.maximum.accumulate(dense)
        span = max(grid[-1] - grid[-2], 1) if len(grid) > 1 else 1
        self.per_probe_ms = max(
            (cost_grid[-1] - cost_grid[-2]) / span if len(grid) > 1
            else cost_grid[-1] / max(grid[-1], 1), 1e-4)
        return self.per_probe_ms

    def time_cost_ms(self, n_probes) -> np.ndarray:
        """The calibrated model's cost (ms) of scanning ``n_probes`` lists
        at batch 1: what time_search believed when it converted budgets."""
        n = np.clip(np.asarray(n_probes, np.int64), 1, self.index.nlist)
        if self._time_cost_table is not None:
            return self._time_cost_table[n - 1]
        return n * float(self.per_probe_ms or 0.0)

    def _budget_to_probes(self, budget_ms: np.ndarray) -> np.ndarray:
        """Largest probe count whose calibrated cost fits 0.95x each
        budget (the reference's safety margin, IndexIVF.cpp:545-549)."""
        m = 0.95 * np.asarray(budget_ms, np.float64)
        n = np.searchsorted(self._time_cost_table, m, side="right")
        return np.clip(n, 1, self.index.nlist).astype(np.int32)

    def time_search(self, start: int, search_size: int = -1):
        """Latency-budget mode: require_acc holds per-query budgets in ms
        (reference time_search, profile.cpp:229-244). Budgets convert to
        probe counts up front: through the measured cost table when
        calibrate_time ran, else through the linear per_probe_ms model."""
        size = self.num if search_size == -1 else search_size
        if self.per_probe_ms is None:
            self.calibrate_time()
        dev = self.index.device
        q = torch.as_tensor(self.queries[start:start + size], device=dev)
        budget = self.require_acc[start:start + size]
        arrays, metric = self.index.arrays, self.index.metric
        mr = self._mr()
        if self._time_cost_table is not None:
            out = self._nprobe_engine(
                q, torch.as_tensor(self._budget_to_probes(budget),
                                   device=dev))
        else:
            per_probe = torch.tensor(self.per_probe_ms, dtype=torch.float32,
                                     device=dev)
            budget_t = torch.as_tensor(budget, device=dev)
            if mr is not None:
                out = budgeted_search_mr(arrays, mr, q, budget_t, per_probe,
                                         self.max_topk, metric,
                                         self._mr_oneshot_plan())
            else:
                out = budgeted_search(arrays, q, budget_t, per_probe,
                                      self.max_topk, metric)
        vals, ids, n_budget = out
        n_budget = n_budget.cpu().numpy()
        self.my_nprobe[start:start + size] = n_budget
        self.n_scanned[start:start + size] = n_budget
        k = self.query_topk
        return (vals[:, :k].cpu().numpy(),
                ids[:, :k].cpu().numpy().astype(np.int64))

    # ---------------------------------------------------------- utilities

    @staticmethod
    def recall(I: np.ndarray, gt_I: np.ndarray, topk: int) -> float:
        """Set-intersection recall@topk (reference Error_sys::recall)."""
        a = set(np.asarray(I[:topk]).tolist())
        b = set(np.asarray(gt_I[:topk]).tolist())
        a.discard(-1)
        return len(a & b) / topk

    def calibrate(self, start: int, size: int, target_bound: float,
                  max_multipler: float = 64.0, safety: float = 1.5,
                  std_m_grid: tuple = (0.2, 1.0, 4.0, 8.0, 12.0),
                  headroom: float | None = None) -> float:
        """Auto-tune (multipler, std_m) on held-out queries: for each std_m
        (largest first), binary-search the smallest multipler whose
        worst-case recall@query_k meets the bound on one half, escalate
        until the other half passes, keep the cheapest cell (a smaller
        std_m must be clearly cheaper), apply ``safety`` and re-validate
        the shipped multipler on the held-out half. Then record the
        held-out mean scan (``_cal_mean_scan``) and, on a multi-row layout
        of at least DENSE_MIN_ROWS rows, time the held-out window gathered
        and dense to set the window size from which ``dense_auto`` serves
        a window dense (``_dense_min_bsz``; None when dense lost)."""
        assert self.gt_D is not None and self.gt_I is not None
        if size < 1000 and self.index.ntotal >= 1_000_000:
            import warnings
            warnings.warn(
                f"calibrate() on {size} samples at ntotal="
                f"{self.index.ntotal}: below the measured generalization "
                f"floor of 1000 calibration queries at >= 1M scale",
                stacklevel=2)
        holdout_target = min(target_bound + (headroom or 0.0), 1.0)
        half = size // 2
        best_cost = np.inf
        best_pair = (max_multipler, 1.0)
        for sm in sorted(std_m_grid, reverse=True):
            self.std_m = float(sm)
            lo, hi = 1.0, max_multipler
            best = None
            for _ in range(7):
                mid = (lo + hi) / 2.0
                self.multipler = mid
                D, _ = self.search(start, half)
                if self._min_recall(D, start, half) >= target_bound:
                    best = mid
                    hi = mid
                else:
                    lo = mid
            if best is None:
                continue
            m = best
            ok = False
            while m <= max_multipler:
                self.multipler = m
                D, _ = self.search(start + half, size - half)
                if (self._min_recall(D, start + half, size - half)
                        >= holdout_target):
                    ok = True
                    break
                m *= 1.5
            if not ok:
                continue
            # cost of THIS cell: the holdout half was just searched at m
            cost = float(self.n_scanned[start + half:start + size].mean())
            if cost < best_cost * 0.85:
                best_cost = cost
                best_pair = (min(m * safety, max_multipler), float(sm))
        self.multipler, self.std_m = best_pair
        m = self.multipler
        while m <= max_multipler:
            self.multipler = m
            D, _ = self.search(start + half, size - half)
            if (self._min_recall(D, start + half, size - half)
                    >= holdout_target):
                break
            m *= 1.25
        self.multipler = min(m, max_multipler)
        # the holdout's mean scan at the shipped config, and the MEASURED
        # dense crossover: one gather window against one dense window of
        # the holdout; the shared pass costs about the same at any window
        # size and the gathers grow with it, so dense wins from about
        # probe * t_dense / t_gather queries. Routing never alters results,
        # so a mistimed probe costs only speed.
        self._cal_mean_scan = float(
            self.n_scanned[start + half:start + size].mean())
        self._dense_min_bsz = None
        mr = self._mr()
        if (self.dense_auto and mr is not None and self.dense_cut
                and mr.rows.db.shape[0] >= DENSE_MIN_ROWS):
            probe = size - half
            auto, self.dense_auto = self.dense_auto, False
            cut = self.dense_cut
            try:
                def timed():
                    self.search(start + half, probe)  # warm
                    t0 = time.perf_counter()
                    self.search(start + half, probe)  # returns host arrays
                    return time.perf_counter() - t0
                t_gather = timed()
                self.dense_cut = 0.0
                t_dense = timed()
                if t_dense < t_gather:
                    self._dense_min_bsz = max(
                        1, int(probe * t_dense / t_gather))
            finally:
                self.dense_cut, self.dense_auto = cut, auto
        return self.multipler

    def _min_recall(self, D: np.ndarray, start: int, size: int) -> float:
        from auncel_tpu_torch.autotune import worst_case_recall
        return worst_case_recall(D, self.gt_D[start:start + size],
                                 self.query_topk, self.index.metric)
