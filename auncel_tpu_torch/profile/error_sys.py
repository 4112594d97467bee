"""User-facing error-bounded search system (port of
``auncel_tpu/profile/error_sys.py``; reference ``Error_sys``,
profile.{h,cpp}).

Holds the ground truth, trains the offline profile (``sys_train``), binds
queries with per-query required recalls (``set_queries``), auto-tunes
(multipler, std_m) (``calibrate``) and serves bounded searches
(``search``), recording each query's ``my_nprobe`` and ``n_scanned``.

With the multi-row layout, ``search`` runs the single-phase wave engine
over the rows: windows of at most ``lat_bucket_max`` queries under the
batch-1-shaped ``plan_latency``, larger ones under ``plan_mr_waves`` (whose
ids, values and decisions equal the JAX package's one-shot engine).
Without it, the padded engines run: single-phase ``bounded_search`` for
windows of at most 8 queries, else the two-phase path (decision waves,
then each straggler's remaining budget in probe-width buckets). Not ported
yet: the one-shot and dense engines, streaming dispatch, the time-budget
mode and profile mode (``t_recalls``).
"""

import numpy as np
import torch

from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.profile import hyper
from auncel_tpu_torch.profile.trainer import train_profile
from auncel_tpu_torch.profile.trace import (
    TraceSet, save_trace_set, load_trace_set)
from auncel_tpu_torch.profile.bounded import (
    bounded_search, bounded_search_decide, finish_scan)
from auncel_tpu_torch.profile.bounded_mr import (
    bounded_search_mr, plan_latency, plan_mr_waves)


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
        self.query_topk = max_topk
        # coalesce decision stages below this (plan_mr_waves)
        self.min_decide_stage = 1
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
        self._plans: dict = {}
        self._plans_for = None

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
        """Bind the query set and per-query bounds, indexed by absolute
        query id."""
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

    def set_topk(self, k: int) -> None:
        assert k <= self.max_topk
        self.query_topk = k

    def setparam(self, figure_id: int) -> None:
        self.multipler, self.std_m = hyper.get_params(figure_id)

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

    def _plan(self, mr, size: int):
        """The multi-row wave plan for a window of ``size`` queries, cached
        per layout instance."""
        if self._plans_for is not mr:
            self._plans_for = mr
            self._rpl = mr.rows_per_list.cpu().numpy()
            self._plans = {}
        latency = size <= self.lat_bucket_max
        key = (("latency", tuple(self.lat_decide_stages),
                int(self.lat_serve_base)) if latency
               else ("waves", int(self.min_decide_stage)))
        if key not in self._plans:
            self._plans[key] = (
                plan_latency(self._rpl, self.index.nlist,
                             decide_stages=key[1], serve_base=key[2])
                if latency else
                plan_mr_waves(self._rpl, self.index.nlist, decide_only=False,
                              min_decide_stage=key[1]))
        return self._plans[key]

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

    def search(self, start: int, search_size: int = -1):
        """Bounded search over queries[start : start + size]. Returns numpy
        (D [size, query_topk], I [size, query_topk]) and records my_nprobe
        and n_scanned at absolute positions. The multi-row layout, when
        enabled, takes every window; else windows of more than 8 queries
        run the two-phase path and smaller ones single-phase
        ``bounded_search`` (the two give equal results)."""
        assert self.is_trained, "sys_train before search"
        size = self.num if search_size == -1 else search_size
        dev = self.index.device
        q = torch.as_tensor(self.queries[start:start + size], device=dev)
        acc = torch.as_tensor(self.require_acc[start:start + size],
                              device=dev)
        f32 = torch.float32
        multipler = torch.tensor(self.multipler, dtype=f32, device=dev)
        std_m = torch.tensor(self.std_m, dtype=f32, device=dev)
        margin = self._decide_margin_flag()
        mr = self.index.multirow
        if mr is not None:
            vals, ids, my_np, n_scanned = bounded_search_mr(
                self.index.arrays, mr, self.traces, q, acc, multipler, std_m,
                self.query_topk, self.max_topk, self.index.metric,
                self._plan(mr, size), margin)
        elif size > 8:
            vals, ids, my_np, n_scanned = self._two_phase(
                q, acc, multipler, std_m, margin)
        else:
            vals, ids, my_np, n_scanned = bounded_search(
                self.index.arrays, self.traces, q, acc, multipler, std_m,
                self.query_topk, self.max_topk, self.index.metric,
                decide_margin=margin)
        k = self.query_topk
        vals, ids = vals[:, :k].cpu().numpy(), ids[:, :k].cpu().numpy()
        self.my_nprobe[start:start + size] = my_np.cpu().numpy()
        self.n_scanned[start:start + size] = n_scanned.cpu().numpy()
        return vals, ids.astype(np.int64)

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
        the shipped multipler on the held-out half."""
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
        return self.multipler

    def _min_recall(self, D: np.ndarray, start: int, size: int) -> float:
        from auncel_tpu_torch.autotune import worst_case_recall
        return worst_case_recall(D, self.gt_D[start:start + size],
                                 self.query_topk, self.index.metric)
