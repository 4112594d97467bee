"""The system under test: ``auncel_tpu_torch``'s error-bounded search,
driven through its public entry points as a deployment serves it.

Set-up builds the configuration's IVF index (k-means on the first
``train_n`` vectors, add, pack, the multi-row layout), the profile's ground
truth with the index's own ``exact_search``, the phi -> U profile
(``ErrorSys.sys_train``) on the profile queries, and the calibration of
(multipler, std_m) with its timed route probe (``ErrorSys.calibrate``) on
the calibration queries, with ``calibrate``'s own defaults. The timed path
is ``ErrorSys.search`` over windows of the served pool: a window of one
query runs the latency engine, a larger one the one-shot engine, gathered
or dense as ``calibrate``'s timed probe decided. Nothing here reads the
pool's ground truth.
"""

import gc
import time

import numpy as np
import torch


def synced(fn):
    """(fn(), seconds) with the device drained before the clock stops."""
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class System:
    def __init__(self, config: dict, traffic: dict, device):
        self.cfg, self.traffic, self.device = config, traffic, device
        self.times: dict = {}
        self.es = None
        self.idx = None

    def setup(self, xb: np.ndarray, q_setup: np.ndarray,
              pool: np.ndarray) -> dict:
        """Build and calibrate; returns what the run reports of it (the
        stage times are in ``self.times``)."""
        t0 = time.perf_counter()
        import auncel_tpu_torch as port
        self.times["import"] = time.perf_counter() - t0
        ix, prof = self.cfg["index"], self.cfg["profile"]
        n_prof, n_cal = int(prof["profile_queries"]), int(
            prof["calibration_queries"])
        k, bound = int(self.traffic["k"]), float(self.traffic["recall_bound"])
        idx = port.IVFFlatIndex(xb.shape[1], int(ix["nlist"]),
                                storage=ix["storage"],
                                sq_rangestat=ix.get("sq_rangestat", "minmax"),
                                device=self.device)
        self.idx = idx
        _, self.times["train"] = synced(
            lambda: idx.train(xb[:int(ix["train_n"])]))
        _, self.times["add_pack"] = synced(lambda: (idx.add(xb), idx.arrays))
        _, self.times["multirow"] = synced(
            lambda: idx.enable_multirow(int(ix["row_cap"])))
        max_topk = int(prof["max_topk"])
        (gt_D, gt_I), self.times["profile_gt"] = synced(
            lambda: idx.exact_search(q_setup, max_topk, batch=1000))
        es = port.ErrorSys(idx, train_num=n_prof + n_cal, max_topk=max_topk)
        self.es = es
        es.set_gt(gt_D, gt_I)
        _, self.times["sys_train"] = synced(
            lambda: es.sys_train(n_prof, q_setup))
        es.set_topk(k)
        queries = np.concatenate([q_setup, pool])
        es.set_queries(pool.shape[0], queries,
                       np.full(queries.shape[0], bound, np.float32))
        self.pool_start = q_setup.shape[0]
        _, self.times["calibrate"] = synced(
            lambda: es.calibrate(n_prof, n_cal, target_bound=bound))
        window = int(self.traffic["window"])
        dense_from = es._dense_min_bsz
        if window <= es.lat_bucket_max:
            route = "latency"
        elif dense_from is not None and window >= dense_from:
            route = "dense"
        else:
            route = "gathers"
        return {"multipler": float(es.multipler), "std_m": float(es.std_m),
                "cal_mean_scan": es._cal_mean_scan,
                "dense_min_bsz": dense_from,
                "route": route}

    def search(self, offset: int, size: int):
        """One window of the served pool from ``offset``: numpy (D, I) and
        the lists each query scanned."""
        start = self.pool_start + offset
        D, I = self.es.search(start, size)
        return D, I, self.es.n_scanned[start:start + size].copy()

    def scan_layout(self) -> dict:
        """What the roofline's work function reads of the index: centroids,
        list sizes and bytes a stored vector."""
        a = self.idx.arrays
        return {"centroids": torch.as_tensor(self.idx.centroids),
                "list_sizes": a.list_sizes.cpu().numpy().astype(np.int64),
                "code_bytes": int(a.db.shape[-1] * a.db.element_size())}

    def close(self) -> None:
        """Free the program's state on the device."""
        self.es = self.idx = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
