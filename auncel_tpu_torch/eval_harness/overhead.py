"""Error-profile overhead microbenchmark (port of
``auncel_tpu/eval_harness/overhead.py``; reference ``eval/overhead.cpp``,
``IndexIVF.cpp:528-539,679-680``): bounded search with the profile
machinery (boundary geometry, phi, trace lookups, the predicate) against
the bare scans over the same probe counts, on the multi-row layout.

"With ELP" is the bounded engine (``ErrorSys.search``); "without" replays
each query's exact ``n_scanned`` through ``nprobe_search_mr`` (scan only,
no predicate), asserted to scan the same counts. Each rep of either side
copies its result to the host once.

    python -m auncel_tpu_torch.eval_harness.overhead synth100K 1000 1000 \\
        10 0.10
"""

import argparse
import time

import numpy as np
import torch

from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.profile.bounded_mr import nprobe_search_mr
from auncel_tpu_torch.profile.error_sys import ErrorSys


def run(db: str = "synth100K", ts: int = 1000, ses: int = 1000,
        input_k: int = 10, error_bound: float = 0.10, nlist: int = 1024,
        max_topk: int = 100, reps: int = 5, device="cuda"):
    log = common.stderr_log()
    data = common.load_dataset(db, nq=ts + ses)
    idx = common.build_or_load_index(data, nlist=nlist, device=device)
    idx.enable_multirow()
    gt_D, gt_I = common.ensure_gt(data, idx, max_topk)
    es = ErrorSys(idx, train_num=ts + ses, max_topk=max_topk)
    es.set_gt(gt_D, gt_I)
    es.sys_train(ts, data.xq)
    es.set_topk(input_k)
    acc = np.full(ts + ses, 1.0 - error_bound, np.float32)
    es.set_queries(ses, data.xq, acc)
    es.set_hyper(8.0, 1.0)
    dev = idx.device

    # with ELP: the bounded engine end to end (its result comes back to
    # the host on every call)
    es.search(ts, ses)  # warm
    common.sync(dev)
    t1 = time.perf_counter()
    for _ in range(reps):
        es.search(ts, ses)
    common.sync(dev)
    with_elp = (time.perf_counter() - t1) / reps

    # without ELP: the same probe counts as a bare scan
    q = torch.as_tensor(data.xq[ts:ts + ses], device=dev)
    n_scanned = es.n_scanned[ts:ts + ses].astype(np.int32)
    probes = torch.as_tensor(n_scanned, device=dev)
    plan = es._mr_oneshot_plan()
    nprobe_search_mr(idx.arrays, idx.multirow, q, probes, max_topk,
                     data.metric, plan)  # warm
    common.sync(dev)
    t1 = time.perf_counter()
    for _ in range(reps):
        v, i, nb = nprobe_search_mr(idx.arrays, idx.multirow, q, probes,
                                    max_topk, data.metric, plan)
        v.cpu()   # one host copy per rep, as es.search makes
    common.sync(dev)
    without_elp = (time.perf_counter() - t1) / reps
    np.testing.assert_array_equal(nb.cpu().numpy(), n_scanned)

    ovh = (with_elp - without_elp) / max(without_elp, 1e-9)
    log(f"Without ELP search Time: {without_elp:.3f} s")
    log(f"With ELP search Time: {with_elp:.3f} s")
    log(f"ELP overhead: {ovh * 100:.1f}%")
    return dict(with_elp=with_elp, without_elp=without_elp, overhead=ovh)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db", nargs="?", default="synth100K")
    ap.add_argument("train_size", nargs="?", type=int, default=1000)
    ap.add_argument("query_size", nargs="?", type=int, default=1000)
    ap.add_argument("topk", nargs="?", type=int, default=10)
    ap.add_argument("error_bound", nargs="?", type=float, default=0.10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.db, args.train_size, args.query_size, args.topk,
        args.error_bound, device=args.device)


if __name__ == "__main__":
    main()
