"""The k x eps evaluation matrix at 10M (the PyTorch port of
``scripts/matrix10M.py``), on the card by default.

The reference runs k in {10, 50, 100} x eps in {10 %, 5 %, 1 %} per
dataset (eval/run.sh:3-17). One index, one profile (on the first 1000
queries); each cell binds topk, calibrates on the 2000 disjoint queries
that follow with calibrate's defaults, then serves the 1000 held-out
queries after them once warm and once timed and checks the bound. Writes
``Matrix_<db>.log`` into the output directory, one JSON row a cell
(k, eps, multipler, std_m, min_recall, bound_ok, mean_scan, qps),
appended as each cell ends.

    python scripts/torch_matrix10M.py [db] [storage] [--device cpu]
        [--out-dir DIR]

db and storage default to synthDeep10M and sq8, as the JAX script's do;
the working directory holds ``trained_index/``, and the corpus and
ground-truth caches go under ``$BENCH_CACHE``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np

from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.profile.error_sys import ErrorSys

KS = (10, 50, 100)
EPSS = (0.10, 0.05, 0.01)
N_PROF, N_CAL, N_EVAL = 1000, 2000, 1000


def run(es: ErrorSys, gt_D: np.ndarray, xq: np.ndarray, db: str,
        n_prof: int = N_PROF, n_cal: int = N_CAL, n_eval: int = N_EVAL,
        ks=KS, epss=EPSS, out_dir: str = ".") -> list:
    """The matrix on ``es`` (an ErrorSys whose profile is trained on the
    first ``n_prof`` queries of ``xq``, with ``max_topk`` at least
    max(ks)) and the ground truth ``gt_D`` of ``xq``'s first n_prof +
    n_cal + n_eval rows. Returns the rows."""
    log = common.stderr_log()
    nq = n_prof + n_cal + n_eval
    e0 = n_prof + n_cal
    acc = np.zeros(nq, np.float32)
    path = os.path.join(out_dir, f"Matrix_{db}.log")
    open(path, "w").close()   # a fresh log; the rows append below
    rows = []
    for k in ks:
        es.set_topk(k)
        for eps in epss:
            target = 1.0 - eps
            acc[:] = target
            es.set_queries(nq, xq, acc)
            es.calibrate(n_prof, n_cal, target_bound=target)
            es.search(e0, n_eval)   # warm
            t1 = time.perf_counter()
            D, _ = es.search(e0, n_eval)   # host arrays: the device is done
            dt = time.perf_counter() - t1
            ok, minf = common.check_bound(D, gt_D[e0:nq], k, eps,
                                          es.index.metric)
            row = dict(k=k, eps=eps,
                       multipler=round(float(es.multipler), 3),
                       std_m=float(es.std_m),
                       min_recall=round(minf, 4), bound_ok=bool(ok),
                       mean_scan=round(float(es.n_scanned[e0:nq].mean()),
                                       1),
                       qps=round(n_eval / dt, 1))
            log(json.dumps(row))
            rows.append(row)
            # appended as each cell ends: a run cut short keeps its cells
            with open(path, "a") as f:
                f.write(json.dumps(row) + "\n")
    held = sum(r["bound_ok"] for r in rows)
    log(f"wrote {path} ({held}/{len(rows)} cells hold)")
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("db", nargs="?", default="synthDeep10M")
    ap.add_argument("storage", nargs="?", default="sq8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=".")
    a = ap.parse_args(argv)
    nq = N_PROF + N_CAL + N_EVAL
    data = common.load_dataset(a.db, nq=nq)
    idx = common.build_or_load_index(data, nlist=1024, storage=a.storage,
                                     device=a.device)
    idx.enable_multirow()
    gt_D, gt_I = common.ensure_gt(data, idx, 100)
    es = ErrorSys(idx, train_num=nq, max_topk=100)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_PROF, data.xq)
    return run(es, gt_D, data.xq, a.db, out_dir=a.out_dir)


if __name__ == "__main__":
    main()
