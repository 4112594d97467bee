"""Latency-budget experiment (port of
``auncel_tpu/eval_harness/effect_time.py``; reference
``eval/effect_time.cpp``): the test queries carry mixed per-query budgets
(5..50 ms); time-budgeted search must come in under each; the (budget,
actual) pairs go to ``Effective_time_<db>.log`` (figure 14).

Two actuals:

  * measured: the batch-1 wall clock of a sample of the test queries, one
    query a call, the minimum of 5 calls each (the estimator
    ``calibrate_time`` uses), the card synced before each timer reads.
    The dispatch floor (the same loop with one probe's work) is taken
    off: ``measured_device`` = measured - floor.
  * model: the calibrated batch-1 cost table at each query's n_scanned,
    what the budget-to-probes conversion believed, held against the
    measured sample (median relative error, correlation) and refitted as
    one per-probe slope.

    python -m auncel_tpu_torch.eval_harness.effect_time synth100K 1000 1000 10
"""

import argparse
import time

import numpy as np

from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.profile.error_sys import ErrorSys

MIXED_BUDGETS_MS = [5.0, 10.0, 20.0, 30.0, 40.0, 50.0]  # effect_time.cpp:279


def _measure_batch1(es: ErrorSys, qids, reps: int = 5) -> np.ndarray:
    """ms per query: the minimum of ``reps`` batch-1 ``time_search`` calls
    (each returns host arrays, so it has waited for the card)."""
    dev = es.index.device
    out = np.zeros(len(qids), np.float64)
    es.time_search(int(qids[0]), 1)  # warm
    for j, qi in enumerate(qids):
        best = np.inf
        for _ in range(reps):
            common.sync(dev)
            t0 = time.perf_counter()
            es.time_search(int(qi), 1)
            common.sync(dev)
            best = min(best, time.perf_counter() - t0)
        out[j] = best * 1e3
    return out


def run(db: str = "synth100K", ts: int = 1000, ses: int = 1000,
        input_k: int = 10, nlist: int = 1024, max_topk: int = 100,
        log_dir: str = ".", n_measure: int = 48, storage: str = "f32",
        device="cuda"):
    log = common.stderr_log()
    data = common.load_dataset(db, nq=ts + ses)
    idx = common.build_or_load_index(data, nlist=nlist, storage=storage,
                                     device=device)
    idx.enable_multirow()
    gt_D, gt_I = common.ensure_gt(data, idx, max_topk)
    es = ErrorSys(idx, train_num=ts + ses, max_topk=max_topk)
    es.set_gt(gt_D, gt_I)
    es.sys_train(ts, data.xq)
    es.set_topk(input_k)

    budgets = np.asarray([MIXED_BUDGETS_MS[i % len(MIXED_BUDGETS_MS)]
                          for i in range(ts + ses)], np.float32)
    es.set_queries(ses, data.xq, budgets)
    per_probe = es.calibrate_time()
    tbl = es._time_cost_table
    log(f"calibrated cost table: cost(1)={tbl[0]:.2f} ms, "
        f"cost(nlist)={tbl[-1]:.2f} ms; tail slope {per_probe * 1e3:.1f} "
        f"us/probe")

    # the batched pass: budget -> probe count -> results and model cost
    es.time_search(ts, ses)
    model_ms = es.time_cost_ms(es.n_scanned[ts:ts + ses])
    within_model = float(np.mean(model_ms <= budgets[ts:ts + ses]))
    log(f"within-budget rate (cost model): {within_model:.4f}")

    # the measured batch-1 sample, spread over the budget classes
    n_measure = min(n_measure, ses)
    qids = ts + (np.arange(n_measure) * (ses // max(n_measure, 1)))
    measured = _measure_batch1(es, qids)
    # before the floor run below overwrites these slots
    probes_sample = es.n_scanned[qids].astype(np.float64).copy()
    model_sample = es.time_cost_ms(probes_sample)
    # the dispatch floor: the same loop with a budget below one probe's
    # cost, which clamps to 1 probe
    saved = es.require_acc
    es.require_acc = es.require_acc.copy()
    es.require_acc[qids] = 1e-6
    floor = float(np.median(_measure_batch1(es, qids[:8])))
    es.require_acc = saved
    measured_dev = np.maximum(measured - floor, 0.0)
    b = budgets[qids]
    within_measured = float(np.mean(measured_dev <= b))
    denom = np.maximum(measured_dev, 1e-3)
    rel_err = float(np.median(np.abs(model_sample - measured_dev) / denom))
    corr = float(np.corrcoef(model_sample, measured_dev)[0, 1]) \
        if np.std(model_sample) > 0 and np.std(measured_dev) > 0 else 1.0
    log(f"measured batch-1 sample n={n_measure}: dispatch floor "
        f"{floor:.2f} ms, within-budget (less the floor) "
        f"{within_measured:.3f}")
    log(f"cost model vs measured: median rel err {rel_err:.2f}, "
        f"corr {corr:.2f}")
    # the per-probe slope refitted on the measurement (least squares
    # through the origin)
    probes = probes_sample
    denom2 = float((probes * probes).sum())
    slope = float((probes * measured_dev).sum() / denom2) if denom2 else 0.0
    refit = probes * slope
    refit_err = float(np.median(
        np.abs(refit - measured_dev) / np.maximum(measured_dev, 1e-3)))
    log(f"refit per-probe cost {slope * 1e3:.1f} us -> median rel err "
        f"{refit_err:.2f}")

    fn = f"{log_dir}/Effective_time_{db}.log"
    common.write_log(fn, list(zip(b.tolist(), measured_dev.tolist())))
    log(f"wrote {fn} (measured ms less the dispatch floor)")
    return dict(within_budget=within_model,
                within_budget_measured=within_measured,
                budgets=budgets[ts:ts + ses], model_ms=model_ms,
                measured_ms=measured, measured_device_ms=measured_dev,
                dispatch_floor_ms=floor, model_rel_err=rel_err,
                model_corr=corr, refit_per_probe_ms=slope,
                refit_rel_err=refit_err, sample_qids=qids)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db", nargs="?", default="synth100K")
    ap.add_argument("train_size", nargs="?", type=int, default=1000)
    ap.add_argument("query_size", nargs="?", type=int, default=1000)
    ap.add_argument("topk", nargs="?", type=int, default=10)
    ap.add_argument("--storage", default="f32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.db, args.train_size, args.query_size, args.topk,
        storage=args.storage, device=args.device)


if __name__ == "__main__":
    main()
