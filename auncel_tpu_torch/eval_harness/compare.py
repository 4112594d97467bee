"""Three-way comparison on one workload (port of
``auncel_tpu/eval_harness/compare.py``): Auncel's bounded search against
the ELP worst-case auto-tune baseline (one global nprobe, ``autotune.py``)
and LAET learned termination (``baselines/laet.py``), each at the same
worst-case bound, behind the reference's figures 10-12.

Rows: auncel; elp (the reference tuner, no margin); elp_margin (the tuner
with one neighbour of headroom, when it picks another nprobe); laet (the
multiplier tuned for mean recall, as published); laet_worst (tuned for the
worst query). Each row is timed warm over ``reps`` calls on the held-out
queries, the card synced before each timer reads. Writes
``Compare_<db>.log``: one "system qps mean_probes min_recall mean_recall"
row per system.

    python -m auncel_tpu_torch.eval_harness.compare synthHard1M 2000 1000 \\
        10 0.10 --profile-size 1000
"""

import argparse
import time

import numpy as np

from auncel_tpu_torch.autotune import ParameterSpace, recall_counts
from auncel_tpu_torch.baselines.laet import LearnedTermination
from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.profile.error_sys import ErrorSys


def run(db: str = "synth100K", ts: int = 1000, ses: int = 1000,
        input_k: int = 10, error_bound: float = 0.10, nlist: int = 1024,
        max_topk: int = 100, log_dir: str = ".", reps: int = 3,
        profile_size: int | None = None, storage: str = "f32",
        device="cuda"):
    log = common.stderr_log()
    data = common.load_dataset(db, nq=ts + ses)
    idx = common.build_or_load_index(data, nlist=nlist, storage=storage,
                                     device=device)
    idx.enable_multirow()
    gt_D, gt_I = common.ensure_gt(data, idx, max_topk)
    target = 1.0 - error_bound
    xq_test = data.xq[ts:ts + ses]
    gt_test = gt_D[ts:ts + ses]
    rows = []

    def measure(fn, name, probes_fn):
        fn()  # warm
        common.sync(idx.device)
        t1 = time.perf_counter()
        for _ in range(reps):
            D, I = fn()
        common.sync(idx.device)
        dt = (time.perf_counter() - t1) / reps
        cnt = recall_counts(D, gt_test, input_k, data.metric)
        row = dict(system=name, qps=ses / dt,
                   mean_probes=float(probes_fn()),
                   min_recall=float(cnt.min() / input_k),
                   mean_recall=float(cnt.mean() / input_k))
        log(f"{name}: {row['qps']:.0f} qps, {row['mean_probes']:.1f} "
            f"probes, min_recall {row['min_recall']:.3f}")
        rows.append(row)
        return row

    # --- Auncel: per-query error-bounded search. The profile trains on
    # the first half of the train slice and calibration runs on the
    # disjoint second half (profile-seen calibration under-estimates).
    psz = min(profile_size or max(ts // 2, 1), ts)
    es = ErrorSys(idx, train_num=ts + ses, max_topk=max_topk)
    es.set_gt(gt_D, gt_I)
    es.sys_train(psz, data.xq)
    es.set_topk(input_k)
    acc = np.full(ts + ses, target, np.float32)
    es.set_queries(ses, data.xq, acc)
    c0, csz = (psz, min(ts - psz, 2000)) if psz < ts else (0, min(ts, 2000))
    es.calibrate(c0, csz, target_bound=target)
    log(f"auncel calibrated: multipler={es.multipler:.2f} "
        f"std_m={es.std_m:g} (profile {psz}, calibrate [{c0}:{c0 + csz}])")
    measure(lambda: es.search(ts, ses), "auncel",
            lambda: es.n_scanned[ts:ts + ses].mean())

    # --- Baseline 1: ELP, one global nprobe tuned for the worst case on
    # the train slice, without and with one neighbour of headroom
    ps = ParameterSpace(idx)
    nprobe = ps.tune_for_bound(data.xq[:ts], gt_D[:ts], input_k,
                               error_bound)
    log(f"ELP tuned: nprobe={nprobe}")
    measure(lambda: idx.search(xq_test, input_k, nprobe=nprobe), "elp",
            lambda: nprobe)
    npm = ps.tune_for_bound(data.xq[:ts], gt_D[:ts], input_k,
                            error_bound, headroom=1.0 / input_k)
    if npm != nprobe:
        log(f"ELP+margin tuned: nprobe={npm}")
        measure(lambda: idx.search(xq_test, input_k, nprobe=npm),
                "elp_margin", lambda: npm)

    # --- Baseline 2: LAET. The MLP fits the first half of the train
    # slice; the multiplier is tuned on the second half.
    lt = LearnedTermination(idx, query_k=input_k, device=idx.device)
    half = max(ts // 2, 1)
    lt.train(data.xq[:half], gt_I[:half])
    lt.tune_multiplier(data.xq[half:ts], gt_D[half:ts], target)
    log(f"LAET tuned (mean criterion): multiplier={lt.multiplier:.2f}")
    probes_holder = {}

    def laet_run():
        D, I, nps = lt.search(xq_test, input_k)
        probes_holder["mean"] = float(np.mean(nps))
        return D, I

    measure(laet_run, "laet", lambda: probes_holder.get("mean", 0.0))
    lt.tune_multiplier(data.xq[half:ts], gt_D[half:ts], target,
                       criterion="worst")
    log(f"LAET tuned (worst-case criterion): "
        f"multiplier={lt.multiplier:.2f}")
    measure(laet_run, "laet_worst",
            lambda: probes_holder.get("mean", 0.0))

    fn = f"{log_dir}/Compare_{db}.log"
    with open(fn, "w") as f:
        for r in rows:
            f.write(f"{r['system']} {r['qps']:.1f} {r['mean_probes']:.2f} "
                    f"{r['min_recall']:.4f} {r['mean_recall']:.4f}\n")
    log(f"wrote {fn}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db", nargs="?", default="synth100K")
    ap.add_argument("train_size", nargs="?", type=int, default=1000)
    ap.add_argument("query_size", nargs="?", type=int, default=1000)
    ap.add_argument("topk", nargs="?", type=int, default=10)
    ap.add_argument("error_bound", nargs="?", type=float, default=0.10)
    ap.add_argument("--profile-size", type=int, default=None,
                    help="train the profile on the first N train queries "
                         "and calibrate on the rest (default: ts // 2)")
    ap.add_argument("--storage", default="f32",
                    help="corpus codec (e.g. sq8 at 10M)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.db, args.train_size, args.query_size, args.topk,
        args.error_bound, profile_size=args.profile_size,
        storage=args.storage, device=args.device)


if __name__ == "__main__":
    main()
