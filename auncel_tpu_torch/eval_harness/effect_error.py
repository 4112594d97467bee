"""Bound-satisfaction experiment (port of
``auncel_tpu/eval_harness/effect_error.py``; reference
``eval/effect_error.cpp``): the test queries carry mixed per-query bounds
cycling through {0.9, 0.8, ..., 0.3}; profile mode records the recall each
achieved; the (required, achieved) pairs go to
``Effective_error_<db>.log`` (figure 13).

    python -m auncel_tpu_torch.eval_harness.effect_error synth100K 1000 1000 10
"""

import argparse

import numpy as np

from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.profile.error_sys import ErrorSys

MIXED_BOUNDS = [0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3]  # effect_error.cpp:281


def run(db: str = "synth100K", ts: int = 1000, ses: int = 1000,
        input_k: int = 10, figure_id: int | None = None,
        nlist: int = 1024, max_topk: int = 100, log_dir: str = ".",
        storage: str = "f32", calibrate: bool = False,
        profile_size: int | None = None, device="cuda"):
    log = common.stderr_log()
    data = common.load_dataset(db, nq=ts + ses)
    idx = common.build_or_load_index(data, nlist=nlist, storage=storage,
                                     device=device)
    idx.enable_multirow()
    gt_D, gt_I = common.ensure_gt(data, idx, max_topk)
    # calibrating: the profile trains on the first part of the train
    # slice (default half) and calibration runs on the disjoint rest
    psz = (min(profile_size or max(ts // 2, 1), ts) if calibrate else ts)
    es = ErrorSys(idx, train_num=ts + ses, max_topk=max_topk)
    es.set_gt(gt_D, gt_I)
    es.sys_train(psz, data.xq)
    es.set_topk(input_k)
    log(f"trained (profile on {psz} queries)")

    acc = np.asarray([MIXED_BOUNDS[i % len(MIXED_BOUNDS)]
                      for i in range(ts + ses)], np.float32)
    # the train slice carries the strictest bound: calibrate() searches
    # it against one target
    acc[:ts] = MIXED_BOUNDS[0]
    es.set_queries(ses, data.xq, acc)
    if figure_id is not None:
        es.setparam(figure_id)
    elif calibrate:
        # against the strictest mixed bound: looser bounds only stop
        # earlier; with no disjoint queries left, on profile-seen ones
        c0, csz = (psz, min(ts - psz, 2000)) if psz < ts \
            else (0, min(ts, 2000))
        m = es.calibrate(c0, csz, target_bound=MIXED_BOUNDS[0])
        log(f"auto-calibrated multipler={m:.2f} std_m={es.std_m:g}")
    else:
        es.set_hyper(8.0, 1.0)
    es.profile = True  # record achieved true recalls
    es.search(ts, ses)
    es.profile = False

    required = acc[ts:ts + ses]
    achieved = es.t_recalls[ts:ts + ses]
    sat = float(np.mean(achieved >= required - 1e-6))
    log(f"bound satisfaction rate: {sat:.4f}")
    fn = f"{log_dir}/Effective_error_{db}.log"
    common.write_log(fn, list(zip(required.tolist(), achieved.tolist())))
    log(f"wrote {fn}")
    return dict(satisfaction=sat, required=required, achieved=achieved)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db", nargs="?", default="synth100K")
    ap.add_argument("train_size", nargs="?", type=int, default=1000)
    ap.add_argument("query_size", nargs="?", type=int, default=1000)
    ap.add_argument("topk", nargs="?", type=int, default=10)
    ap.add_argument("figure_id", nargs="?", type=int, default=None)
    ap.add_argument("--storage", default="f32")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--profile-size", type=int, default=None,
                    help="train the profile on the first N train queries "
                         "and calibrate on the rest (default: ts // 2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.db, args.train_size, args.query_size, args.topk,
        args.figure_id, storage=args.storage, calibrate=args.calibrate,
        profile_size=args.profile_size, device=args.device)


if __name__ == "__main__":
    main()
