"""Overall bounded-search latency experiment (port of
``auncel_tpu/eval_harness/bound.py``; reference ``eval/bound.cpp``).

Build IVF<nlist>,Flat with the multi-row layout; train the error profile
on the first ``ts`` queries (or the first ``profile_size`` of them and
calibrate on the rest); serve the next ``ses`` queries with per-query
bounds; verify the worst-case bound; write the per-query batch-1 latencies
to ``Auncel_Latency_<db>_<k>_<eps>.log`` (the format the ``figures``
scripts read).

Throughput is one batched window, timed warm; batch-1 latency is one
synchronous single-query search per sampled query, wall clock. Every timer
reads after the card has finished.

    python -m auncel_tpu_torch.eval_harness.bound synthHard1M 2000 1000 \\
        10 0.10 --profile-size 1000
"""

import argparse
import time

import numpy as np

from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.profile.error_sys import ErrorSys

STREAM_WINDOW = 1024   # ErrorSys.search_stream's default window


def run(db: str = "synth100K", ts: int = 1000, ses: int = 1000,
        input_k: int = 10, error_bound: float = 0.10,
        figure_id: int | None = None, nlist: int = 1024,
        max_topk: int = 100, calibrate: bool = True,
        batch_latency: int = 100, log_dir: str = ".",
        storage: str = "f32", profile_size: int | None = None,
        dense_cut: float | None = 0.25, dense_decide: bool = False,
        dense_auto: bool = True, stream: bool = False,
        stream_window: int | None = None, device="cuda"):
    log = common.stderr_log()
    data = common.load_dataset(db, nq=ts + ses)
    assert data.xq.shape[0] >= ts + ses
    log(f"loaded {db}: nb={data.xb.shape[0]} d={data.xb.shape[1]}")
    idx = common.build_or_load_index(data, nlist=nlist, storage=storage,
                                     device=device)
    mr = idx.enable_multirow()
    log(f"index built (multirow {mr.rows.db.shape[0]} rows x "
        f"{mr.rows.db.shape[1]})")
    gt_D, gt_I = common.ensure_gt(data, idx, max_topk)
    log("ground truth ready")

    # profile_size < ts: the profile trains on the first profile_size
    # queries and calibration runs on the rest (disjoint slices)
    psz = min(profile_size or ts, ts)
    es = ErrorSys(idx, train_num=ts + ses, max_topk=max_topk)
    es.set_gt(gt_D, gt_I)
    es.sys_train(psz, data.xq)
    es.set_topk(input_k)
    log(f"error profile trained (on {psz} queries)")

    acc = np.full(ts + ses, 1.0 - error_bound, np.float32)
    es.set_queries(ses, data.xq, acc)
    es.dense_cut = dense_cut
    es.dense_decide = dense_decide
    es.dense_auto = dense_auto
    if figure_id is not None:
        es.setparam(figure_id)
    elif calibrate:
        # at least 1000 calibration queries at 1M and 2000 at 10M: smaller
        # samples missed the held-out worst case (calibrate() warns)
        c0, csz = (psz, min(ts - psz, 2000)) if psz < ts \
            else (0, min(ts, 2000))
        m = es.calibrate(c0, csz, target_bound=1.0 - error_bound)
        log(f"auto-calibrated multipler={m:.2f} std_m={es.std_m:g} "
            f"(on {csz} queries at [{c0}:{c0 + csz}])")
        log(f"dense auto-routing probe: cal_mean_scan="
            f"{es._cal_mean_scan:.1f} dense_min_bsz={es._dense_min_bsz} "
            f"(windows >= that size serve dense; None = gather always)")

    D, I = es.search(ts, ses)  # warm
    common.sync(idx.device)
    t1 = time.perf_counter()
    D, I = es.search(ts, ses)
    common.sync(idx.device)
    qps = ses / (time.perf_counter() - t1)

    stream_qps = None
    if stream:
        Ds, Is = es.search_stream(ts, ses, window=stream_window)  # warm
        common.sync(idx.device)
        t1 = time.perf_counter()
        Ds, Is = es.search_stream(ts, ses, window=stream_window)
        common.sync(idx.device)
        stream_qps = ses / (time.perf_counter() - t1)
        D, I = Ds, Is
        log(f"sustained-stream throughput: {stream_qps:.1f} qps "
            f"(window {stream_window or STREAM_WINDOW})")

    # batch_latency=0 skips the batch-1 phase
    nlat = min(batch_latency, ses)
    if nlat:
        es.search(ts, 1)  # warm
    lat = []
    for i in range(nlat):
        common.sync(idx.device)
        tt0 = time.perf_counter()
        es.search(ts + i, 1)
        common.sync(idx.device)
        lat.append(time.perf_counter() - tt0)
    lat = np.asarray(lat)

    ok, minf = common.check_bound(D, gt_D[ts:ts + ses], input_k,
                                  error_bound, data.metric)
    if ok:
        log("Error bound is guaranteed")
    else:
        log("WARNING: error bound NOT guaranteed — enlarge multipler")
    log(f"Error Bound : {minf:.4f}")
    lat_msg = (f"batch-1 latency mean={lat.mean() * 1e3:.2f} ms "
               f"p99={np.quantile(lat, .99) * 1e3:.2f} ms"
               if nlat else "batch-1 latency not measured")
    log(f"throughput: {qps:.1f} qps (batch {ses}); {lat_msg}; "
        f"mean scanned lists={es.n_scanned[ts:ts + ses].mean():.1f}")

    mean_lat = None
    if nlat:
        # the figures-facing log only when latency was measured
        fn = (f"{log_dir}/Auncel_Latency_{db}_{input_k}_"
              f"{round(error_bound * 100)}.log")
        common.write_log(fn, lat.tolist())
        log(f"wrote {fn}")
        mean_lat = float(lat.mean() * 1e3)
    return dict(qps=qps, stream_qps=stream_qps, min_recall=minf,
                bound_ok=ok, mean_latency_ms=mean_lat,
                multipler=float(es.multipler), std_m=float(es.std_m),
                mean_nscan=float(es.n_scanned[ts:ts + ses].mean()),
                multirow_rows=int(mr.rows.db.shape[0]))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db", nargs="?", default="synth100K")
    ap.add_argument("train_size", nargs="?", type=int, default=1000)
    ap.add_argument("query_size", nargs="?", type=int, default=1000)
    ap.add_argument("topk", nargs="?", type=int, default=10)
    ap.add_argument("error_bound", nargs="?", type=float, default=0.10)
    ap.add_argument("figure_id", nargs="?", type=int, default=None)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--storage", default="f32")
    ap.add_argument("--batch-latency", type=int, default=100)
    ap.add_argument("--profile-size", type=int, default=None,
                    help="train the profile on the first N train queries "
                         "and calibrate on the rest (disjoint slices)")
    ap.add_argument("--dense-cut", type=float, default=0.25,
                    help="per-query dense-routing threshold as a corpus "
                         "fraction (0.0 = every query dense; negative = "
                         "disable)")
    ap.add_argument("--dense-decide", action="store_true",
                    help="serve the decision ladder from shared corpus "
                         "passes too")
    ap.add_argument("--no-dense-auto", action="store_true",
                    help="disable the window-size dense routing")
    ap.add_argument("--stream", action="store_true",
                    help="also measure sustained-stream throughput (the "
                         "bound is checked on the stream's results)")
    ap.add_argument("--stream-window", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.db, args.train_size, args.query_size, args.topk,
        args.error_bound, args.figure_id, nlist=args.nlist,
        storage=args.storage, batch_latency=args.batch_latency,
        profile_size=args.profile_size,
        dense_cut=None if args.dense_cut < 0 else args.dense_cut,
        dense_decide=args.dense_decide,
        dense_auto=not args.no_dense_auto, stream=args.stream,
        stream_window=args.stream_window, device=args.device)


if __name__ == "__main__":
    main()
