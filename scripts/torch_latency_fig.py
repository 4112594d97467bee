"""Batch-1 latency of Auncel against the worst-case-tuned ELP baseline on
the same queries (the PyTorch port of ``scripts/latency_fig.py``), on the
card by default.

Auncel's bounded search at the calibrated configuration and ELP's one
global nprobe (tuned on the train slice with one neighbour of headroom,
1/k) each serve the same ``n_lat`` held-out queries one at a time; then
each serves the whole held-out window once for the bound check. Writes
the reference-format logs (one latency in seconds a line)

    Auncel_Latency_<db>_<k>_<eps%>.log
    ELP_Latency_<db>_<k>_<eps%>.log

and, where matplotlib is installed, the latency CDF and the per-query
slowdown CDF (ELP / Auncel, the reference's figure10-1.py) as
``figures_out/latency_cdf_<tag>.png`` and ``figures_out/slowdown_<tag>.png``
under the output directory.

    python scripts/torch_latency_fig.py synthDeep10M 3000 1000 10 0.10 \\
        sq8 200 1000

The arguments are the JAX script's: db, train size, held-out size, k,
eps, storage, the number of batch-1 queries and the profile size (0: half
the train slice); ``--device cpu`` runs on the CPU and ``--out-dir`` names
the directory of the logs and figures (default: the working directory,
which also holds ``trained_index/``; the corpus and ground-truth caches go
under ``$BENCH_CACHE``). Protocol: the profile trains on the first
``profile_size`` train queries and calibration runs on the rest (at most
2000), as ``auncel_tpu_torch.eval_harness.compare`` does.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np

from auncel_tpu_torch.autotune import ParameterSpace
from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.profile.error_sys import ErrorSys


def profile_queries(ts: int, profile_size: int) -> int:
    """The profile's share of the train slice (0: half of it)."""
    return int(profile_size) or max(int(ts) // 2, 1)


def batch1_latencies(fn, qids) -> np.ndarray:
    """Seconds of fn(q) for each q, after one warm call; fn returns host
    arrays, so each time includes the device's work."""
    fn(int(qids[0]))
    lat = []
    for q in qids:
        t1 = time.perf_counter()
        fn(int(q))
        lat.append(time.perf_counter() - t1)
    return np.asarray(lat)


def run(es: ErrorSys, gt_D: np.ndarray, xq: np.ndarray, db: str,
        ts: int = 1000, ses: int = 1000, k: int = 10, eps: float = 0.10,
        n_lat: int = 200, profile_size: int = 0, out_dir: str = ".",
        elp_nprobe: int | None = None) -> dict:
    """The comparison on ``es`` (an ErrorSys on its index whose profile is
    trained on the first ``profile_size`` queries of ``xq``) and the
    ground truth ``gt_D`` of ``xq``'s first ``ts + ses`` rows: set_topk,
    calibrate, the two batch-1 ladders and windows, the logs and figures.
    ``elp_nprobe`` skips ELP's sweep with an nprobe already tuned the same
    way (headroom 1/k on the same train slice and ground truth). Returns
    the latencies, both bound checks and ELP's nprobe."""
    log = common.stderr_log()
    idx = es.index
    psz = profile_queries(ts, profile_size)
    es.set_topk(k)
    es.set_queries(ses, xq, np.full(ts + ses, 1.0 - eps, np.float32))
    es.calibrate(psz, min(ts - psz, 2000), target_bound=1.0 - eps)
    log(f"calibrated multipler={es.multipler:.2f} std_m={es.std_m:g}")

    n_lat = min(n_lat, ses)
    qids = ts + np.arange(n_lat)
    a_lat = batch1_latencies(lambda q: es.search(q, 1), qids)
    D, _ = es.search(ts, ses)
    ok, minf = common.check_bound(D, gt_D[ts:ts + ses], k, eps, idx.metric)
    log(f"auncel: mean {a_lat.mean() * 1e3:.2f} ms, bound_ok={ok} "
        f"({minf:.3f})")

    if elp_nprobe is None:
        elp_nprobe = ParameterSpace(idx).tune_for_bound(
            xq[:ts], gt_D[:ts], k, eps, headroom=1.0 / k)
    nprobe = int(elp_nprobe)
    log(f"ELP tuned nprobe={nprobe}")
    e_lat = batch1_latencies(
        lambda q: idx.search(xq[q:q + 1], k, nprobe=nprobe), qids)
    De, _ = idx.search(xq[ts:ts + ses], k, nprobe=nprobe)
    ok_e, minf_e = common.check_bound(De, gt_D[ts:ts + ses], k, eps,
                                      idx.metric)
    log(f"elp: mean {e_lat.mean() * 1e3:.2f} ms, bound_ok={ok_e} "
        f"({minf_e:.3f})")

    tag = f"{db}_{k}_{round(eps * 100)}"
    logs = {name: os.path.join(out_dir, f"{name}_Latency_{tag}.log")
            for name in ("Auncel", "ELP")}
    common.write_log(logs["Auncel"], a_lat.tolist())
    common.write_log(logs["ELP"], e_lat.tolist())
    # the figure's own mean slowdown (figures/plots.py::latency_slowdown)
    slowdown = float(e_lat.mean() / a_lat.mean())
    figures = []
    try:
        from auncel_tpu_torch.figures import plots
    except ImportError as e:   # matplotlib is optional
        log(f"figures skipped: {e}")
    else:
        fig_dir = os.path.join(out_dir, "figures_out")
        os.makedirs(fig_dir, exist_ok=True)
        figures = [os.path.join(fig_dir, f"latency_cdf_{tag}.png"),
                   os.path.join(fig_dir, f"slowdown_{tag}.png")]
        plots.latency_cdf({"Auncel": logs["Auncel"],
                           f"ELP nprobe={nprobe}": logs["ELP"]},
                          figures[0], title=f"{db} k={k} eps={eps:g}")
        plots.latency_slowdown(logs["ELP"], logs["Auncel"], figures[1],
                               label="ELP / Auncel")
    log(f"mean slowdown ELP/Auncel = {slowdown:.2f}; wrote {logs}"
        + (f" and {figures}" if figures else ""))
    return dict(auncel_lat=a_lat, elp_lat=e_lat, bound_ok=bool(ok),
                min_recall=float(minf), elp_nprobe=nprobe,
                elp_bound_ok=bool(ok_e), elp_min_recall=float(minf_e),
                multipler=float(es.multipler), std_m=float(es.std_m),
                slowdown=slowdown, logs=logs, figures=figures)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("db", nargs="?", default="synth1M")
    ap.add_argument("ts", nargs="?", type=int, default=1000)
    ap.add_argument("ses", nargs="?", type=int, default=1000)
    ap.add_argument("k", nargs="?", type=int, default=10)
    ap.add_argument("eps", nargs="?", type=float, default=0.10)
    ap.add_argument("storage", nargs="?", default="f32")
    ap.add_argument("n_lat", nargs="?", type=int, default=200)
    ap.add_argument("profile_size", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=".")
    a = ap.parse_args(argv)
    data = common.load_dataset(a.db, nq=a.ts + a.ses)
    idx = common.build_or_load_index(data, nlist=1024, storage=a.storage,
                                     device=a.device)
    idx.enable_multirow()
    gt_D, gt_I = common.ensure_gt(data, idx, 100)
    es = ErrorSys(idx, train_num=a.ts + a.ses, max_topk=100)
    es.set_gt(gt_D, gt_I)
    es.sys_train(profile_queries(a.ts, a.profile_size), data.xq)
    return run(es, gt_D, data.xq, a.db, a.ts, a.ses, a.k, a.eps, a.n_lat,
               a.profile_size, a.out_dir)


if __name__ == "__main__":
    main()
