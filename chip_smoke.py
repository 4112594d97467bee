"""Smoke run of the PyTorch/CUDA port (auncel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases: the card; the kernels' build (one nvcc per source, in parallel);
each kernel against its plain PyTorch version on synthetic inputs; the
bounded-search main path on the multi-row layout (K1 in search, K2 in
profile training); the padded path on the same index without the multi-row
layout (K2 throughout, with the two-phase window held to single phase on a
strict window whose stragglers take phase B); each kernel against its plain version on the
index's own arrays. Every path is driven through the port's public entry
points on their default device, with the kernels' launch counts set to 0
just before it and read just after. Exits non-zero when there is no CUDA
device or any phase fails. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it lists each kernel.

    python3 chip_smoke.py [--profile DIR]

``--profile DIR`` also writes torch.profiler tables of one batched and one
batch-1 search on each path.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def log(msg):
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A failed check fails the run (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, reps: int) -> tuple:
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    t_ref = cuda_time_ms(plain, max(reps // 2, 1))
    t_k = cuda_time_ms(kernel, reps)
    t_k = min(t_k, cuda_time_ms(kernel, reps))
    t_ref = min(t_ref, cuda_time_ms(plain, max(reps // 2, 1)))
    return t_k, t_ref


# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound(n_bytes: float, n_flops: float) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(db, rows, qs) -> tuple:
    """Each distinct row read once, work_rows and qs read, dots written."""
    T = rows.shape[0]
    _, row_cap, d = db.shape
    n_rows = int(torch.unique(rows).numel())
    n_bytes = n_rows * row_cap * d * 4 + T * 4 + T * d * 4 + T * row_cap * 4
    return bound(n_bytes, 2.0 * T * row_cap * d)


def k2_work(db, db_sq, vec_ids, list_sizes, q, q_sq, lists) -> dict:
    """What K2's inputs need: the live slots of each distinct probed list
    read once (vector, norm, id) with the list sizes, probes and queries;
    scores and ids written for every slot. Also the live bytes the kernel
    reads, once per (query, probe slot)."""
    nlist, cap, d = db.shape
    B, S = lists.shape
    active = lists[lists >= 0].long().clamp_max(nlist - 1)
    sizes = list_sizes.long().clamp(0, cap)
    distinct = torch.unique(active)
    live_distinct = int(sizes[distinct].sum())
    live_probed = int(sizes[active].sum())
    slot_bytes = d * 4 + 4 + 4
    out_bytes = B * S * cap * 8
    n_bytes = (live_distinct * slot_bytes + distinct.numel() * 4
               + B * S * 4 + B * d * 4 + B * 4 + out_bytes)
    ms, by = bound(n_bytes, 2.0 * d * live_probed)
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": n_bytes,
            "live_bytes": live_probed * slot_bytes + out_bytes}


# (name, n_rows, row_cap, d, T): the multirow scan's shape at the
# benchmark configuration, a ragged worklist, and the scalar-load path
K1_SHAPES = (("bench", 4608, 256, 128, 4096),
             ("ragged", 4608, 256, 128, 4093),
             ("scalar", 64, 200, 100, 77))
# (name, nlist, cap, d, B, n_slots): a padded layout with the benchmark's d,
# and the scalar-load path
K2_SHAPES = (("synthetic", 512, 1024, 128, 256, 5),
             ("scalar", 64, 300, 100, 33, 3))


def k1_check(device, card: str) -> dict:
    """Compare K1 with its plain version and time both."""
    from auncel_tpu_torch.kernels.rowscan import (
        rowscan_dots, rowscan_dots_ref)

    gen = torch.Generator(device=device).manual_seed(0)
    result = {}
    for name, n_rows, row_cap, d, T in K1_SHAPES:
        # entries ~ N(0, 1/d): dots are O(1), so the fp32 error of summing
        # d products in another order (~1e-7) sits well inside 1e-5
        scale = d ** -0.5
        db = torch.randn((n_rows, row_cap, d), generator=gen,
                         device=device) * scale
        rows = torch.randint(0, n_rows, (T,), generator=gen, device=device,
                             dtype=torch.int32)
        qs = torch.randn((T, d), generator=gen, device=device) * scale
        got = rowscan_dots(db, rows, qs)
        want = rowscan_dots_ref(db, rows, qs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = float((got - want).abs().max())
        gb = T * row_cap * d * 4 / 1e9
        t_k, t_ref = time_pair(lambda: rowscan_dots(db, rows, qs),
                               lambda: rowscan_dots_ref(db, rows, qs), 20)
        log(f"[k1] {name}: T={T} row_cap={row_cap} d={d} max_abs_err="
            f"{err:.3g} kernel {t_k:.4f} ms ({gb / t_k * 1e3:.1f} GB/s) "
            f"plain {t_ref:.4f} ms ({gb / t_ref * 1e3:.1f} GB/s) [{card}]")
        if name == "bench":
            b_ms, b_by = k1_bound(db, rows, qs)
            log(f"[k1] {name}: bound {b_ms:.4f} ms ({b_by}; distinct rows "
                f"read once), {100 * b_ms / t_k:.1f} % of it [{card}]")
            result = {"max_abs_err": err, "ms": t_k, "plain_ms": t_ref,
                      "bound_ms": b_ms, "bound_by": b_by}
        del db, rows, qs, got, want
    torch.cuda.empty_cache()
    return result


def k2_compare(name, args, metric, card: str, reps: int = 20,
               terms_tol: bool = False) -> dict:
    """K2 against its plain version on one input set; returns its numbers.
    With ``terms_tol`` the L2 tolerance is 1e-5 of the score's terms
    (q_sq + db_sq) rather than of the score: on data of SIFT's scale a
    near neighbour's score is the difference of terms ~60x larger than it,
    and the two versions' dots differ in sum order."""
    from auncel_tpu_torch.kernels.scan_scores import (
        scan_scores, scan_scores_ref)
    got_s, got_i = scan_scores(*args, metric)
    want_s, want_i = scan_scores_ref(*args, metric)
    torch.cuda.synchronize()
    check(torch.equal(got_i, want_i), f"K2 {name}: ids differ")
    check(torch.equal(torch.isfinite(got_s), torch.isfinite(want_s)),
          f"K2 {name}: dead slots differ")
    fin = torch.isfinite(want_s)
    diff = (got_s - want_s).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / want_s.abs()[fin].clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0
    if terms_tol:
        db, db_sq, _, _, q, q_sq, lists = args
        B, S = lists.shape
        sel = lists.long().clamp(0, db.shape[0] - 1)
        terms = (q_sq[:, None, None] + db_sq[sel]).reshape(B, -1)
        ok = bool(((got_s - want_s).abs()[fin]
                   <= 1e-5 * terms[fin] + 1e-5).all())
        check(ok, f"K2 {name}: scores beyond 1e-5 of their terms")
        tol = "1e-5 of q_sq + db_sq"
        # how far each fp32 version is from the same function in float64,
        # on the first queries: the difference above is their two errors
        n = min(32, B)
        dots = torch.einsum("bscd,bd->bsc", db[sel[:n]].double(),
                            q[:n].double())
        exact = (q_sq[:n, None, None].double() + db_sq[sel[:n]].double()
                 - 2.0 * dots).clamp_min(0.0).reshape(n, -1)
        f = fin[:n]
        e_k = float((got_s[:n] - exact)[f].abs().max())
        e_p = float((want_s[:n] - exact)[f].abs().max())
        log(f"[k2] {name}: against float64 on {n} queries: kernel max abs "
            f"err {e_k:.3g}, plain {e_p:.3g}; largest score "
            f"{float(exact[f].max()):.4g}")
        del dots, exact
    else:
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
        tol = "rtol = atol = 1e-5"
    del got_s, got_i, want_s, want_i
    t_k, t_ref = time_pair(lambda: scan_scores(*args, metric),
                           lambda: scan_scores_ref(*args, metric), reps)
    work = k2_work(*args)
    B, S = args[6].shape
    log(f"[k2] {name}: B={B} n_slots={S} cap={args[0].shape[1]} "
        f"d={args[0].shape[2]} {metric.name} max_abs_err={err:.3g} max rel "
        f"err={rel:.3g} ({tol}) kernel {t_k:.4f} ms "
        f"({work['live_bytes'] / t_k / 1e6:.1f} GB/s of live bytes) plain "
        f"{t_ref:.4f} ms; bound {work['bound_ms']:.4f} ms "
        f"({work['bound_by']}, {work['bound_bytes'] / 1e9:.3f} GB), "
        f"{100 * work['bound_ms'] / t_k:.1f} % of it [{card}]")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_ref,
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}


def synthetic_padded(device, nlist, cap, d, B, n_slots, seed):
    """A padded layout as _pack lays it out (ragged live prefix, id -1 and
    zero vectors after it, one dead id inside a list), with probes that hold
    inactive slots (-1) and out-of-range list ids; entries ~ N(0, 1/d), so
    scores are O(1) and the fp32 error of another sum order (~1e-7) sits
    well inside 1e-5."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = d ** -0.5
    sizes = torch.randint(0, cap + 1, (nlist,), generator=gen,
                          device=device, dtype=torch.int32)
    live = torch.arange(cap, device=device)[None, :] < sizes[:, None]
    ids = torch.where(live, torch.arange(nlist * cap, device=device,
                                         dtype=torch.int32).reshape(nlist,
                                                                    cap), -1)
    ids[0, 0] = -1
    db = torch.where(live[:, :, None],
                     torch.randn((nlist, cap, d), generator=gen,
                                 device=device) * s, 0.0)
    q = torch.randn((B, d), generator=gen, device=device) * s
    lists = torch.randint(0, nlist, (B, n_slots), generator=gen,
                          device=device, dtype=torch.int32)
    drop = torch.rand((B, n_slots), generator=gen, device=device) < 0.2
    lists = torch.where(drop, -1, lists)
    lists[0, 0] = nlist + 3
    return (db, (db * db).sum(-1), ids.to(torch.int32), sizes, q,
            (q * q).sum(-1), lists)


def k2_check(device, card: str) -> None:
    """K2 against its plain version on synthetic padded layouts: both
    metrics, n_slots not a multiple of 8, and the scalar-load path."""
    from auncel_tpu_torch import Metric
    for name, *shape in K2_SHAPES:
        args = synthetic_padded(device, *shape, seed=2)
        for metric in (Metric.L2, Metric.IP):
            k2_compare(f"{name} {metric.name}", args, metric, card)
        del args
    torch.cuda.empty_cache()


# The benchmark configuration (bench.py): a synthetic SIFT-like corpus,
# IVF1024,Flat, recall@10 >= 0.9 per query, 1000 queries to train and
# calibrate the profile and 1000 held-out queries to serve.
NB, D, NLIST = 1_000_000, 128, 1024
N_TRAIN_Q, N_TEST_Q, K, MAX_TOPK, EPS = 1000, 1000, 10, 100, 0.10
N_LATENCY = 1000  # all held-out queries: p99 has 10 samples beyond it
N_LATENCY_PADDED = 300
SEARCH_REPS = 5
STD_M_GRID = (0.2, 1.0, 4.0, 8.0, 12.0)  # ErrorSys.calibrate's default


def synced(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def launch_counts() -> dict:
    from auncel_tpu_torch.kernels.rowscan import rowscan_dots
    from auncel_tpu_torch.kernels.scan_scores import scan_scores
    return {"rowscan_dots": rowscan_dots.launches,
            "scan_scores": scan_scores.launches}


def reset_counts() -> None:
    from auncel_tpu_torch.kernels.rowscan import rowscan_dots
    from auncel_tpu_torch.kernels.scan_scores import scan_scores
    rowscan_dots.launches = 0
    scan_scores.launches = 0


def counted(fn):
    """(fn(), launches of each kernel while it ran)."""
    before = launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def serve_window(es, gt_D, card: str, label: str) -> dict:
    """The 1000 held-out queries as one window, escalating the multipler
    if the bound is missed, then the median of warm repeats."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts

    def serve():
        ((D_out, I_out), dt), n = counted(
            lambda: synced(lambda: es.search(N_TRAIN_Q, N_TEST_Q)))
        cnt = recall_counts(D_out, gt_D[N_TRAIN_Q:], K, Metric.L2)
        return D_out, I_out, dt, cnt, n

    D_out, I_out, dt, cnt, n = serve()
    while cnt.min() < K * (1.0 - EPS) and es.multipler < 64.0:
        es.multipler = min(es.multipler * 1.5, 64.0)
        log(f"[{label}] bound violated at min_recall={cnt.min() / K:.3f}; "
            f"escalating multipler to {es.multipler:.2f}")
        D_out, I_out, dt, cnt, n = serve()
    reps = [serve()[2] for _ in range(SEARCH_REPS)]
    dt = float(np.median(reps))
    log(f"[{label}] window times over {SEARCH_REPS} warm repeats: "
        + " ".join(f"{r * 1e3:.2f}" for r in reps) + " ms (median "
        f"{dt * 1e3:.2f} ms)")
    check(D_out.shape == (N_TEST_Q, K) and I_out.shape == (N_TEST_Q, K),
          f"{label}: result shapes {D_out.shape} {I_out.shape}")
    check(np.isfinite(D_out).all() and (I_out >= 0).all(),
          f"{label}: non-finite distances or missing ids")
    min_recall = cnt.min() / K
    check(min_recall >= 1.0 - EPS, f"{label}: worst-case recall {min_recall}")
    nscan = es.n_scanned[N_TRAIN_Q:N_TRAIN_Q + N_TEST_Q]
    log(f"[{label}] {N_TEST_Q} held-out queries: worst recall@{K}="
        f"{min_recall:.3f} mean={cnt.mean() / K:.4f} mean n_scanned="
        f"{nscan.mean():.2f} max={nscan.max()} multipler="
        f"{es.multipler:.3f} std_m={es.std_m} qps={N_TEST_Q / dt:.1f} "
        f"({dt * 1e3:.1f} ms) launches={n} [{card}]")
    return {"seconds": dt, "launches": n}


def serve_batch1(es, n_queries: int, card: str, label: str) -> dict:
    """Each of the first ``n_queries`` held-out queries alone."""
    lat = []
    total = {}
    for i in range(n_queries):
        ((Dq, _), t), n = counted(
            lambda: synced(lambda: es.search(N_TRAIN_Q + i, 1)))
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        check(Dq.shape == (1, K) and np.isfinite(Dq).all(),
              f"{label}: batch-1 result of query {N_TRAIN_Q + i}")
        lat.append(t * 1e3)
    lat = np.asarray(lat)
    log(f"[{label}] batch-1 over {n_queries} held-out queries: p50="
        f"{np.percentile(lat, 50):.2f} ms p90={np.percentile(lat, 90):.2f} "
        f"ms p99={np.percentile(lat, 99):.2f} ms max={lat.max():.2f} ms "
        f"mean={lat.mean():.2f} ms mean n_scanned="
        f"{es.n_scanned[N_TRAIN_Q:N_TRAIN_Q + n_queries].mean():.2f} "
        f"launches={total} [{card}]")
    return total


def build_corpus(card: str) -> dict:
    """The benchmark configuration's data, index (on the entry points'
    default device, the card) and value-consistent ground truth."""
    from auncel_tpu_torch import IVFFlatIndex
    from auncel_tpu_torch.data import make_clustered_dataset

    t0 = time.perf_counter()
    ds = make_clustered_dataset(nb=NB, nq=N_TRAIN_Q + N_TEST_Q, d=D,
                                n_clusters=1024, cluster_std=0.22,
                                query_mode="perturb", seed=42)
    xb, xq = ds.xb, ds.xq
    log(f"[data] {NB}x{D} corpus, {xq.shape[0]} queries in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    times = {}
    idx = IVFFlatIndex(D, NLIST)
    check(idx.device.type == "cuda", f"default device {idx.device}")
    _, times["train"] = synced(lambda: idx.train(xb[:400_000]))
    _, times["add+pack"] = synced(lambda: (idx.add(xb), idx.arrays))
    mr, times["multirow"] = synced(lambda: idx.enable_multirow())
    a = idx.arrays
    log(f"[index] cap={a.cap} packing={idx.packing_efficiency:.3f} rows="
        f"{mr.rows.db.shape[0]}x{mr.rows.db.shape[1]} device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    (gt_D, gt_I), times["exact_search"] = synced(
        lambda: idx.exact_search(xq, MAX_TOPK, batch=N_TRAIN_Q))
    return dict(idx=idx, xq=xq, gt_D=gt_D, gt_I=gt_I, times=times)


def multirow_path(c: dict, card: str, profile_dir: str | None) -> dict:
    """Profile-train, calibrate and serve on the multi-row layout. Returns
    each kernel's launches over the path."""
    from auncel_tpu_torch import ErrorSys

    idx, xq, gt_D, times = c["idx"], c["xq"], c["gt_D"], c["times"]
    reset_counts()
    es = ErrorSys(idx, train_num=N_TRAIN_Q + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, c["gt_I"])
    (_, times["sys_train"]), train = counted(
        lambda: synced(lambda: es.sys_train(N_TRAIN_Q, xq)))
    es.set_topk(K)
    acc = np.full(N_TRAIN_Q + N_TEST_Q, 1.0 - EPS, np.float32)
    es.set_queries(N_TEST_Q, xq, acc)
    log(f"[calibrate] std_m grid {STD_M_GRID}")
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(0, N_TRAIN_Q, target_bound=1.0 - EPS,
                             std_m_grid=STD_M_GRID))
    log(f"[calibrate] multipler={mult:.3f} std_m={es.std_m}")
    window = serve_window(es, gt_D, card, "search")
    times["search"] = window["seconds"]
    lat = serve_batch1(es, N_LATENCY, card, "latency")
    launches = launch_counts()
    log("[stages] " + " ".join(f"{k}={v:.2f}s" for k, v in times.items())
        + f" [{card}]")
    log(f"[multirow] launches over the path: {launches}, profile training "
        f"{train}")
    check(train["scan_scores"] > 0, "profile training never launched K2")
    check(window["launches"]["rowscan_dots"] > 0
          and lat.get("rowscan_dots", 0) > 0, "search never launched K1")
    if profile_dir:
        profile_search(es, profile_dir, card, "multirow")
    return launches


def padded_path(c: dict, card: str, profile_dir: str | None) -> dict:
    """The same corpus served by the padded engines: an index on the same
    centroids and padded arrays (shared device tensors) without the
    multi-row layout, its own profile training and calibration, one
    two-phase window, batch-1 windows and a strict window whose stragglers
    take phase B."""
    from auncel_tpu_torch import ErrorSys, IVFFlatIndex

    idx, xq, gt_D = c["idx"], c["xq"], c["gt_D"]
    pidx = IVFFlatIndex.from_state(idx.centroids, idx.arrays)
    check(pidx.multirow is None and pidx.arrays.db is idx.arrays.db,
          "padded index shares the arrays, without multi-row")
    times = {}
    reset_counts()
    es = ErrorSys(pidx, train_num=N_TRAIN_Q + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, c["gt_I"])
    (_, times["sys_train"]), train = counted(
        lambda: synced(lambda: es.sys_train(N_TRAIN_Q, xq)))
    es.set_topk(K)
    es.set_queries(N_TEST_Q, xq,
                   np.full(N_TRAIN_Q + N_TEST_Q, 1.0 - EPS, np.float32))
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(0, N_TRAIN_Q, target_bound=1.0 - EPS))
    log(f"[padded] calibrate: multipler={mult:.3f} std_m={es.std_m} "
        f"(default std_m grid)")
    window = serve_window(es, gt_D, card, "padded")
    times["search"] = window["seconds"]
    lat = serve_batch1(es, N_LATENCY_PADDED, card, "padded latency")
    phase_b(es, gt_D, card)
    launches = launch_counts()
    log("[padded stages] " + " ".join(f"{k}={v:.2f}s"
                                      for k, v in times.items())
        + f" [{card}]")
    log(f"[padded] launches over the path: {launches}, profile training "
        f"{train}")
    check(train["scan_scores"] > 0, "padded profile training never "
          "launched K2")
    check(window["launches"]["scan_scores"] > 0,
          "the two-phase window never launched K2")
    check(lat.get("scan_scores", 0) > 0, "batch-1 never launched K2")
    check(launches["rowscan_dots"] == 0, "the padded path launched K1")
    if profile_dir:
        profile_search(es, profile_dir, card, "padded")
    return launches


def phase_b(es, gt_D, card: str) -> dict:
    """The two-phase path with stragglers, against single-phase
    ``bounded_search`` on the same window. Every held-out query's bound is
    raised to recall@10 = 1.0, so that queries still undecided near nlist/8
    (and, if there are none, late deciders at a doubled multipler) take
    ``finish_scan``. Both engines must give the same ids, distances and
    n_scanned; each is timed, median of warm repeats taken in turns."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.profile.bounded import bounded_search

    idx = es.index
    nlist, dev = idx.nlist, idx.device
    saved = (es.require_acc, es.multipler)
    win = slice(N_TRAIN_Q, N_TRAIN_Q + N_TEST_Q)
    acc = np.full(N_TRAIN_Q + N_TEST_Q, 1.0, np.float32)
    es.set_queries(es.num, es.queries, acc)

    def two():
        return es.search(N_TRAIN_Q, N_TEST_Q)

    while True:
        (D2, I2), n2 = counted(two)
        ns2 = es.n_scanned[win].copy()
        stragglers = int((ns2 > nlist // 8).sum())
        if stragglers or es.multipler >= 64.0:
            break
        es.multipler = min(es.multipler * 2.0, 64.0)
    check(stragglers > 0, "no query of the strict window reached phase B")
    f32 = torch.float32
    q = torch.as_tensor(es.queries[win], device=dev)
    acc_t = torch.as_tensor(acc[win], device=dev)
    m = torch.tensor(es.multipler, dtype=f32, device=dev)
    sm = torch.tensor(es.std_m, dtype=f32, device=dev)
    margin = es._decide_margin_flag()

    def single():
        vals, ids, _, ns = bounded_search(
            idx.arrays, es.traces, q, acc_t, m, sm, K, MAX_TOPK, idx.metric,
            decide_margin=margin)
        return (vals[:, :K].cpu().numpy(), ids[:, :K].cpu().numpy(),
                ns.cpu().numpy())

    (D1, I1, ns1), n1 = counted(single)
    bad_ids = int((I1 != I2).any(axis=1).sum())
    bad_ns = int((ns1 != ns2).sum())
    d_err = float(np.abs(D1 - D2).max())
    t_one, t_two = [], []
    for _ in range(3):
        t_one.append(synced(single)[1])
        t_two.append(synced(two)[1])
        t_two.append(synced(two)[1])
        t_one.append(synced(single)[1])
    cnt = recall_counts(D2, gt_D[win], K, Metric.L2)
    ms_one, ms_two = np.median(t_one) * 1e3, np.median(t_two) * 1e3
    log(f"[phase B] bound 1.0 at multipler {es.multipler:.3f}: "
        f"{stragglers} of {N_TEST_Q} queries past nlist/8, mean n_scanned "
        f"{ns2.mean():.2f} max {ns2.max()}; worst recall@{K} "
        f"{cnt.min() / K:.3f} mean {cnt.mean() / K:.4f}; two-phase "
        f"{ms_two:.2f} ms ({' '.join(f'{t * 1e3:.2f}' for t in t_two)}), "
        f"single-phase {ms_one:.2f} ms "
        f"({' '.join(f'{t * 1e3:.2f}' for t in t_one)}); launches two-phase "
        f"{n2}, single-phase {n1}; queries whose ids differ {bad_ids}, "
        f"n_scanned differ {bad_ns}, max |D| diff {d_err:.3g} [{card}]")
    check(bad_ids == 0 and bad_ns == 0 and d_err == 0.0,
          "two-phase and single-phase windows differ")
    es.set_queries(es.num, es.queries, saved[0])
    es.multipler = saved[1]
    return {"two_ms": ms_two, "single_ms": ms_one, "stragglers": stragglers}


def kernels_on_index(c: dict, device, card: str) -> dict:
    """Each kernel against its plain version on the real index: K1 on the
    multi-row search's rows, K2 on the padded lists at the two-phase
    window's chunk shape."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.index.scan import coarse_rank
    from auncel_tpu_torch.kernels.rowscan import rowscan_dots, \
        rowscan_dots_ref
    from auncel_tpu_torch.ops.distance import sqnorms

    idx, xq = c["idx"], c["xq"]
    a, db, T = idx.arrays, idx.multirow.rows.db, 4096
    gen = torch.Generator(device=device).manual_seed(1)
    xq_d = torch.as_tensor(xq, device=device)
    rows = torch.randint(0, db.shape[0], (T,), generator=gen, device=device,
                         dtype=torch.int32)
    qs = xq_d[torch.randint(0, xq.shape[0], (T,), generator=gen,
                            device=device)]
    got = rowscan_dots(db, rows, qs)
    want = rowscan_dots_ref(db, rows, qs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    gb = T * db.shape[1] * db.shape[2] * 4 / 1e9
    t_k, t_ref = time_pair(lambda: rowscan_dots(db, rows, qs),
                           lambda: rowscan_dots_ref(db, rows, qs), 10)
    log(f"[k1] index rows: T={T} row_cap={db.shape[1]} max rel err "
        f"{rel:.3g} kernel {t_k:.4f} ms ({gb / t_k * 1e3:.1f} GB/s) "
        f"plain {t_ref:.4f} ms ({gb / t_ref * 1e3:.1f} GB/s) [{card}]")
    del got, want
    # the two-phase window's first chunk: 1000 held-out queries, each on
    # its 4 best-ranked lists
    q = xq_d[N_TRAIN_Q:N_TRAIN_Q + N_TEST_Q].contiguous()
    q_sq = sqnorms(q)
    _, cids = coarse_rank(a, q, Metric.L2, q_sq=q_sq, rank_k=4)
    args = (a.db, a.db_sq, a.vec_ids, a.list_sizes, q, q_sq,
            cids.contiguous())
    out = k2_compare("index window chunk", args, Metric.L2, card, reps=10,
                     terms_tol=True)
    torch.cuda.empty_cache()
    return out


def profile_search(es, out_dir: str, card: str, label: str) -> None:
    """Kernel-time breakdown of one batched and one batch-1 search."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    for name, size in (("batched", N_TEST_Q), ("batch1", 1)):
        es.search(N_TRAIN_Q, size)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            es.search(N_TRAIN_Q, size)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=25)
        # the device's own events only: an operator's row repeats the time
        # of the kernels it launched
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        with open(os.path.join(out_dir, f"profile_{label}_{name}.txt"),
                  "w") as f:
            f.write(f"{card}\nwall {wall * 1e3:.2f} ms, device "
                    f"{dev_us / 1e3:.2f} ms\n{table}\n")
        log(f"[profile] {label} {name}: wall {wall * 1e3:.2f} ms, device busy "
            f"{dev_us / 1e3:.2f} ms ({100 * dev_us / 1e3 / (wall * 1e3):.1f}"
            f"%) [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from auncel_tpu_torch.kernels import build  # fails outside the repo
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = ("rowscan", "scan_scores")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(build.load, sources))  # one nvcc each, all at once
    log(f"[build] {', '.join(f'{n}.cu' for n in sources)} built in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{build.BUILD_INFO[n]['seconds']:.2f} s"
                    for n in sources) + ")")
    for n in sources:
        for line in build.BUILD_INFO[n]["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {n}: {line.strip()}")
    profile_dir = None
    if "--profile" in sys.argv:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]

    k1 = k1_check(device, card)
    k2_check(device, card)
    corpus = build_corpus(card)
    mr_launches = multirow_path(corpus, card, profile_dir)
    pad_launches = padded_path(corpus, card, profile_dir)
    k2 = kernels_on_index(corpus, device, card)
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    kernels = [
        {"name": "rowscan_dots", "route": "cuda",
         "source": "auncel_tpu_torch/csrc/rowscan.cu",
         "replaces": "auncel_tpu/pallas_kernels/rowscan.py:77",
         "launches": (mr_launches["rowscan_dots"]
                      + pad_launches["rowscan_dots"]),
         "library_ms": None, **k1},
        {"name": "scan_scores", "route": "cuda",
         "source": "auncel_tpu_torch/csrc/scan_scores.cu",
         "replaces": "auncel_tpu/pallas_kernels/scan_scores.py:89",
         "launches": (mr_launches["scan_scores"]
                      + pad_launches["scan_scores"]),
         "library_ms": None, **k2}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
