"""Smoke run of the PyTorch/CUDA port (auncel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases: the card; the kernel build; each kernel against its plain PyTorch
version; the bounded-search main path. Exits non-zero when there is no CUDA
device or any phase fails. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it lists each kernel.
"""

import json
import subprocess
import sys
import time

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


def k1_check(device, card: str) -> dict:
    """Build K1, compare it with its plain version and time both."""
    from auncel_tpu_torch.kernels import build
    from auncel_tpu_torch.kernels.rowscan import (
        rowscan_dots, rowscan_dots_ref)

    t0 = time.perf_counter()
    build.load("rowscan")
    log(f"[build] rowscan.cu built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_INFO['rowscan']['seconds']:.2f} s)")
    for line in build.BUILD_INFO["rowscan"]["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")

    gen = torch.Generator(device=device).manual_seed(0)
    # (name, n_rows, row_cap, d, T): the multirow scan's shape at the
    # benchmark configuration, a ragged worklist, and the scalar-load path
    shapes = [("bench", 4608, 256, 128, 4096),
              ("ragged", 4608, 256, 128, 4093),
              ("scalar", 64, 200, 100, 77)]
    result = {}
    for name, n_rows, row_cap, d, T in shapes:
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
        # in turns: plain, kernel, kernel, plain
        t_ref = cuda_time_ms(lambda: rowscan_dots_ref(db, rows, qs), 10)
        t_k = cuda_time_ms(lambda: rowscan_dots(db, rows, qs), 20)
        t_k = min(t_k, cuda_time_ms(lambda: rowscan_dots(db, rows, qs), 20))
        t_ref = min(t_ref,
                    cuda_time_ms(lambda: rowscan_dots_ref(db, rows, qs), 10))
        log(f"[k1] {name}: T={T} row_cap={row_cap} d={d} max_abs_err="
            f"{err:.3g} kernel {t_k:.4f} ms ({gb / t_k * 1e3:.1f} GB/s) "
            f"plain {t_ref:.4f} ms ({gb / t_ref * 1e3:.1f} GB/s) [{card}]")
        if name == "bench":
            result = {"max_abs_err": err, "ms": t_k, "plain_ms": t_ref}
        del db, rows, qs, got, want
    torch.cuda.empty_cache()
    return result


# The benchmark configuration (bench.py): a synthetic SIFT-like corpus,
# IVF1024,Flat, recall@10 >= 0.9 per query, 1000 queries to train and
# calibrate the profile and 1000 held-out queries to serve.
NB, D, NLIST = 1_000_000, 128, 1024
N_TRAIN_Q, N_TEST_Q, K, MAX_TOPK, EPS = 1000, 1000, 10, 100, 0.10
N_LATENCY = 1000  # all held-out queries: p99 has 10 samples beyond it
SEARCH_REPS = 5
STD_M_GRID = (0.2, 1.0, 4.0, 8.0, 12.0)  # ErrorSys.calibrate's default


def synced(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path(device, card: str, profile_dir: str | None) -> dict:
    """Build, profile-train, calibrate and serve at the benchmark
    configuration through the port's public entry points. Returns K1's
    launch counts of the run."""
    from auncel_tpu_torch import ErrorSys, IVFFlatIndex, Metric
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.data import make_clustered_dataset
    from auncel_tpu_torch.kernels.rowscan import rowscan_dots, \
        rowscan_dots_ref

    t0 = time.perf_counter()
    ds = make_clustered_dataset(nb=NB, nq=N_TRAIN_Q + N_TEST_Q, d=D,
                                n_clusters=1024, cluster_std=0.22,
                                query_mode="perturb", seed=42)
    xb, xq = ds.xb, ds.xq
    log(f"[data] {NB}x{D} corpus, {xq.shape[0]} queries in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    times = {}
    rowscan_dots.launches = 0
    idx = IVFFlatIndex(D, NLIST, device=device)
    _, times["train"] = synced(lambda: idx.train(xb[:400_000]))
    _, times["add+pack"] = synced(lambda: (idx.add(xb), idx.arrays))
    mr, times["multirow"] = synced(lambda: idx.enable_multirow())
    a = idx.arrays
    log(f"[index] cap={a.cap} packing={idx.packing_efficiency:.3f} rows="
        f"{mr.rows.db.shape[0]}x{mr.rows.db.shape[1]} device memory "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    (gt_D, gt_I), times["exact_search"] = synced(
        lambda: idx.exact_search(xq, MAX_TOPK, batch=N_TRAIN_Q))

    es = ErrorSys(idx, train_num=N_TRAIN_Q + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    n0 = rowscan_dots.launches
    _, times["sys_train"] = synced(lambda: es.sys_train(N_TRAIN_Q, xq))
    train_launches = rowscan_dots.launches - n0
    es.set_topk(K)
    acc = np.full(N_TRAIN_Q + N_TEST_Q, 1.0 - EPS, np.float32)
    es.set_queries(N_TEST_Q, xq, acc)
    log(f"[calibrate] std_m grid {STD_M_GRID}")
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(0, N_TRAIN_Q, target_bound=1.0 - EPS,
                             std_m_grid=STD_M_GRID))
    log(f"[calibrate] multipler={mult:.3f} std_m={es.std_m}")

    def serve():
        n1 = rowscan_dots.launches
        (D_out, I_out), dt = synced(lambda: es.search(N_TRAIN_Q, N_TEST_Q))
        cnt = recall_counts(D_out, gt_D[N_TRAIN_Q:], K, Metric.L2)
        return D_out, I_out, dt, cnt, rowscan_dots.launches - n1

    D_out, I_out, dt, cnt, search_launches = serve()
    while cnt.min() < K * (1.0 - EPS) and es.multipler < 64.0:
        es.multipler = min(es.multipler * 1.5, 64.0)
        log(f"[search] bound violated at min_recall={cnt.min() / K:.3f}; "
            f"escalating multipler to {es.multipler:.2f}")
        D_out, I_out, dt, cnt, search_launches = serve()
    reps = [serve()[2] for _ in range(SEARCH_REPS)]
    dt = float(np.median(reps))
    log(f"[search] window times over {SEARCH_REPS} warm repeats: "
        + " ".join(f"{r * 1e3:.2f}" for r in reps) + " ms (median "
        f"{dt * 1e3:.2f} ms)")
    times["search"] = dt
    check(D_out.shape == (N_TEST_Q, K) and I_out.shape == (N_TEST_Q, K),
          f"result shapes {D_out.shape} {I_out.shape}")
    check(np.isfinite(D_out).all() and (I_out >= 0).all(),
          "non-finite distances or missing ids")
    min_recall = cnt.min() / K
    check(min_recall >= 1.0 - EPS, f"worst-case recall {min_recall}")
    nscan = es.n_scanned[N_TRAIN_Q:N_TRAIN_Q + N_TEST_Q]
    log(f"[search] {N_TEST_Q} held-out queries: worst recall@{K}="
        f"{min_recall:.3f} mean={cnt.mean() / K:.4f} mean n_scanned="
        f"{nscan.mean():.2f} max={nscan.max()} multipler="
        f"{es.multipler:.3f} std_m={es.std_m} qps={N_TEST_Q / dt:.1f} "
        f"({dt * 1e3:.1f} ms) K1 launches={search_launches} [{card}]")

    lat = []
    lat_launches = 0
    for i in range(N_LATENCY):
        n1 = rowscan_dots.launches
        (Dq, _), t = synced(lambda: es.search(N_TRAIN_Q + i, 1))
        lat_launches += rowscan_dots.launches - n1
        check(Dq.shape == (1, K) and np.isfinite(Dq).all(),
              f"batch-1 result of query {N_TRAIN_Q + i}")
        lat.append(t * 1e3)
    lat = np.asarray(lat)
    log(f"[latency] batch-1 over {N_LATENCY} held-out queries: p50="
        f"{np.percentile(lat, 50):.2f} ms p90={np.percentile(lat, 90):.2f} "
        f"ms p99={np.percentile(lat, 99):.2f} ms max={lat.max():.2f} ms "
        f"mean={lat.mean():.2f} ms mean n_scanned="
        f"{es.n_scanned[N_TRAIN_Q:N_TRAIN_Q + N_LATENCY].mean():.2f} "
        f"K1 launches={lat_launches} [{card}]")
    total = rowscan_dots.launches
    log("[stages] " + " ".join(f"{k}={v:.2f}s" for k, v in times.items())
        + f" [{card}]")
    check(train_launches > 0, "profile training never launched K1")
    check(search_launches > 0 and lat_launches > 0,
          "search never launched K1")

    if profile_dir:
        profile_search(es, profile_dir, card)

    # K1 against its plain version on the real index: the search's row
    # layout and the profile trainer's padded lists
    gen = torch.Generator(device=device).manual_seed(1)
    xq_d = torch.as_tensor(xq, device=device)
    for name, db, T in (("rows", mr.rows.db, 4096), ("padded", a.db, 1024)):
        rows = torch.randint(0, db.shape[0], (T,), generator=gen,
                             device=device, dtype=torch.int32)
        qs = xq_d[torch.randint(0, xq.shape[0], (T,), generator=gen,
                                device=device)]
        got = rowscan_dots(db, rows, qs)
        want = rowscan_dots_ref(db, rows, qs)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        gb = T * db.shape[1] * db.shape[2] * 4 / 1e9
        t_k = cuda_time_ms(lambda: rowscan_dots(db, rows, qs), 10)
        t_ref = cuda_time_ms(lambda: rowscan_dots_ref(db, rows, qs), 5)
        log(f"[k1] index {name}: T={T} row_cap={db.shape[1]} max rel err "
            f"{rel:.3g} kernel {t_k:.4f} ms ({gb / t_k * 1e3:.1f} GB/s) "
            f"plain {t_ref:.4f} ms ({gb / t_ref * 1e3:.1f} GB/s) [{card}]")
        del got, want
    return {"launches": total, "train_launches": train_launches}


def profile_search(es, out_dir: str, card: str) -> None:
    """Kernel-time breakdown of one batched and one batch-1 search."""
    import os
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
        dev_us = sum(e.self_device_time_total for e in prof.key_averages())
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(f"{card}\nwall {wall * 1e3:.2f} ms, device "
                    f"{dev_us / 1e3:.2f} ms\n{table}\n")
        log(f"[profile] {name}: wall {wall * 1e3:.2f} ms, device busy "
            f"{dev_us / 1e3:.2f} ms ({100 * dev_us / 1e3 / (wall * 1e3):.1f}"
            f"%) [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import auncel_tpu_torch  # noqa: F401  (fails outside the repo)
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    k1 = k1_check(device, card)
    profile_dir = None
    if "--profile" in sys.argv:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]
    counts = main_path(device, card, profile_dir)
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    kernels = [{"name": "rowscan_dots", "route": "cuda",
                "source": "auncel_tpu_torch/csrc/rowscan.cu",
                "replaces": "auncel_tpu/pallas_kernels/rowscan.py:77",
                "launches": counts["launches"], **k1}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
