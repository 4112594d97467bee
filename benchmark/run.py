"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the seed it makes the corpus and the queries on the card, hands them
to the program (``system.py``), which builds, calibrates and serves the
traffic's warm-up queries (its set-up, ``setup_s``), then serves windows of
the pool back to back, one client in a closed loop, for ``--seconds``.
With ``--trace 1`` a profiler watches a few of those windows and the
per-layer readers (``metrics/``) take their metrics from it. After the
window the program's state is freed and the reference judges every answer
the window produced (``check.py``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, the
compared numbers beside their limits, which also end standard error.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; it never falls back to the CPU.
"""

import argparse
import json
import sys
import time

T_START = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import data, roofline, trace  # noqa: E402
from benchmark.check import Judge  # noqa: E402
from benchmark.reference.knn import sqnorms64, stored_vectors  # noqa: E402
from benchmark.spec import Spec  # noqa: E402
from benchmark.system import System, synced  # noqa: E402

# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "auncel_tpu")
# windows the traced run records after one of warm-up, unless the traffic
# names another number (``traced_windows``)
TRACED_WINDOWS = 5
# percentiles of a query's latency that a cell may report as latency_p<N>_ms
LATENCY_PERCENTILES = (50, 90, 99)


def log(msg: str, err=None) -> None:
    print(f"[bench] {msg}", file=err or sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("unknown" without
    it)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Answers:
    """Every distinct answer the window produced, by pool offset, with how
    many times it was served."""

    def __init__(self):
        self.by_offset: dict = {}

    def add(self, off: int, D: np.ndarray, I: np.ndarray) -> None:
        seen = self.by_offset.setdefault(off, [])
        for entry in seen:
            if np.array_equal(entry[0], D) and np.array_equal(entry[1], I):
                entry[2] += 1
                return
        seen.append([D, I, 1])

    def items(self):
        for off, seen in self.by_offset.items():
            for D, I, times in seen:
                yield off, D, I, times


def serve(system, traffic: dict, seconds: float, tracer=None) -> dict:
    """Windows of the pool back to back for ``seconds``: per-window
    latency, offsets and lists scanned, and every answer."""
    W, pool = int(traffic["window"]), int(traffic["pool"])
    n_pool_windows = pool // W
    lat, offs, nscan = [], [], []
    answers = Answers()
    t0 = time.perf_counter()
    w = 0
    while True:
        off = (w % n_pool_windows) * W
        ts = time.perf_counter()
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            D, I, ns = system.search(off, W)
        te = time.perf_counter()
        with torch.profiler.record_function(trace.COLLECT_SPAN):
            lat.append(te - ts)
            offs.append(off)
            nscan.append(ns)
            answers.add(off, D, I)
        w += 1
        if tracer is not None:
            tracer.step()
        if te - t0 >= seconds:
            break
    return {"wall": time.perf_counter() - t0, "lat": np.asarray(lat),
            "offs": offs, "nscan": nscan, "answers": answers, "W": W}


def run(spec: Spec, cell: dict, seed: int, seconds: float, traced: bool,
        device, system_cls=System, out=None, err=None) -> int:
    out, err = out or sys.stdout, err or sys.stderr
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    corpus, prof = cfg["corpus"], cfg["profile"]
    cuda = torch.device(device).type == "cuda"
    W, pool_n = int(traffic["window"]), int(traffic["pool"])
    if pool_n % W:
        raise ValueError(f"pool {pool_n} is not a whole number of windows "
                         f"of {W}")
    log(f"cell {cell['name']}: config {cell['config']}, traffic "
        f"{cell['traffic']}, seed {seed}, {seconds} s, trace {int(traced)}; "
        f"card {card()['kind']} ({power_limit() if cuda else 'cpu'})", err)

    # the inputs, made on the device from the seed, handed to the program
    n_setup = int(prof["profile_queries"]) + int(prof["calibration_queries"])
    (xb, q_setup, pool), t_data = synced(lambda: _inputs(
        corpus, seed, device, n_setup, pool_n))
    log(f"inputs: corpus {xb.shape[0]}x{xb.shape[1]}, {n_setup} set-up "
        f"queries, pool {pool_n}, made and handed over in {t_data:.3f} s "
        "(not in setup_s)", err)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    system = system_cls(cfg, traffic, device)
    made = system.setup(xb, q_setup, pool)
    t0 = time.perf_counter()
    # the warm-up: the traffic's first queries (by default one cycle of the
    # pool), served as the window serves them
    for off in range(0, int(traffic.get("warm_queries", pool_n)), W):
        system.search(off % pool_n, W)
    if cuda:
        torch.cuda.synchronize()
    system.times["warm"] = time.perf_counter() - t0
    setup_s = sum(system.times.values())
    log("set-up (s): " + " ".join(f"{n}={v:.3f}"
                                  for n, v in system.times.items())
        + f"; setup_s={setup_s:.3f}; from process start "
        f"{time.perf_counter() - T_START:.3f}", err)
    log(f"route: {made['route']} (dense from a window of "
        f"{made['dense_min_bsz']}; window {W}); multipler "
        f"{made['multipler']:.4f} std_m {made['std_m']} calibration mean "
        f"scan {made['cal_mean_scan']}", err)

    tracer = trace.Tracer(int(traffic.get("traced_windows",
                                          TRACED_WINDOWS))) if traced else None
    if tracer is not None:
        with tracer:
            res = serve(system, traffic, seconds, tracer)
    else:
        res = serve(system, traffic, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_win = len(res["lat"])
    qps = n_win * W / res["wall"]
    lat_ms = res["lat"] * 1e3
    lists = np.concatenate(res["nscan"]).astype(np.float64)
    pct = {p: float(np.percentile(lat_ms, p)) for p in LATENCY_PERCENTILES}
    log(f"window: {n_win} windows of {W} in {res['wall']:.3f} s, qps "
        f"{qps:.2f}, latency ms "
        + " ".join(f"p{p} {v:.3f} ({int((lat_ms > v).sum())} beyond)"
                   for p, v in pct.items())
        + f" max {lat_ms.max():.3f}, mean lists a query {lists.mean():.3f}, "
        f"peak {peak / 2**30:.3f} GiB", err)

    metrics: dict = {}
    device_out = dict(card(), memory_peak_bytes=int(peak))
    breakdown = None
    if traced:
        rec = trace.reduce(tracer, trace.load_layers(spec.layer_dir()))
        rec["n_scanned"] = lists
        rec.update(_scan_work(system, pool, res, rec, device))
        for m in spec.metrics("per_layer", cell):
            value = spec.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if rec["n_windows"]:
            device_out.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
            breakdown = rec["breakdown"]
            log(f"trace: {rec['n_windows']} windows, {rec['window_s']:.4f} s,"
                f" busy {rec['busy_s']:.4f} s, device by layer (s) "
                f"{rec['layer_s']}, scan work {rec.get('scan_flops')} "
                f"FLOP {rec.get('scan_bytes')} B, least "
                f"{rec.get('scan_least_s')} s ({rec.get('scan_bound')}-bound "
                f"at the published peaks, 700 W)", err)
    else:
        e2e = {"qps": qps, "device_mem_gib": peak / 2**30,
               "setup_s": setup_s,
               **{f"latency_p{p}_ms": v for p, v in pct.items()}}
        for m in spec.metrics("end_to_end", cell):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}

    # the reference, once the program's state is freed
    system.close()
    del system
    judge, t_ref = synced(lambda: _judge(cfg, traffic, xb, pool, res,
                                         device))
    log(f"reference: {t_ref:.3f} s for {len(list(res['answers'].items()))} "
        "distinct answers (not in setup_s)", err)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {found}; no result", err)
        return 3
    checks = {name: {"value": value, "limit": limit, "pass": rel}
              for name, value, limit, rel in judge.numbers()}
    result = {"correct": judge.correct(), "attempted": judge.attempted,
              "failed": judge.failed, "metrics": metrics,
              "device": device_out}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} {c['pass']} {c['limit']!r}", err)
    print(json.dumps(result), file=out, flush=True)
    return 0


def _inputs(corpus: dict, seed: int, device, n_setup: int, pool_n: int):
    return tuple(t.cpu().numpy() for t in data.make_inputs(
        corpus, seed, device, n_setup, pool_n))


def _scan_work(system, pool: np.ndarray, res: dict, rec: dict,
               device) -> dict:
    """The traced windows' scan work and its least time."""
    if not rec["n_windows"]:
        return {}
    lay = system.scan_layout()
    W = res["W"]
    flops = nbytes = 0.0
    # the traced windows follow the one window of warm-up
    for w in range(1, 1 + rec["n_windows"]):
        off = res["offs"][w]
        q = torch.as_tensor(pool[off:off + W], device=device)
        order = roofline.coarse_order(q, lay["centroids"]).cpu().numpy()
        f, b = roofline.scan_work(order, res["nscan"][w], lay["list_sizes"],
                                  pool.shape[1], lay["code_bytes"])
        flops, nbytes = flops + f, nbytes + b
    least, bound = roofline.least_time(flops, nbytes)
    return {"scan_flops": flops, "scan_bytes": nbytes,
            "scan_least_s": least, "scan_bound": bound}


def _judge(cfg: dict, traffic: dict, xb: np.ndarray, pool: np.ndarray,
           res: dict, device) -> Judge:
    xb_t = torch.as_tensor(xb, device=device)
    stored = stored_vectors(xb_t, cfg["index"]["storage"])
    del xb_t
    judge = Judge(stored, sqnorms64(stored),
                  torch.as_tensor(pool, device=device), int(traffic["k"]),
                  float(traffic["recall_bound"]),
                  float(cfg["check"]["dist_gap_limit"]))
    W = res["W"]
    for off, D, I, times in res["answers"].items():
        judge.add(np.arange(off, off + W), D, I, times)
    return judge


def main(argv=None) -> int:
    args = parse(argv)
    spec = Spec(".")
    cell = spec.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        log(f"{cell['name']} needs {cell['chips']} CUDA device(s), this "
            f"machine has {have}; no result")
        return 2
    return run(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda")


if __name__ == "__main__":
    sys.exit(main())
