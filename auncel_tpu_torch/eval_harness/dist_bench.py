"""Distributed scaling experiment (port of
``auncel_tpu/eval_harness/dist_bench.py``).

Parity with the reference's dist/ evaluation (figure 16: average
bounded-search latency against the worker count,
``figures/dist/figure16.py``, which hardcodes its numbers; this measures
them). For each shard count it builds a ``ShardedIVF``, trains the
per-shard profiles, enables the multi-row one-shot engine, and times the
sharded bounded search; it writes ``Dist_scaling.log`` rows (shards,
ms/query) and draws ``fig16.png``.

Shards take the visible devices round-robin, so no shard count is skipped
and the stderr line names how many distinct devices ran each one. On one
card every shard shares it: the curve then measures the cost of splitting
one card's corpus into S shards served one after another (S smaller
scans, S profiles, and the merge), not a speed-up.

    python -m auncel_tpu_torch.eval_harness.dist_bench synth10K \\
        --shards 1 2 4 8
"""

import argparse
import time

import numpy as np

from auncel_tpu_torch.eval_harness import common
from auncel_tpu_torch.parallel.sharded import ShardedIVF, make_mesh


def run(db: str = "synth10K", shard_counts=(1, 2, 4, 8), nq: int = 64,
        nlist: int = 64, max_topk: int = 50, input_k: int = 10,
        bound: float = 0.9, reps: int = 3, log_dir: str = ".",
        device="cuda"):
    """``device`` "cuda" spreads the shards over every visible card;
    another device (e.g. "cpu") holds them all."""
    log = common.stderr_log()
    data = common.load_dataset(db, nq=nq)
    acc = np.full(nq, bound, np.float32)
    devices = None if device == "cuda" else [device]
    rows = []
    for S in shard_counts:
        mesh = make_mesh(S, devices=devices)
        s = ShardedIVF(data.xb.shape[1], nlist, S, data.metric, mesh=mesh)
        s.build(data.xb)
        s.train_profiles(data.xq[: nq // 2], max_topk=max_topk)
        s.enable_multirow()  # production engine per shard
        s.multipler = 8.0
        s.search_bounded(data.xq, acc, query_k=input_k)  # warm
        common.sync(device)
        t1 = time.perf_counter()
        for _ in range(reps):
            vals, ids, nscan = s.search_bounded(data.xq, acc,
                                                query_k=input_k)
        common.sync(device)
        dt = (time.perf_counter() - t1) / reps / nq * 1e3
        rows.append((S, dt))
        n_dev = len({str(d) for d in mesh.devices.flat})
        log(f"shards={S} on {n_dev} distinct device(s): {dt:.3f} ms/query "
            f"(mean per-shard scanned lists {nscan.mean():.1f})")

    fn = f"{log_dir}/Dist_scaling.log"
    common.write_log(fn, rows)
    try:
        from auncel_tpu_torch.figures import plots
        plots.dist_scaling([r[0] for r in rows], [r[1] for r in rows],
                           f"{log_dir}/fig16.png")
    except Exception as e:  # matplotlib optional
        log(f"figure skipped: {e}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db", nargs="?", default="synth10K")
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.db, shard_counts=tuple(args.shards), device=args.device)


if __name__ == "__main__":
    main()
