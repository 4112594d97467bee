"""The control of ``correct``: the reference put in the program's place at
a precision below the configuration's, which the comparison has to refuse.

* ``tf32``: the exact search's float32 distances ``|q|^2 + |x|^2 - 2 q.x``
  with the products in TF32, the step below float32 on the card (on a CPU,
  which has no TF32, the inputs of the products are rounded to TF32's 10
  mantissa bits first, as the tensor cores round them);
* ``sq4``: for SQ8 storage, the same search in float32 over SQ4 codes (the
  step below 8-bit codes) of the same corpus.

Each control answers the same pool the run serves, and the same ``Judge``
as a run weighs it. On the card, at a cell's own size:

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed and control with the compared numbers.
"""

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import data
from benchmark.check import Judge
from benchmark.reference.knn import (
    float32_topk, matmul_precision, sqnorms64, stored_vectors)
from benchmark.spec import Spec


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000 + ((bits >> 13) & 1) - 1) & ~0x1FFF
    return bits.view(torch.float32)


def control_answers(kind: str, xb: torch.Tensor, stored: torch.Tensor,
                    pool: torch.Tensor, k: int):
    """(distances, ids) numpy [n, k] of the control ``kind``."""
    if kind == "sq4":
        xs = stored_vectors(xb, "sq4")
        with matmul_precision(False):
            D, I = float32_topk(xs, pool, k, sqnorms64(xs))
    elif pool.device.type == "cuda":
        with matmul_precision(True):
            D, I = float32_topk(stored, pool, k, sqnorms64(stored))
    else:
        D, I = float32_topk(to_tf32(stored), to_tf32(pool), k,
                            sqnorms64(stored))
    return D.cpu().numpy(), I.cpu().numpy()


def kinds_for(cfg: dict) -> list:
    return ["tf32", "sq4"] if cfg["index"]["storage"] == "sq8" else ["tf32"]


def readings(spec: Spec, cell: dict, seed: int, device) -> list:
    """[{seed, control, correct, numbers}] of each control on one seed."""
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    prof = cfg["profile"]
    n_setup = int(prof["profile_queries"]) + int(prof["calibration_queries"])
    xb, _, pool = data.make_inputs(cfg["corpus"], seed, device, n_setup,
                                   int(traffic["pool"]))
    stored = stored_vectors(xb, cfg["index"]["storage"])
    k = int(traffic["k"])
    judge_args = (stored, sqnorms64(stored), pool, k,
                  float(traffic["recall_bound"]),
                  float(cfg["check"]["dist_gap_limit"]))
    out = []
    for kind in kinds_for(cfg):
        D, I = control_answers(kind, xb, stored, pool, k)
        judge = Judge(*judge_args)
        judge.add(np.arange(pool.shape[0]), D, I)
        out.append({"seed": seed, "control": kind,
                    "correct": judge.correct(),
                    "numbers": {n: v for n, v, _, _ in judge.numbers()}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(".")
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        for r in readings(spec, cell, seed, "cuda"):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
