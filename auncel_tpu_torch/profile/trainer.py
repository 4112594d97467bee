"""Offline error-profile training (port of ``auncel_tpu/profile/trainer.py``;
reference ``Error_sys::sys_train``, profile.cpp:88-171).

One multi-probe scan over the training queries in coarse-rank order up to
nlist/8 lists; at every power-of-two stage the sorted top-k is matched BY
DISTANCE VALUE against the ground truth (1e-5 relative, reference
``kscaling``, IVF_pro.cpp:72-82) -> U = (gt_rank + 1) / (rank + 1), up to
the first unmatched candidate and at most max_topk/4 pairs per query;
phi is the boundary-angle sum from stage - 1. Per stage the pairs are
binned into a phi -> U map (``build_trace``).
"""

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.scan import IVFArrays, coarse_rank, \
    scan_probe_range
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.profile.geometry import boundary_distances, sum_angle
from auncel_tpu_torch.profile.trace import (
    TraceSet, build_trace, make_trace_set, DEFAULT_BATCH)

KSCALING_TOL = 1e-5  # reference kscaling match tolerance (IVF_pro.cpp:76)


def train_stages(nlist: int) -> list[int]:
    """Power-of-two probe stages with trained maps: 1, 2, ..., nlist/8."""
    stages = []
    s = 1
    while s <= max(nlist // 8, 1):
        stages.append(s)
        s <<= 1
    return stages


def _collect_pairs(arrays: IVFArrays, q: torch.Tensor, gt_D: torch.Tensor,
                   max_topk: int, metric: Metric):
    """One training batch -> per-stage (phi, U, valid), each
    [n_stages, B, max_topk // 4], plus the final (vals, ids)."""
    B = q.shape[0]
    nlist = arrays.nlist
    n_pairs = max_topk // 4
    q_sq = sqnorms(q)
    cdis, cids = coarse_rank(arrays, q, metric, q_sq=q_sq)
    dtb = boundary_distances(cdis, cids, arrays.interdis, metric)
    vals, ids = init_topk((B,), max_topk, metric, q.device)
    limit = torch.full((B,), nlist, dtype=torch.int32, device=q.device)
    ranks = torch.arange(max_topk, dtype=torch.float32, device=q.device)
    phis, us, valids = [], [], []
    prev = 0
    for stage in train_stages(nlist):
        vals, ids = scan_probe_range(arrays, q, q_sq, cids, vals, ids, limit,
                                     prev, stage - prev, metric)
        prev = stage
        diff = (vals[:, :, None] - gt_D[:, None, :]).abs()     # [B, k, k]
        tol = (KSCALING_TOL * vals[:, :, None].abs()).clamp_min(KSCALING_TOL)
        match = diff < tol
        has_match = match.any(dim=-1)
        first_gt = torch.argmax(match.to(torch.uint8), dim=-1)  # first match
        u = (first_gt.to(torch.float32) + 1.0) / (ranks + 1.0)
        # only the prefix run up to the first non-match (IndexIVF.cpp:657)
        run = torch.cumprod(has_match.to(torch.int32), dim=-1) > 0
        tval = vals
        if metric is Metric.IP:
            tval = torch.arccos(vals.clamp(-1.0, 1.0))
        phis.append(sum_angle(tval[:, :n_pairs], dtb, stage - 1))
        us.append(u[:, :n_pairs])
        valids.append(run[:, :n_pairs])
    return (torch.stack(phis), torch.stack(us), torch.stack(valids),
            vals, ids)


def train_profile(arrays: IVFArrays, xq: np.ndarray, gt_D: np.ndarray,
                  max_topk: int, metric: Metric, bs: int = DEFAULT_BATCH,
                  n_batches: int = 10) -> tuple[TraceSet, list]:
    """Run the training pass in ``n_batches`` query batches and build the
    TraceSet. Also returns the raw per-stage (phi, U) pairs."""
    dev = arrays.db.device
    nq = xq.shape[0]
    stages = train_stages(arrays.nlist)
    batch = max(1, nq // n_batches)
    acc = [([], [], []) for _ in stages]
    for q0 in range(0, nq, batch):
        qb = torch.as_tensor(np.asarray(xq[q0:q0 + batch], np.float32),
                             device=dev)
        gb = torch.as_tensor(np.asarray(gt_D[q0:q0 + batch, :max_topk],
                                        np.float32), device=dev)
        phi, u, valid, _, _ = _collect_pairs(arrays, qb, gb, max_topk,
                                             metric)
        phi, u, valid = phi.cpu().numpy(), u.cpu().numpy(), \
            valid.cpu().numpy()
        for t in range(len(stages)):
            acc[t][0].append(phi[t])
            acc[t][1].append(u[t])
            acc[t][2].append(valid[t])
    raw, bins = [], []
    for p_l, u_l, v_l in acc:
        p, uu, v = (np.concatenate(p_l), np.concatenate(u_l),
                    np.concatenate(v_l))
        raw.append((p[v], uu[v]))
        bins.append(build_trace(p, uu, v, bs=bs))
    return make_trace_set(bins, dev), raw
