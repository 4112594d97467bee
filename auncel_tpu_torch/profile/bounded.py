"""Helpers of the bounded (early-terminating) search (port of the helpers
in ``auncel_tpu/profile/bounded.py``): wave boundaries, the stage -> trace
map and the per-boundary recall estimate. The padded-layout engines of that
module are not ported yet.
"""

import numpy as np
import torch

from auncel_tpu_torch.profile.geometry import sum_angle
from auncel_tpu_torch.profile.trace import TraceSet, trace_lookup
from auncel_tpu_torch.profile.trainer import train_stages

FULL_OK_SLACK = 1.005       # cur_num's all-k fast path (IVF_pro.cpp:276)
STAGNATION_FACTOR = 12.0    # stops = require_acc * 12 (IndexIVF.cpp:575)


def wave_boundaries(nlist: int) -> list[int]:
    """Decision boundaries (powers of two to nlist/8) + scan-only
    boundaries (steps of nlist/8 up to nlist)."""
    bounds = train_stages(nlist)
    step = max(nlist // 8, 1)
    b = bounds[-1] + step
    while b <= nlist:
        bounds.append(b)
        b += step
    return bounds


def stage_to_trace(stage: int, nlist: int) -> int:
    """Smallest ind with 2^ind >= min(stage, nlist/8 - 1)
    (IndexIVF.cpp:555-558)."""
    tmp = min(stage, nlist // 8 - 1)
    ind = 0
    while tmp > (1 << ind):
        ind += 1
    return ind


def _simulate_cur_num(p: torch.Tensor, first_ok: torch.Tensor,
                      query_k: int) -> torch.Tensor:
    """Replay of the reference's binary search over candidate ranks
    (``error_pro::cur_num``, IVF_pro.cpp:258-291). ``p[b, m]`` is the
    predicate (m+1) * U(phi(D_m)) <= query_k, which is not guaranteed
    monotone, so the exact binary-search result is replayed instead of a
    count."""
    B = p.shape[0]
    dev = p.device
    low = torch.zeros(B, dtype=torch.int32, device=dev)
    high = torch.full((B,), query_k - 1, dtype=torch.int32, device=dev)
    done = first_ok.clone()
    result = torch.where(first_ok, query_k, 0).to(torch.int32)
    n_iter = max(int(np.ceil(np.log2(max(query_k, 2)))) + 1, 10)
    for _ in range(n_iter):
        active = (~done) & (low <= high)
        middle = torch.div(low + high, 2, rounding_mode="floor")
        ret0 = active & (middle <= 0)
        result = torch.where(ret0, 0, result)
        done = done | ret0
        pm = torch.gather(p, 1, middle.clamp(0, query_k - 1).long()[:, None]
                          )[:, 0]
        go = active & ~ret0
        low = torch.where(go & pm, middle + 1, low)
        high = torch.where(go & ~pm, middle - 1, high)
    return torch.where(done, result, low + 1)


def _recall_estimate(traces: TraceSet, dtb: torch.Tensor, tval: torch.Tensor,
                     ind: int, k: int, std_m: torch.Tensor) -> torch.Tensor:
    """phi -> U -> cur_num -> predicted recall at width ``k`` (the
    reference's per-boundary estimate, IVF_pro.cpp:258-291)."""
    kf = float(k)
    mrange = torch.arange(1, k + 1, dtype=torch.float32,
                          device=tval.device)[None, :]
    phi = sum_angle(tval[:, :k], dtb, (1 << ind) - 1)
    U = trace_lookup(traces, ind, phi, std_m)
    p = (mrange * U) <= kf
    first_ok = kf * U[:, k - 1] <= kf * FULL_OK_SLACK
    pre_num = _simulate_cur_num(p, first_ok, k)
    return pre_num.to(torch.float32) / kf


def exact_topk_mask(require_acc: torch.Tensor, query_k: int) -> torch.Tensor:
    """Queries whose bound demands the exact top-k: ceil(acc*k) == k <=>
    acc*k > k-1 (1e-4 slack for the f32 representation of 1 - eps)."""
    return require_acc * float(query_k) > float(query_k) - 1.0 + 1e-4
