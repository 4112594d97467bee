"""The card's published peaks and the least time the window's scan work
needs.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense rates without sparsity, at
the full power limit of 700 W. A card set below 700 W runs slower under
load, so every share is printed with the card's power limit beside it.

The work is read from the engine's decisions, not from the kernels that
carry it out, so it stays the same whatever kernel, fusion or route serves
a window: each query scans its first ``n_scanned`` lists in coarse-rank
order, and each vector in them costs 2 d floating-point operations; each
distinct list the window touches is read once, at the codec's bytes a
vector plus 4 of norm and 4 of id. The distance path runs in float32 (the
port bans TF32 there), so the operations are held against the float32
peak outside the tensor cores.
"""

import numpy as np
import torch

PEAK = {
    "fp32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "hbm_bytes_per_s": 3.35e12,
    "power_w": 700.0,
}
# bytes a stored vector carries beside its code: a float32 norm, an int32 id
NORM_ID_BYTES = 8


def coarse_order(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[n, nlist] lists of each query by increasing squared distance to
    the centroids (plain torch)."""
    c = centroids.to(q.device, torch.float32)
    s = (c.square().sum(1)[None, :] - 2.0 * (q @ c.T))
    return torch.argsort(s, dim=1, stable=True)


def scan_work(order: np.ndarray, n_scanned: np.ndarray,
              list_sizes: np.ndarray, d: int, code_bytes: int) -> tuple:
    """(flops, bytes) of one window: ``order`` [n, nlist] the lists of each
    query in coarse-rank order, ``n_scanned`` [n] the lists each scanned."""
    n, nlist = order.shape
    take = np.arange(nlist)[None, :] < np.asarray(n_scanned)[:, None]
    scanned = np.where(take, list_sizes[order], 0)
    flops = 2.0 * d * float(scanned.sum())
    touched = np.zeros(nlist, bool)
    touched[order[take]] = True
    nbytes = float(list_sizes[touched].sum()) * (code_bytes + NORM_ID_BYTES)
    return flops, nbytes


def least_time(flops: float, nbytes: float) -> tuple:
    """(seconds, the bound: "flops" or "bytes") at the published peaks."""
    t_f = flops / PEAK["fp32_flops"]
    t_b = nbytes / PEAK["hbm_bytes_per_s"]
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")


def roofline_pct(least_s: float, kernel_s: float) -> float | None:
    """The least time as a share of the kernels' time, in %; None when no
    kernel time was read (a share of nothing is no reading)."""
    if kernel_s <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / kernel_s
