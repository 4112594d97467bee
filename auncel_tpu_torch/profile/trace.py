"""phi -> U maps ("traces"), one per power-of-two probe stage (port of
``auncel_tpu/profile/trace.py``; ``build_trace`` is its numpy code, copied).

All traces live in one padded ``[n_traces, max_bins]`` tensor triple. The
``.npz`` format is the JAX package's, so a profile saved by either package
loads in the other.
"""

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_BATCH = 250  # Trace::bs (IVF_pro.h:56)

# U for stages with no training data: the predicate never fires there.
EMPTY_TRACE_U = 1e9


class TraceSet(NamedTuple):
    phi: torch.Tensor     # [n_traces, max_bins] ascending, +inf padded
    u: torch.Tensor       # [n_traces, max_bins]
    std: torch.Tensor     # [n_traces, max_bins]
    n_bins: torch.Tensor  # [n_traces] int32

    @property
    def n_traces(self) -> int:
        return self.phi.shape[0]


def build_trace(phi_pairs: np.ndarray, u_pairs: np.ndarray,
                valid: np.ndarray, bs: int = DEFAULT_BATCH):
    """Trace::SB: raw pairs -> (phi_bins, u_bins, std_bins), ascending:
    sort by phi descending, average in batches of ``bs`` (std divides by
    ``bs`` even for the ragged last batch, as the reference does), then
    reverse."""
    phi = np.asarray(phi_pairs, np.float64).ravel()
    u = np.asarray(u_pairs, np.float64).ravel()
    valid = np.asarray(valid, bool).ravel()
    phi, u = phi[valid], u[valid]
    if phi.size == 0:
        return (np.zeros(1, np.float32),
                np.full(1, EMPTY_TRACE_U, np.float32),
                np.zeros(1, np.float32))
    order = np.argsort(-phi, kind="stable")
    phi, u = phi[order], u[order]
    size = phi.size
    sz = (size + bs - 1) // bs
    phi_bins = np.empty(sz, np.float32)
    u_bins = np.empty(sz, np.float32)
    std_bins = np.empty(sz, np.float32)
    for i in range(sz):
        lo, hi = i * bs, min((i + 1) * bs, size)
        phi_bins[i] = phi[lo:hi].mean()
        u_bins[i] = u[lo:hi].mean()
        std_bins[i] = np.sqrt(((u[lo:hi] - u[lo:hi].mean()) ** 2).sum() / bs)
    return phi_bins[::-1].copy(), u_bins[::-1].copy(), std_bins[::-1].copy()


def make_trace_set(per_stage_bins, device) -> TraceSet:
    """Stack per-stage (phi, u, std) ascending numpy triples into one padded
    TraceSet on ``device``."""
    n_traces = len(per_stage_bins)
    max_bins = max(max(p[0].size for p in per_stage_bins), 1)
    phi = np.full((n_traces, max_bins), np.inf, np.float32)
    u = np.zeros((n_traces, max_bins), np.float32)
    std = np.zeros((n_traces, max_bins), np.float32)
    n_bins = np.zeros(n_traces, np.int32)
    for t, (p, uu, s) in enumerate(per_stage_bins):
        nb = p.size
        phi[t, :nb] = p
        u[t, :nb] = uu
        std[t, :nb] = s
        n_bins[t] = nb
    return traces_from_arrays(phi, u, std, n_bins, device)


def traces_from_arrays(phi, u, std, n_bins, device) -> TraceSet:
    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)
    return TraceSet(t(phi, np.float32), t(u, np.float32),
                    t(std, np.float32), t(n_bins, np.int32))


def trace_lookup(traces: TraceSet, trace_idx: int, phi_q: torch.Tensor,
                 std_m: torch.Tensor) -> torch.Tensor:
    """U(phi) for one stage, [B, K] -> [B, K] (Trace::search,
    IVF_pro.cpp:84-107): the largest bin with bin_phi <= phi plus
    std_m * std; below range -> first bin; at or above the last bin ->
    its value scaled by phi / last_phi, except on a degenerate trace
    (last_phi <= 0), which keeps EMPTY_TRACE_U."""
    phi_bins = traces.phi[trace_idx]
    u_bins = traces.u[trace_idx]
    std_bins = traces.std[trace_idx]
    last = (traces.n_bins[trace_idx] - 1).long().view(1)
    idx = torch.sum(phi_bins[None, None, :] <= phi_q[:, :, None], dim=-1,
                    dtype=torch.int32) - 1
    idx = torch.minimum(idx.clamp_min(0), last).long()
    base = u_bins[idx] + std_m * std_bins[idx]
    last_phi = phi_bins.index_select(0, last)
    last_u = u_bins.index_select(0, last) + std_m * std_bins.index_select(
        0, last)
    above = phi_q >= last_phi
    scaled = last_u * (phi_q / torch.where(last_phi != 0, last_phi, 1.0))
    scaled = torch.where(last_phi > 0, scaled, EMPTY_TRACE_U)
    return torch.where(above, scaled, base)


def save_trace_set(traces: TraceSet, path: str) -> None:
    np.savez(path, phi=traces.phi.cpu().numpy(), u=traces.u.cpu().numpy(),
             std=traces.std.cpu().numpy(),
             n_bins=traces.n_bins.cpu().numpy())


def load_trace_set(path: str, device) -> TraceSet:
    with np.load(path) as z:
        return traces_from_arrays(z["phi"], z["u"], z["std"], z["n_bins"],
                                  device)
