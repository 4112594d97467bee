"""Pairwise distance primitives (port of ``auncel_tpu/ops/distance.py``).

Plain fp32 matrix products (the JAX package leaves these to XLA). Every
function returns actual metric values: the profile engine matches
distances by value, so every search path must produce the same distance
for the same (query, vector) pair.
"""

import torch

from auncel_tpu_torch.types import Metric


def sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 norms over the last axis. [..., d] -> [...]."""
    return torch.sum(x * x, dim=-1)


def pairwise_ip(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner products. x: [n, d], y: [m, d] -> [n, m]."""
    return x @ y.T


def pairwise_l2sqr(x: torch.Tensor, y: torch.Tensor,
                   y_sqnorms: torch.Tensor | None = None,
                   x_sqnorms: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances. x: [n, d], y: [m, d] -> [n, m], clamped at 0
    (the expansion can go epsilon-negative for identical vectors). Pass the
    stored ``y_sqnorms`` of a corpus so every path reuses one norm vector."""
    xn = sqnorms(x) if x_sqnorms is None else x_sqnorms
    yn = sqnorms(y) if y_sqnorms is None else y_sqnorms
    d = xn[:, None] + yn[None, :] - 2.0 * pairwise_ip(x, y)
    return d.clamp_min(0.0)


def pairwise_scores(x: torch.Tensor, y: torch.Tensor, metric: Metric,
                    y_sqnorms: torch.Tensor | None = None,
                    x_sqnorms: torch.Tensor | None = None) -> torch.Tensor:
    """Metric values: L2 -> squared distances (smaller better), IP -> dot
    products (larger better)."""
    if metric is Metric.L2:
        return pairwise_l2sqr(x, y, y_sqnorms=y_sqnorms, x_sqnorms=x_sqnorms)
    return pairwise_ip(x, y)
