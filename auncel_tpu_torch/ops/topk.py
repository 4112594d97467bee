"""Exact batched top-k selection and merging (port of
``auncel_tpu/ops/topk.py``).

Results stay sorted best-first. Ties keep the FIRST occurrence, as
``lax.top_k`` does (``torch.topk`` does not promise an order among equal
values), so selection is a stable sort on the score. Pad slots carry the
metric's worst value and id -1. ``merge_topk_verified``, the probe scan's
running merge, gives the same bits by a hand-written selection kernel on
the card (``kernels/topk_merge.py``).
"""

import torch

from auncel_tpu_torch.tracing import MERGE, span
from auncel_tpu_torch.types import Metric, worst_value


def topk_scores(scores: torch.Tensor, ids: torch.Tensor, k: int,
                metric: Metric) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by metric order. scores: [..., n], ids: [..., n] int32.
    Returns (vals [..., k], ids [..., k]) sorted best-first, padded with the
    worst value and id -1 when n < k."""
    n = scores.shape[-1]
    if n < k:
        pad_shape = scores.shape[:-1] + (k - n,)
        scores = torch.cat([scores, torch.full(
            pad_shape, worst_value(metric), dtype=scores.dtype,
            device=scores.device)], dim=-1)
        ids = torch.cat([ids, torch.full(pad_shape, -1, dtype=ids.dtype,
                                         device=ids.device)], dim=-1)
    vals, order = torch.sort(scores, dim=-1, stable=True,
                             descending=not metric.lower_is_better)
    vals, order = vals[..., :k], order[..., :k]
    out_ids = torch.gather(ids, -1, order)
    # a pad slot picked by the sort keeps id -1
    is_pad = torch.isposinf(vals) if metric is Metric.L2 \
        else torch.isneginf(vals)
    out_ids = torch.where(is_pad, torch.full_like(out_ids, -1), out_ids)
    return vals, out_ids


def merge_topk(vals_a: torch.Tensor, ids_a: torch.Tensor,
               vals_b: torch.Tensor, ids_b: torch.Tensor, k: int,
               metric: Metric) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two best-first candidate sets into the top-k of their union."""
    return topk_scores(torch.cat([vals_a, vals_b], dim=-1),
                       torch.cat([ids_a, ids_b], dim=-1), k, metric)


def merge_topk_verified(rvals: torch.Tensor, rids: torch.Tensor,
                        scores: torch.Tensor, ids: torch.Tensor, k: int,
                        metric: Metric) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k merge of a running result ``[..., kr]`` with a wide
    candidate window ``[..., n]``: bit for bit ``topk_scores`` over their
    concatenation, values and ids, at any k. The JAX package proves an
    approximate selection exact by a certificate and sorts when it fails;
    here the card runs an exact selection kernel that never builds the
    concatenation (``kernels/topk_merge.py``), and the CPU the stable
    sort."""
    # imported here: the kernel's module takes merge_topk from this one
    from auncel_tpu_torch.kernels.topk_merge import topk_merge
    with span(MERGE):
        return topk_merge(rvals, rids, scores, ids, k, metric)


def sort_scores(vals: torch.Tensor, ids: torch.Tensor,
                metric: Metric) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort candidates best-first along the last axis (stable)."""
    vals, order = torch.sort(vals, dim=-1, stable=True,
                             descending=not metric.lower_is_better)
    return vals, torch.gather(ids, -1, order)


def init_topk(batch_shape: tuple, k: int, metric: Metric,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty running result: worst values, id -1."""
    vals = torch.full(batch_shape + (k,), worst_value(metric),
                      dtype=torch.float32, device=device)
    ids = torch.full(batch_shape + (k,), -1, dtype=torch.int32,
                     device=device)
    return vals, ids
