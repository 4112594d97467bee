"""Blocked exact brute-force k-NN (port of ``auncel_tpu/ops/knn.py``).

Queries go through in blocks of ``q_block`` and the corpus in blocks of
``db_block``: each corpus block's scores are one fp32 matrix product (no
TF32, ``device.resolve``), its top-k is merged into the running top-k. The
selection is the stable sort of ``ops/topk.py``, so ties keep the lower
corpus id, as ``lax.top_k`` does in the JAX package. Host-facing: numpy in,
numpy out; the work runs on ``device``, the card unless the caller asks
for another.
"""

from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.ops.distance import pairwise_scores, sqnorms
from auncel_tpu_torch.ops.topk import init_topk, merge_topk, topk_scores
from auncel_tpu_torch.types import Metric, worst_value


class KnnResult(NamedTuple):
    vals: np.ndarray  # [nq, k] metric values, best first
    ids: np.ndarray   # [nq, k] int32 corpus ids


def knn(queries, corpus, k: int, metric: Metric = Metric.L2,
        q_block: int = 1024, db_block: int = 65536,
        y_sqnorms: np.ndarray | None = None, device="cuda") -> KnnResult:
    """Exact k nearest neighbours of each query in the corpus.
    ``y_sqnorms`` overrides the corpus norm term (the base-shift trick
    folds per-row additive shifts into it)."""
    metric = Metric.parse(metric)
    dev = resolve(device)
    queries = np.asarray(queries, np.float32)
    corpus = np.asarray(corpus, np.float32)
    nq, d = queries.shape
    nb = corpus.shape[0]
    assert corpus.shape[1] == d
    db_block = min(db_block, max(512, nb))
    db = torch.as_tensor(corpus, device=dev)
    db_sq = (sqnorms(db) if y_sqnorms is None else torch.as_tensor(
        np.asarray(y_sqnorms, np.float32), device=dev))
    out_vals = np.empty((nq, k), np.float32)
    out_ids = np.empty((nq, k), np.int32)
    for q0 in range(0, nq, q_block):
        q = torch.as_tensor(queries[q0:q0 + q_block], device=dev)
        vals, ids = init_topk((q.shape[0],), k, metric, dev)
        for b0 in range(0, nb, db_block):
            y, ysq = db[b0:b0 + db_block], db_sq[b0:b0 + db_block]
            s = pairwise_scores(q, y, metric, y_sqnorms=ysq)
            block_ids = torch.arange(b0, b0 + y.shape[0], dtype=torch.int32,
                                     device=dev).expand(s.shape)
            bvals, bids = topk_scores(s, block_ids, min(k, db_block), metric)
            vals, ids = merge_topk(vals, ids, bvals, bids, k, metric)
        out_vals[q0:q0 + q_block] = vals.cpu().numpy()
        out_ids[q0:q0 + q_block] = ids.cpu().numpy()
    return KnnResult(out_vals, out_ids)


def _subset_scores(q: torch.Tensor, db: torch.Tensor, labels: torch.Tensor,
                   metric: Metric) -> torch.Tensor:
    """[nq, ns] metric values of q[i] against db[labels[i]]; the worst
    value where labels < 0."""
    sub = db[labels.clamp_min(0).long()]                      # [nq, ns, d]
    dots = torch.einsum("bsd,bd->bs", sub, q)
    if metric is Metric.L2:
        scores = (sqnorms(q)[:, None] + sqnorms(sub) - 2.0 * dots
                  ).clamp_min(0.0)
    else:
        scores = dots
    return torch.where(labels >= 0, scores, worst_value(metric))


def compute_distance_subset(queries: np.ndarray, corpus: np.ndarray,
                            labels: np.ndarray, metric: Metric = Metric.L2,
                            device="cuda") -> np.ndarray:
    """Distances of each query to its own candidate-id row, in label order
    (the re-ranking primitive); labels < 0 give the metric's worst
    value."""
    dev = resolve(device)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    db = torch.as_tensor(np.asarray(corpus, np.float32), device=dev)
    lab = torch.as_tensor(np.asarray(labels, np.int64).astype(np.int32),
                          device=dev)
    return _subset_scores(q, db, lab, Metric.parse(metric)).cpu().numpy()


def knn_by_idx(queries: np.ndarray, corpus: np.ndarray, labels: np.ndarray,
               k: int, metric: Metric = Metric.L2,
               device="cuda") -> KnnResult:
    """Top-k among per-query candidate id lists (re-rank a pre-selected
    list). Returned ids are corpus ids; labels < 0 are excluded and come
    back as id -1, and k past the list's width pads with the worst value
    and id -1."""
    metric = Metric.parse(metric)
    dev = resolve(device)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    db = torch.as_tensor(np.asarray(corpus, np.float32), device=dev)
    lab = torch.as_tensor(np.asarray(labels, np.int64).astype(np.int32),
                          device=dev)
    scores = _subset_scores(q, db, lab, metric)
    lab = torch.where(lab >= 0, lab, -1)
    # topk_scores pads k past the width with the worst value and id -1
    vals, ids = topk_scores(scores, lab, k, metric)
    return KnnResult(vals.cpu().numpy(), ids.cpu().numpy())


def knn_l2sqr_base_shift(queries: np.ndarray, corpus: np.ndarray, k: int,
                         base_shift: np.ndarray, q_block: int = 4096,
                         device="cuda") -> KnnResult:
    """L2 kNN with a per-corpus-row additive shift: score(q, y_i) =
    ||q - y_i||^2 + base_shift[i], the shift folded into the norm term."""
    dev = resolve(device)
    corpus = np.asarray(corpus, np.float32)
    shifted = (sqnorms(torch.as_tensor(corpus, device=dev)).cpu().numpy()
               + np.asarray(base_shift, np.float32))
    return knn(queries, corpus, k, Metric.L2, q_block=q_block,
               y_sqnorms=shifted, device=dev)
