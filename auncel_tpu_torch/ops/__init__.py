"""Distance, top-k and k-means primitives."""

from auncel_tpu_torch.ops.distance import (
    sqnorms,
    pairwise_l2sqr,
    pairwise_ip,
    pairwise_scores,
)
from auncel_tpu_torch.ops.topk import topk_scores, merge_topk, sort_scores
from auncel_tpu_torch.ops.knn import knn, KnnResult

__all__ = [
    "sqnorms",
    "pairwise_l2sqr",
    "pairwise_ip",
    "pairwise_scores",
    "topk_scores",
    "merge_topk",
    "sort_scores",
    "knn",
    "KnnResult",
]
