"""The comparison that decides ``correct``.

Every answer the timed window produced is judged against the reference
(``reference/knn.py``) over the vectors the index stores, which the
reference works out again from the corpus. Three numbers, each beside its
limit:

* ``worst_recall``: the least recall@k over the answers. A returned id is a
  hit when its exact distance is at most the exact k-th distance, give or
  take the rounding that ``dist_gap`` allows. The limit is the traffic's
  recall bound: the guarantee every query carries.
* ``dist_gap``: the largest gap between a returned distance and the exact
  distance of the id returned with it, as a share of ``|q|^2 + |x|^2`` (the
  scale of a float32 ``|q|^2 + |x|^2 - 2 q.x``). Its limit is the
  configuration's ``check.dist_gap_limit``.
* ``bad_ids``: ids out of range, repeated within an answer, or missing
  (the answer's shape). The limit is 0.
"""

import numpy as np
import torch

from benchmark.reference.knn import exact_distances, exact_topk


class Judge:
    """The reference's exact top ``k`` of the served pool, and the judge of
    answers given as (pool offsets, distances [n, k], ids [n, k], times
    served)."""

    def __init__(self, stored: torch.Tensor, x_sq: torch.Tensor,
                 pool: torch.Tensor, k: int, bound: float, gap_limit: float):
        self.xs, self.x_sq, self.pool = stored, x_sq, pool
        self.k, self.bound, self.gap_limit = k, float(bound), float(gap_limit)
        self.ref_d, self.ref_i = exact_topk(stored, pool, k, x_sq)
        self.q_sq = pool.double().square().sum(1)
        self.worst_recall = 1.0
        self.dist_gap = 0.0
        self.bad_ids = 0
        self.attempted = 0
        self.failed = 0

    def add(self, offsets: np.ndarray, D: np.ndarray, I: np.ndarray,
            times: int = 1) -> None:
        n, k = len(offsets), self.k
        self.attempted += n * times
        if D.shape != (n, k) or I.shape != (n, k):
            self.bad_ids += n * k
            self.worst_recall = 0.0
            self.failed += n * times
            return
        dev = self.xs.device
        off = torch.as_tensor(offsets, device=dev)
        ids = torch.as_tensor(I, dtype=torch.int64, device=dev)
        got = torch.as_tensor(D, device=dev).double()
        nb = self.xs.shape[0]
        valid = (ids >= 0) & (ids < nb)
        srt, pos = ids.sort(1)
        rep = torch.zeros_like(valid)
        rep.scatter_(1, pos[:, 1:], srt[:, 1:] == srt[:, :-1])
        bad = ~valid | rep
        q_sq = self.q_sq[off]
        exact = exact_distances(self.xs, self.pool[off], ids)
        scale = q_sq[:, None] + self.x_sq[ids.clamp(0, nb - 1)]
        gap = ((got - exact).abs() / scale).masked_fill(bad, 0.0)
        gap = torch.where(torch.isfinite(got) | bad, gap,
                          torch.full_like(gap, float("inf")))
        kth = self.ref_i[off, k - 1]
        tie = self.gap_limit * (q_sq + self.x_sq[kth])
        hit = ~bad & (exact <= (self.ref_d[off, k - 1] + tie)[:, None])
        recall = hit.sum(1).double() / k
        row_gap = gap.max(1).values
        row_fail = (recall < self.bound - 1e-9) | (row_gap > self.gap_limit) \
            | bad.any(1)
        self.worst_recall = min(self.worst_recall, float(recall.min()))
        self.dist_gap = max(self.dist_gap, float(row_gap.max()))
        self.bad_ids += int(bad.sum())
        self.failed += int(row_fail.sum()) * times

    def numbers(self) -> list:
        """[(name, value, limit, relation)] of the compared numbers."""
        return [("worst_recall", self.worst_recall, self.bound, ">="),
                ("dist_gap", self.dist_gap, self.gap_limit, "<="),
                ("bad_ids", self.bad_ids, 0, "<=")]

    def correct(self) -> bool:
        return (self.attempted > 0
                and self.worst_recall >= self.bound - 1e-9
                and self.dist_gap <= self.gap_limit and self.bad_ids == 0)
