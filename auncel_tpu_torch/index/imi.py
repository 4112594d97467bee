"""The IMI (inverted multi-index) coarse quantizer (port of
``auncel_tpu/index/imi.py``; the reference's ``IMI2x%d`` factory cell,
``AutoTune.cpp:807``, backed by ``MultiIndexQuantizer``, ``IndexPQ.cpp``).

Each half of the vector gets its own codebook of K = 2^nbit centroids, and
a coarse cell is a pair of sub-centroids: nlist = K^2 cells from 2K trained
centroids. As in the JAX package the product centroids are materialised
(``[K^2, d] = concat(c1[i], c2[j])``), so the IVF layer downstream (the
boundary geometry, error profiles, bounded search) works over IMI cells
unchanged, and cells are ranked by the exact fp32 product over all of
them. Assignment splits exactly: for L2 the argmin over the product is the
per-subspace argmin pair.
"""

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.ops.distance import pairwise_l2sqr
from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans
from auncel_tpu_torch.ops.knn import knn
from auncel_tpu_torch.ops.topk import topk_scores
from auncel_tpu_torch.types import Metric


def train_imi_centroids(x: np.ndarray, nlist: int, metric: Metric,
                        params: KmeansParams | None = None,
                        device="cuda") -> np.ndarray:
    """Train the two subspace codebooks (plain L2 k-means each, as the
    reference's MultiIndexQuantizer trains them) and materialise the
    product centroids [nlist, d]; ``nlist`` must be a square."""
    x = np.asarray(x, np.float32)
    d = x.shape[1]
    K = int(round(np.sqrt(nlist)))
    if K * K != nlist:
        raise ValueError(f"IMI nlist must be a perfect square, got {nlist}")
    if d % 2 != 0:
        raise ValueError("IMI needs an even dimension (2 subspaces)")
    h = d // 2
    params = params or KmeansParams()
    c1 = kmeans(x[:, :h], K, params, Metric.L2, device=device).centroids
    c2 = kmeans(x[:, h:], K, params, Metric.L2, device=device).centroids
    prod = np.empty((K * K, d), np.float32)
    prod[:, :h] = np.repeat(c1, K, axis=0)
    prod[:, h:] = np.tile(c2, (K, 1))
    return prod


def imi_assign(x: np.ndarray, centroids: np.ndarray,
               device="cuda") -> np.ndarray:
    """Exact cell of each row [n] int64, by the per-subspace argmin (equal
    to the argmin over the product for L2)."""
    x = np.asarray(x, np.float32)
    n = centroids.shape[0]
    K = int(round(np.sqrt(n)))
    h = centroids.shape[1] // 2
    c1 = centroids[::K, :h]            # the first half's codebook
    c2 = centroids[:K, h:]             # the second half's
    i1 = knn(np.ascontiguousarray(x[:, :h]), c1, 1, Metric.L2,
             q_block=65536, device=device).ids[:, 0]
    i2 = knn(np.ascontiguousarray(x[:, h:]), c2, 1, Metric.L2,
             q_block=65536, device=device).ids[:, 0]
    return (i1.astype(np.int64) * K + i2).astype(np.int64)


class MultiIndexQuantizer:
    """Standalone product-cell quantizer (reference ``MultiIndexQuantizer``,
    IndexPQ.h:135): ``search`` returns the k nearest product cells (id: the
    mixed-radix code, the first subspace most significant); ``add`` raises,
    as in the reference. The per-subspace distance tables are summed by
    broadcasting into the full [B, ksub^M] product and ranked exactly (a
    stable sort, so ties keep the lower cell, as ``lax.top_k`` does), up to
    MAX_CELLS cells."""

    MAX_CELLS = 1 << 20

    def __init__(self, d: int, M: int = 2, nbits: int = 8, device="cuda"):
        assert d % M == 0, "d must divide into M subspaces"
        self.d = d
        self.M = M
        self.nbits = nbits
        self.ksub = 1 << nbits
        if self.ksub ** M > self.MAX_CELLS:
            raise NotImplementedError(
                f"MultiIndexQuantizer product {self.ksub}^{M} exceeds the "
                f"exact-ranking cap {self.MAX_CELLS}")
        self.metric = Metric.L2  # the reference's MIQ is L2 only
        self.device = resolve(device)
        self.is_trained = False
        self.codebooks: list[np.ndarray] = []   # M x [ksub, d/M]

    @property
    def ntotal(self) -> int:
        # the product grid counts as stored (IndexPQ.cpp sets ntotal =
        # ksub^M after train)
        return self.ksub ** self.M if self.is_trained else 0

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        dsub = self.d // self.M
        self.codebooks = [
            kmeans(np.ascontiguousarray(x[:, m * dsub:(m + 1) * dsub]),
                   self.ksub, KmeansParams(), Metric.L2,
                   device=self.device).centroids
            for m in range(self.M)]
        self.is_trained = True

    def add(self, x, ids=None):
        raise RuntimeError(
            "MultiIndexQuantizer: add does not make sense (IndexPQ.cpp)")

    def search(self, q: np.ndarray, k: int):
        """The k nearest product cells with their exact distances (the L2
        square splits over disjoint subspaces)."""
        assert self.is_trained
        q = np.asarray(q, np.float32)
        dsub = self.d // self.M
        dev = self.device
        total = None
        for m in range(self.M):
            sub = torch.as_tensor(np.ascontiguousarray(
                q[:, m * dsub:(m + 1) * dsub]), device=dev)
            t = pairwise_l2sqr(sub, torch.as_tensor(self.codebooks[m],
                                                    device=dev))
            total = t if total is None else (
                total[:, :, None] + t[:, None, :]).reshape(q.shape[0], -1)
        cells = torch.arange(total.shape[1], dtype=torch.int32,
                             device=dev).expand(total.shape)
        # k past the grid pads with inf and id -1
        vals, ids = topk_scores(total, cells, k, Metric.L2)
        return (vals.cpu().numpy().astype(np.float32),
                ids.cpu().numpy().astype(np.int64))

    def reconstruct(self, key: int) -> np.ndarray:
        """Product centroid of cell ``key`` (the first subspace is the most
        significant digit, IndexPQ.cpp MultiIndexQuantizer::reconstruct)."""
        out = np.empty(self.d, np.float32)
        dsub = self.d // self.M
        for m in reversed(range(self.M)):
            out[m * dsub:(m + 1) * dsub] = self.codebooks[m][key % self.ksub]
            key //= self.ksub
        return out

    def reset(self):
        pass  # nothing stored


class MultiIndexQuantizer2(MultiIndexQuantizer):
    """MIQ whose per-subspace ranking runs through given sub-indexes
    (reference ``MultiIndexQuantizer2``, IndexPQ.h:160), for example a
    ``FlatIndex`` each; the product is ranked over their shortlists only.
    Exact when the assign indexes are exact."""

    def __init__(self, d: int, M: int, nbits: int, assign_indexes: list,
                 device="cuda"):
        super().__init__(d, M, nbits, device=device)
        assert len(assign_indexes) == M
        self.assign_indexes = assign_indexes

    def train(self, x: np.ndarray) -> None:
        super().train(x)
        for m, sub in enumerate(self.assign_indexes):
            sub.reset()
            if not sub.is_trained:
                sub.train(self.codebooks[m])
            sub.add(self.codebooks[m])

    def search(self, q: np.ndarray, k: int):
        """A shortlist of max(k, 32) sub-centroids a subspace from the
        assign indexes, then the exact combination over their product (a
        stable sort on the host, as the JAX package ranks it)."""
        assert self.is_trained
        q = np.asarray(q, np.float32)
        B = q.shape[0]
        dsub = self.d // self.M
        kp = min(self.ksub, max(k, 32))
        dists, idxs = [], []
        for m, sub in enumerate(self.assign_indexes):
            dm, im = sub.search(
                np.ascontiguousarray(q[:, m * dsub:(m + 1) * dsub]), kp)
            dists.append(np.asarray(dm, np.float32))
            idxs.append(np.asarray(im, np.int64))
        total = dists[0]
        code = idxs[0]
        for dm, im in zip(dists[1:], idxs[1:]):
            total = (total[:, :, None] + dm[:, None, :]).reshape(B, -1)
            code = (code[:, :, None] * self.ksub
                    + im[:, None, :]).reshape(B, -1)
        order = np.argsort(total, axis=1, kind="stable")[:, :k]
        vals = np.take_along_axis(total, order, 1)
        ids = np.take_along_axis(code, order, 1)
        if k > vals.shape[1]:
            pad = k - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return vals, ids
