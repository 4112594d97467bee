"""Product quantization (port of ``auncel_tpu/ops/pq.py``).

The vector space is split into M subspaces of d/M dims, each with its own
256-entry codebook trained by k-means; a vector is stored as M uint8
codes. The distance to a code is the exact distance to its reconstruction
(the subspaces partition the dimensions), so the scans decode the codes
and contract the reconstructions with the queries: K2 decodes them in its
ring (``kernels/scan_scores.py``), the dense passes a block at a time.

Residual encoding (``IVFFlatIndex(storage="pqM", pq_residual=True)``)
lives in the IVF layer: codes approximate ``x - centroid[list]`` and the
scans carry the probed list's centroid through the distance
(``index/scan.py``).
"""

from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans

KSUB = 256  # codes per subspace (uint8)

# rows encoded at a time: the [rows, M, KSUB] distance table stays a few
# tens of MB
ENCODE_BLOCK = 2048


class PQCodebooks(NamedTuple):
    codebooks: torch.Tensor  # [M, KSUB, dsub] float32

    @property
    def M(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]


def train_pq(x: np.ndarray, M: int, niter: int = 15, seed: int = 1234,
             device="cuda") -> PQCodebooks:
    """Train M per-subspace codebooks by k-means (the JAX package's seeds:
    ``seed + m`` for subspace m, no balancing) on ``device``."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    assert d % M == 0, f"d={d} must be divisible by M={M}"
    dsub = d // M
    books = np.empty((M, KSUB, dsub), np.float32)
    for m in range(M):
        sub = np.ascontiguousarray(x[:, m * dsub:(m + 1) * dsub])
        res = kmeans(sub, KSUB, KmeansParams(niter=niter, seed=seed + m,
                                             balance_iters=0),
                     device=device)
        books[m] = res.centroids
    return PQCodebooks(torch.as_tensor(books, device=resolve(device)))


def encode_pq(pq: PQCodebooks, x: torch.Tensor) -> torch.Tensor:
    """[n, d] -> [n, M] uint8 codes: per subspace the argmin over the
    codewords of ``c_sq - 2 * dot`` (the query norm is rank-invariant),
    fp32 with no TF32, ENCODE_BLOCK rows at a time."""
    n, d = x.shape
    books = pq.codebooks
    M, _, dsub = books.shape
    c_sq = (books * books).sum(-1)                        # [M, KSUB]
    out = torch.empty((n, M), dtype=torch.uint8, device=x.device)
    for i in range(0, n, ENCODE_BLOCK):
        xs = x[i:i + ENCODE_BLOCK].reshape(-1, M, dsub).transpose(0, 1)
        # c_sq - 2 * dots in one product: 2 * dot is exact, so this is the
        # JAX package's c_sq[None] - 2.0 * dots rounded once
        dist = torch.baddbmm(c_sq[:, None, :], xs, books.transpose(1, 2),
                             alpha=-2.0)                   # [M, rows, KSUB]
        out[i:i + ENCODE_BLOCK] = dist.argmin(-1).T.to(torch.uint8)
    return out


def decode_pq(pq: PQCodebooks, codes: torch.Tensor) -> torch.Tensor:
    """[..., M] uint8 -> [..., d] reconstructions: a gather of codebook
    rows, so bitwise the JAX package's values."""
    books = pq.codebooks
    M, _, dsub = books.shape
    offs = torch.arange(M, dtype=torch.long, device=codes.device) * KSUB
    rec = books.reshape(M * KSUB, dsub)[codes.long() + offs]  # [..., M, ds]
    return rec.reshape(codes.shape[:-1] + (M * dsub,))
