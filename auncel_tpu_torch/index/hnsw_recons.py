"""Reconstruct-from-neighbours refinement of HNSW storage (port of
``auncel_tpu/index/hnsw_recons.py``; reference ``ReconstructFromNeighbors``,
IndexHNSW.h:25-63, IndexHNSW.cpp:635-870).

Vector i is re-estimated as a weighted sum of the storage reconstructions
of i and its level-0 neighbours; the weights (M + 1 of them, M the level-0
cap) are chosen a segment of ``nsq`` from a k-row codebook, so each vector
stores ``nsq`` bytes. With compressed graph storage this tightens the
reconstructions: the neighbours carry what the vector's own code lost.
As in the JAX package, ``train_codebook`` fits the codebook (per-node
least-squares weights, clustered by k-means a segment; the reference
loads one trained elsewhere); the estimate, reconstruction and distance
paths are batched on the index's device.
"""

import numpy as np
import torch

from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans
from auncel_tpu_torch.types import Metric


class ReconstructFromNeighbors:
    def __init__(self, index, k: int = 256, nsq: int = 1):
        assert index.d % nsq == 0
        assert 1 <= k <= 256, "codes are one byte per segment"
        self.index = index
        self.k = int(k)
        self.nsq = int(nsq)
        self.M = 2 * index.M          # level-0 neighbour cap
        self.dsub = index.d // nsq
        self.code_size = nsq
        self.codebook: np.ndarray | None = None  # [nsq, k, M+1]
        self.codes = np.zeros((0, nsq), np.uint8)

    @property
    def ntotal(self) -> int:
        return int(self.codes.shape[0])

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.index.device)

    def get_neighbor_table(self, ids: np.ndarray) -> np.ndarray:
        """[n, M+1, d]: row 0 the node's storage reconstruction, rows 1..M
        its level-0 neighbours' (an absent link repeats the node, as the
        reference does: ``if (ji < 0) ji = i``)."""
        idx = self.index
        assert idx._built, "build the graph before reconstructing"
        ids = np.asarray(ids, np.int64)
        nbrs = idx.nb_tables[0][idx.g2u[0][ids]]         # [n, M] global ids
        nbrs = np.where(nbrs < 0, ids[:, None], nbrs)
        xb = idx._xb   # the host mirror: decoded storage reconstructions
        return np.concatenate([xb[ids][:, None, :], xb[nbrs]], 1)

    def train_codebook(self, x: np.ndarray,
                       ids: np.ndarray | None = None) -> None:
        """Fit the per-segment weight codebook on true vectors ``x`` of the
        stored nodes ``ids`` (default: the first len(x) nodes)."""
        x = np.asarray(x, np.float32)
        ids = (np.arange(len(x)) if ids is None
               else np.asarray(ids, np.int64))
        T = self.get_neighbor_table(ids)           # [n, M+1, d]
        n = len(ids)
        books = np.empty((self.nsq, self.k, self.M + 1), np.float32)
        for s in range(self.nsq):
            seg = slice(s * self.dsub, (s + 1) * self.dsub)
            A = T[:, :, seg]                        # [n, M+1, dsub]
            G = np.einsum("nid,njd->nij", A, A)
            G += 1e-4 * np.trace(G, axis1=1, axis2=2)[:, None, None] \
                * np.eye(self.M + 1)[None] / (self.M + 1)
            b = np.einsum("nid,nd->ni", A, x[:, seg])
            betas = np.linalg.solve(G, b[..., None])[..., 0] \
                .astype(np.float32)
            kk = min(self.k, n)
            cents = kmeans(betas, kk, KmeansParams(niter=10), Metric.L2,
                           device=self.index.device).centroids
            if kk < self.k:                          # pad duplicate rows
                cents = np.concatenate(
                    [cents, np.repeat(cents[:1], self.k - kk, 0)], 0)
            books[s] = cents
        self.codebook = books

    def add_codes(self, x: np.ndarray, ids: np.ndarray | None = None,
                  chunk: int = 8192) -> None:
        """The best codebook row a (node, segment) (reference estimate_code:
        the least reconstruction error, the first of equal ones)."""
        assert self.codebook is not None, "train_codebook first"
        x = np.asarray(x, np.float32)
        ids = (np.arange(self.ntotal, self.ntotal + len(x))
               if ids is None else np.asarray(ids, np.int64))
        books = self._t(self.codebook)
        out = np.empty((len(x), self.nsq), np.uint8)
        for c0 in range(0, len(x), chunk):
            c1 = min(c0 + chunk, len(x))
            T = self._t(self.get_neighbor_table(ids[c0:c1]))
            out[c0:c1] = _estimate(books, T, self._t(x[c0:c1]),
                                   self.nsq).cpu().numpy()
        self.codes = np.concatenate([self.codes, out], 0)

    def _recon(self, ids: np.ndarray, codes: np.ndarray) -> np.ndarray:
        return _reconstruct(self._t(self.codebook),
                            self._t(self.get_neighbor_table(ids)),
                            self._t(codes), self.nsq).cpu().numpy()

    def reconstruct_n(self, i0: int = 0, n: int | None = None,
                      chunk: int = 8192) -> np.ndarray:
        assert self.codebook is not None
        n = self.ntotal - i0 if n is None else n
        out = np.empty((n, self.index.d), np.float32)
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            out[c0:c1] = self._recon(np.arange(i0 + c0, i0 + c1),
                                     self.codes[i0 + c0:i0 + c1])
        return out

    def reconstruct(self, i: int) -> np.ndarray:
        return self.reconstruct_n(int(i), 1)[0]

    def compute_distances(self, q: np.ndarray,
                          shortlist: np.ndarray) -> np.ndarray:
        """Squared L2 distances of each query to its shortlist's refined
        reconstructions (reference compute_distances, the re-rank of
        IndexHNSW::search); inf at id -1."""
        q = np.asarray(q, np.float32)
        shortlist = np.asarray(shortlist, np.int64)
        B, K = shortlist.shape
        flat = shortlist.reshape(-1)
        ok = flat >= 0
        recon = np.zeros((flat.size, self.index.d), np.float32)
        if ok.any():
            recon[ok] = self._recon(flat[ok], self.codes[flat[ok]])
        recon = recon.reshape(B, K, -1)
        d = np.sum(np.square(q[:, None, :] - recon), -1)
        return np.where(ok.reshape(B, K), d, np.inf).astype(np.float32)


def _estimate(books, T, x, nsq: int) -> torch.Tensor:
    """argmin_k ||beta_k @ T_seg - x_seg||^2 a segment -> uint8 codes."""
    n, Mp1, d = T.shape
    dsub = d // nsq
    Ts = T.reshape(n, Mp1, nsq, dsub)
    xs = x.reshape(n, nsq, dsub)
    # [n, nsq, k, dsub] = [nsq, k, M+1] @ [n, M+1, nsq, dsub]
    rec = torch.einsum("ski,nisd->nskd", books, Ts)
    err = ((rec - xs[:, :, None, :]) ** 2).sum(-1)
    return err.argmin(-1).to(torch.uint8)


def _reconstruct(books, T, codes, nsq: int) -> torch.Tensor:
    n, Mp1, d = T.shape
    dsub = d // nsq
    Ts = T.reshape(n, Mp1, nsq, dsub)
    beta = books[torch.arange(nsq, device=T.device)[None, :], codes.long()]
    rec = torch.einsum("nsi,nisd->nsd", beta, Ts)
    return rec.reshape(n, d)
