"""Flat two-level codes: a coarse centroid id and the PQ code of the
residual to it (port of ``auncel_tpu/index/twolayer.py``; reference
``Index2Layer``, IndexIVFPQ.h:199-260: "same as an IndexIVFPQ without the
inverted lists").

Each stored vector is (list id, PQ code of ``x - centroid[id]``) and
reconstructs as ``centroid[id] + pq_decode(code)``. ``transfer_to_ivfpq``
moves the codes into the inverted lists of a residual-PQ ``IVFFlatIndex``
without encoding again (K2 then scans them), and ``search`` is an exact
scan of the decoded reconstructions (the reference leaves it
unimplemented, IndexIVFPQ.h:233; the JAX package provides it).
"""

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans
from auncel_tpu_torch.ops.knn import knn
from auncel_tpu_torch.ops.pq import decode_pq, encode_pq, train_pq
from auncel_tpu_torch.types import Metric


class Index2Layer(Index):
    def __init__(self, d: int, nlist: int, M: int = 8,
                 metric: Metric = Metric.L2,
                 kmeans_params: KmeansParams | None = None,
                 quantizer=None, device="cuda"):
        """``quantizer``: an optional coarse index with ``assign(x)`` and
        ``centroids`` (the reference takes any first-level quantizer, e.g.
        a MultiIndexQuantizer for "HNSW%d_2x%d+PQ%d",
        AutoTune.cpp:893-899)."""
        assert d % M == 0
        self.d = d
        self.nlist = int(nlist)
        self.M = int(M)
        self.metric = Metric.parse(metric)
        self.kmeans_params = kmeans_params or KmeansParams()
        self.quantizer = quantizer
        self.device = resolve(device)
        self.centroids: np.ndarray | None = None
        self._pq = None
        self.list_ids = np.zeros((0,), np.int32)   # code_size_1 payload
        self.codes = np.zeros((0, M), np.uint8)    # code_size_2 payload
        self.is_trained = False

    @property
    def ntotal(self) -> int:
        return int(self.list_ids.shape[0])

    # the reference's code sizes (IndexIVFPQ.h:215-221)
    @property
    def code_size_1(self) -> int:
        size = 1
        while self.nlist > (1 << (8 * size)):
            size += 1
        return size

    @property
    def code_size_2(self) -> int:
        return self.M

    @property
    def code_size(self) -> int:
        return self.code_size_1 + self.code_size_2

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        if self.quantizer is not None:
            if getattr(self.quantizer, "centroids", None) is None:
                self.quantizer.train(x)
            cents = np.asarray(self.quantizer.centroids, np.float32)
            assert cents.shape[0] == self.nlist
            self.centroids = cents
        else:
            self.centroids = kmeans(x, self.nlist, self.kmeans_params,
                                    self.metric,
                                    device=self.device).centroids
        resid = x - self.centroids[self._assign(x)]
        self._pq = train_pq(resid[:200_000], self.M, device=self.device)
        self.is_trained = True

    def _assign(self, x: np.ndarray) -> np.ndarray:
        if self.quantizer is not None:
            return np.asarray(self.quantizer.assign(x), np.int64)
        res = knn(x, self.centroids, 1, self.metric, q_block=65536,
                  device=self.device)
        return res.ids[:, 0].astype(np.int64)

    def add(self, x: np.ndarray, ids=None) -> None:
        assert self.is_trained, "train before add"
        x = np.asarray(x, np.float32)
        assign = self._assign(x)
        resid = x - self.centroids[assign]
        codes = encode_pq(self._pq, torch.as_tensor(resid,
                                                    device=self.device))
        self.list_ids = np.concatenate(
            [self.list_ids, assign.astype(np.int32)], 0)
        self.codes = np.concatenate([self.codes, codes.cpu().numpy()], 0)

    def reset(self) -> None:
        self.list_ids = np.zeros((0,), np.int32)
        self.codes = np.zeros((0, self.M), np.uint8)

    def reconstruct_n(self, i0: int = 0, n: int | None = None) -> np.ndarray:
        n = self.ntotal - i0 if n is None else n
        sl = slice(i0, i0 + n)
        dec = decode_pq(self._pq, torch.as_tensor(
            self.codes[sl], device=self.device)).cpu().numpy()
        return self.centroids[self.list_ids[sl]] + dec

    def reconstruct(self, key: int) -> np.ndarray:
        return self.reconstruct_n(int(key), 1)[0]

    def search(self, q: np.ndarray, k: int):
        """Exact scan over the decoded reconstructions (see the module
        docstring)."""
        res = knn(np.asarray(q, np.float32), self.reconstruct_n(), k,
                  self.metric, device=self.device)
        return res.vals, res.ids.astype(np.int64)

    def transfer_to_ivfpq(self):
        """The codes moved into inverted lists without encoding again
        (reference transfer_to_IVFPQ, IndexIVFPQ.cpp): a residual-PQ
        IVFFlatIndex whose packed arrays hold exactly these codes (cap =
        the largest list, ids = the positions here), so its
        reconstructions are bitwise ``reconstruct_n``'s and K2 serves
        it."""
        from auncel_tpu_torch.index.ivf import IVFFlatIndex, _decoded_norms
        from auncel_tpu_torch.index.scan import IVFArrays
        from auncel_tpu_torch.ops.distance import sqnorms
        dev = self.device
        idx = IVFFlatIndex(self.d, self.nlist, metric=self.metric,
                           storage=f"pq{self.M}", pq_residual=True,
                           device=dev)
        idx.set_centroids(self.centroids)
        n = self.ntotal
        assign = self.list_ids.astype(np.int64)
        sizes = np.bincount(assign, minlength=self.nlist).astype(np.int64)
        cap = max(int(sizes.max()) if n else 1, 1)
        order = np.argsort(assign, kind="stable")
        starts = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        slot = np.empty(n, np.int64)
        slot[order] = np.arange(n) - starts[assign[order]]
        db = np.zeros((self.nlist, cap, self.M), np.uint8)
        vec_ids = np.full((self.nlist, cap), -1, np.int32)
        db[assign, slot] = self.codes
        vec_ids[assign, slot] = np.arange(n, dtype=np.int32)
        cents = torch.as_tensor(self.centroids, device=dev)
        arrays = IVFArrays(
            centroids=cents, cent_sq=sqnorms(cents),
            db=torch.as_tensor(db, device=dev), db_sq=None,
            vec_ids=torch.as_tensor(vec_ids, device=dev),
            list_sizes=torch.as_tensor(sizes.astype(np.int32), device=dev),
            interdis=torch.as_tensor(
                idx.interdis if idx.interdis is not None
                else np.zeros((1, 1), np.float32), device=dev),
            pq_codebooks=self._pq.codebooks, pq_residual=True)
        # the decoded residuals' norms, zero at padding
        idx._arrays = arrays._replace(db_sq=_decoded_norms(arrays))
        idx._ntotal = n
        return idx


class IMICoarseQuantizer:
    """Inverted-multi-index product cells as an Index2Layer first-level
    quantizer (the reference's "HNSW%d_2x%d+PQ%d" cell builds Index2Layer
    over a MultiIndexQuantizer, AutoTune.cpp:893-899); the product
    centroids are materialised (nlist = 4^nbit rows, ``index/imi.py``)."""

    def __init__(self, d: int, nbit: int, metric: Metric = Metric.L2,
                 device="cuda"):
        self.d = d
        self.nbit = int(nbit)
        self.nlist = (1 << nbit) ** 2
        self.metric = Metric.parse(metric)
        self.device = resolve(device)
        self.centroids: np.ndarray | None = None

    def train(self, x: np.ndarray) -> None:
        from auncel_tpu_torch.index.imi import train_imi_centroids
        self.centroids = train_imi_centroids(
            np.asarray(x, np.float32), self.nlist, self.metric,
            device=self.device)

    def assign(self, x: np.ndarray) -> np.ndarray:
        from auncel_tpu_torch.index.imi import imi_assign
        return imi_assign(np.asarray(x, np.float32), self.centroids,
                          device=self.device)
