"""Locality-sensitive hashing indexes (port of ``auncel_tpu/index/lsh.py``;
the reference's ``IndexLSH``, IndexLSH.h:21, and
``IndexIVFSpectralHash``, IndexIVFSpectralHash.h:30).

``IndexLSH``: the sign of each (optionally rotated, optionally
thresholded) component is one bit; search is Hamming over the bits.
``IVFSpectralHashIndex``: IVF whose codes are period-quantized parity bits
of the rotated vector relative to a per-list threshold
(binarize_with_freq, IndexIVFSpectralHash.cpp:143: bit_j =
floor((x_j - c_j) * 2/period) & 1).

The stored codes are computed on the host in numpy, as the JAX package
computes them, so both packages store the same bits. Search runs on the
index's device: the Hamming products of {0, 1} planes in fp32 (exact), the
spectral hash's per-list binarisation of the query's projection (projected
on the host, as in the JAX package) and a stable top-k, so ties keep the
first position, as ``lax.top_k`` does. The spectral-hash scan gathers
[B, nprobe, cap, nbit] planes, so it runs a chunk of queries at a time.
"""

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.index.binary import hamming_topk, pack_bits
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans
from auncel_tpu_torch.ops.topk import topk_scores
from auncel_tpu_torch.types import Metric

# gathered plane elements a spectral-hash scan step
SH_BLOCK = 1 << 26


def _assign_lists(x: np.ndarray, centroids: np.ndarray,
                  chunk: int = 8192) -> np.ndarray:
    """Nearest-centroid assignment on the host, chunked (a copy of the JAX
    package's, so the stored lists are the same)."""
    out = np.empty(x.shape[0], np.int64)
    c_sq = (centroids ** 2).sum(1)
    for i0 in range(0, x.shape[0], chunk):
        xb = x[i0:i0 + chunk]
        d2 = (xb ** 2).sum(1)[:, None] + c_sq[None] - 2.0 * xb @ centroids.T
        out[i0:i0 + chunk] = np.argmin(d2, axis=1)
    return out


def random_rotation(d: int, nbits: int, seed: int = 1234) -> np.ndarray:
    """[d, nbits] projection of orthonormal d-blocks (the reference's
    RandomRotationMatrix(d, nbits): random orthogonal, repeated blockwise
    when nbits > d); numpy, so both packages draw the same matrix."""
    rng = np.random.RandomState(seed)
    cols = []
    got = 0
    while got < nbits:
        q, _ = np.linalg.qr(rng.randn(d, d))
        take = min(d, nbits - got)
        cols.append(q[:, :take])
        got += take
    return np.concatenate(cols, axis=1).astype(np.float32)


class IndexLSH(Index):
    """Sign-bit signatures of (rotated, thresholded) inputs; Hamming search
    (reference IndexLSH.cpp:29-130). Distances come back as float32."""

    def __init__(self, d: int, nbits: int, rotate_data: bool = True,
                 train_thresholds: bool = False, seed: int = 1234,
                 device="cuda"):
        self.d = d
        self.nbits = int(nbits)
        self.rotate_data = rotate_data
        self.train_thresholds = train_thresholds
        self.metric = Metric.L2  # Hamming, reported like the reference
        self.device = resolve(device)
        self.rrot = (random_rotation(d, self.nbits, seed)
                     if rotate_data else None)
        if not rotate_data:
            assert self.nbits <= d, "without rotation, nbits <= d"
        self.thresholds = np.zeros(self.nbits, np.float32)
        self.is_trained = not train_thresholds
        self._bits = np.zeros((0, self.nbits), np.int8)
        self._dev = None

    @property
    def ntotal(self) -> int:
        return self._bits.shape[0]

    @property
    def codes(self) -> np.ndarray:
        """Packed uint8 signatures."""
        return pack_bits(self._bits.astype(np.uint8))

    def _project(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self.rrot is not None:
            return x @ self.rrot
        return x[:, : self.nbits]

    def train(self, x: np.ndarray) -> None:
        if self.train_thresholds:
            # per-bit median (IndexLSH.cpp:85-110)
            self.thresholds = np.median(self._project(x),
                                        axis=0).astype(np.float32)
        self.is_trained = True

    def _encode(self, x: np.ndarray) -> np.ndarray:
        return (self._project(x) > self.thresholds).astype(np.int8)

    def add(self, x: np.ndarray, ids=None) -> None:
        assert ids is None and self.is_trained
        self._bits = np.concatenate([self._bits, self._encode(x)], 0)
        self._dev = None

    def search(self, q: np.ndarray, k: int):
        if self._dev is None:
            b = torch.as_tensor(self._bits, device=self.device).to(
                torch.float32)
            self._dev = (b, b.sum(1))
        db, pop = self._dev
        qb = torch.as_tensor(self._encode(q), device=self.device).to(
            torch.float32)
        vals, ids = hamming_topk(qb, db, pop, k)
        return vals.cpu().numpy(), ids.cpu().numpy().astype(np.int64)

    def reset(self) -> None:
        self._bits = np.zeros((0, self.nbits), np.int8)
        self._dev = None


def _sh_search(cents, cent_sq, db, db_ids, trained, q, qproj,
               freq: float, k: int, nprobe: int):
    """The spectral-hash scan of a batch of queries: rank the float
    centroids, binarise each query's projection against each probed
    list's threshold vector, Hamming-score the list's stored planes and
    take the top-k over all probed slots."""
    B = q.shape[0]
    # not clamped at 0, as the JAX package ranks the centroids
    scores = sqnorms(q)[:, None] + cent_sq[None] - 2.0 * (q @ cents.T)
    ids = torch.arange(cents.shape[0], dtype=torch.int32,
                       device=q.device).expand(scores.shape)
    _, lists = topk_scores(scores, ids, nprobe, Metric.L2)
    lists = lists.long()                                  # [B, P]
    c = trained[lists]                                    # [B, P, nbit]
    qb = (torch.floor((qproj[:, None, :] - c) * freq).to(torch.int32)
          & 1).to(torch.float32)
    planes = db[lists]                                    # [B, P, cap, nbit]
    sid = db_ids[lists]                                   # [B, P, cap]
    dots = torch.einsum("bpcn,bpn->bpc", planes, qb)
    ham = qb.sum(-1)[:, :, None] + planes.sum(-1) - 2.0 * dots
    ham = torch.where(sid >= 0, ham, float("inf"))
    P, cap = lists.shape[1], db.shape[1]
    return topk_scores(ham.reshape(B, P * cap), sid.reshape(B, P * cap), k,
                       Metric.L2)


class IVFSpectralHashIndex(Index):
    """IVF over period-quantized spectral-hash codes (reference
    IndexIVFSpectralHash.{h,cpp}); threshold_type "global",
    "centroid", "centroid_half" (the reference's default) or "median"."""

    def __init__(self, d: int, nlist: int, nbit: int,
                 period: float | None = None,
                 threshold_type: str = "centroid_half", seed: int = 1234,
                 device="cuda"):
        self.d = d
        self.nlist = nlist
        self.nbit = int(nbit)
        # None: 8x the projected residual std, estimated at train time (the
        # JAX package's measured recall peak; the reference leaves the
        # period to the caller)
        self.period = None if period is None else float(period)
        self.threshold_type = threshold_type
        self.metric = Metric.L2
        self.device = resolve(device)
        self.rrot = random_rotation(d, self.nbit, seed)
        self.centroids: np.ndarray | None = None
        self.trained: np.ndarray | None = None   # [nlist, nbit]
        self.is_trained = False
        self._pending: list = []
        self._packed = None
        self.nprobe = 1

    @property
    def ntotal(self) -> int:
        return sum(x.shape[0] for x, _ in self._pending)

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        res = kmeans(x, self.nlist, KmeansParams(), device=self.device)
        self.set_centroids(x, res.centroids)

    def set_centroids(self, x: np.ndarray, centroids: np.ndarray) -> None:
        """Install trained coarse centroids and train the thresholds (and
        the period, when not given) on ``x``: ``train`` after its
        k-means."""
        x = np.asarray(x, np.float32)
        self.centroids = np.array(centroids, np.float32)
        proj_c = self.centroids @ self.rrot
        if self.period is None:
            assign = _assign_lists(x, self.centroids)
            resid = (x - self.centroids[assign]) @ self.rrot
            self.period = float(8.0 * max(resid.std(), 1e-6))
        if self.threshold_type == "global":
            self.trained = np.zeros((self.nlist, self.nbit), np.float32)
        elif self.threshold_type in ("centroid", "centroid_half"):
            self.trained = proj_c.astype(np.float32)
            if self.threshold_type == "centroid_half":
                self.trained = self.trained - 0.25 * self.period
        elif self.threshold_type == "median":
            # per-list median of the projected training points
            assign = _assign_lists(x, self.centroids)
            proj = x @ self.rrot
            self.trained = np.array(proj_c, np.float32)
            for l in range(self.nlist):
                sel = proj[assign == l]
                if sel.shape[0]:
                    self.trained[l] = np.median(sel, axis=0)
        else:
            raise ValueError(self.threshold_type)
        self.is_trained = True
        self._packed = None

    def add(self, x: np.ndarray, ids=None) -> None:
        assert self.is_trained
        x = np.asarray(x, np.float32)
        base = self.ntotal
        vid = (np.arange(base, base + x.shape[0], dtype=np.int64)
               if ids is None else np.asarray(ids, np.int64))
        self._pending.append((x, vid))
        self._packed = None

    def _encode(self, proj: np.ndarray, lists: np.ndarray) -> np.ndarray:
        freq = 2.0 / self.period
        c = self.trained[lists]
        return (np.floor((proj - c) * freq).astype(np.int64) & 1
                ).astype(np.int8)

    def _build(self):
        """Encode on the host, then lay the lists out padded on the device
        (each list's vectors in the order they were added)."""
        if self._packed is not None:
            return
        if not self._pending:
            # an empty trained index: one all-padding list, so search
            # gives (-1, inf) instead of failing
            self._pending.append((np.zeros((0, self.d), np.float32),
                                  np.zeros((0,), np.int64)))
        x = np.concatenate([p for p, _ in self._pending], 0)
        vids = np.concatenate([v for _, v in self._pending], 0)
        assign = _assign_lists(x, self.centroids)
        bits = self._encode(x @ self.rrot, assign)
        sizes = np.bincount(assign, minlength=self.nlist)
        cap = max(int(sizes.max()), 1)
        order = np.argsort(assign, kind="stable")
        starts = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        slot = np.empty(len(assign), np.int64)
        slot[order] = np.arange(len(assign)) - starts[assign[order]]
        db = np.zeros((self.nlist, cap, self.nbit), np.int8)
        dbi = np.full((self.nlist, cap), -1, np.int32)
        db[assign, slot] = bits
        dbi[assign, slot] = vids
        dev = self.device
        cents = torch.as_tensor(self.centroids, device=dev)
        self._packed = (cents, sqnorms(cents),
                        torch.as_tensor(db, device=dev).to(torch.float32),
                        torch.as_tensor(dbi, device=dev),
                        torch.as_tensor(self.trained, device=dev))

    def search(self, q: np.ndarray, k: int, nprobe: int | None = None):
        self._build()
        nprobe = min(int(nprobe or self.nprobe), self.nlist)
        cents, cent_sq, db, dbi, trained = self._packed
        q = np.asarray(q, np.float32)
        qproj = q @ self.rrot   # on the host, as the JAX package projects
        freq = float(np.float32(2.0 / self.period))
        dev = self.device
        step = max(1, SH_BLOCK // (nprobe * db.shape[1] * self.nbit))
        vals, ids = [], []
        for q0 in range(0, q.shape[0], step):
            v, i = _sh_search(cents, cent_sq, db, dbi, trained,
                              torch.as_tensor(q[q0:q0 + step], device=dev),
                              torch.as_tensor(qproj[q0:q0 + step],
                                              device=dev),
                              freq, k, nprobe)
            vals.append(v.cpu().numpy())
            ids.append(i.cpu().numpy())
        return (np.concatenate(vals) if vals else
                np.zeros((0, k), np.float32),
                np.concatenate(ids).astype(np.int64) if ids else
                np.zeros((0, k), np.int64))

    def reset(self) -> None:
        self._pending = []
        self._packed = None
