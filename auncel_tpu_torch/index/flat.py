"""Flat indexes and the scalar-quantizer helpers (port of
``auncel_tpu/index/flat.py``).

The SQ helpers are numpy: the range is trained and the codes are packed on
the host, as the JAX package does; the scans decode on the device
(``ops/sq.py::sq_decode_dev`` and the kernels). The indexes: ``FlatIndex``
(exact k-NN through ``ops/knn.py``, range search), ``IndexRefineFlat``
(exact re-ranking of a base index's shortlist), ``IndexFlatL2BaseShift``,
``IndexFlat1D`` and ``IndexScalarQuantizer`` (SQ codes searched by the
blocked full scan of ``index/scan.py``). Each keeps its vectors or codes
on the host and searches on its device, the card unless the caller asks
for another.
"""

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.aux import RangeSearchResult
from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.ops.distance import pairwise_scores
from auncel_tpu_torch.ops.knn import (compute_distance_subset, knn,
                                      knn_l2sqr_base_shift)
from auncel_tpu_torch.types import Metric


def sq_levels(qtype: str) -> float:
    """Code levels per scalar-quantizer type (reference ScalarQuantizer
    QT_* families, IndexScalarQuantizer.h:34-41): sq8* -> 255, sq6 -> 63,
    sq4* -> 15."""
    if qtype.startswith("sq8"):
        return 255.0
    if qtype.startswith("sq6"):
        return 63.0
    return 15.0


def sq_code_width(d: int, qtype: str) -> int:
    """Packed byte width per vector: sq4 = d/2, sq6 = 3d/4, else d."""
    if qtype.startswith("sq4"):
        assert d % 2 == 0, "SQ4 needs an even dimension"
        return d // 2
    if qtype.startswith("sq6"):
        assert d % 4 == 0, "SQ6 needs d % 4 == 0"
        return d * 3 // 4
    return d


def sq_pack(codes: np.ndarray, qtype: str) -> np.ndarray:
    """uint8 per-dimension codes [n, d] -> packed storage bytes.
    sq4: two dims per byte, low nibble first. sq6: four dims per three
    bytes, a little-endian 24-bit group. The inverse is
    ``index/scan.py::sq_decode_dev``."""
    if qtype.startswith("sq4"):
        return codes[:, 0::2] | (codes[:, 1::2] << 4)
    if qtype.startswith("sq6"):
        d = codes.shape[1]
        g = codes.reshape(-1, d // 4, 4).astype(np.uint32)
        w = g[..., 0] | (g[..., 1] << 6) | (g[..., 2] << 12) \
            | (g[..., 3] << 18)
        out = np.stack([w & 255, (w >> 8) & 255, (w >> 16) & 255], -1)
        return out.reshape(-1, d // 4 * 3).astype(np.uint8)
    return codes


def sq_train_range(x: np.ndarray, qtype: str, rangestat: str = "minmax",
                   rangestat_arg: float = 0.0):
    """Affine SQ range from a training set -> (vmin [d], scale [d]) f32.

    ``rangestat`` follows the reference ScalarQuantizer::RangeStat
    (IndexScalarQuantizer.h:51-56): "minmax" = [min-rs*(max-min),
    max+rs*(max-min)], "meanstd" = [mean-rs*std, mean+rs*std],
    "quantiles" = [Q(rs), Q(1-rs)]. Uniform qtypes ("sq8u"/"sq4u")
    compute the statistic over the flattened set (one shared range)."""
    assert rangestat in ("minmax", "meanstd", "quantiles"), rangestat
    x = np.asarray(x, np.float32)
    d = x.shape[1]
    levels = sq_levels(qtype)
    xs = x.reshape(-1, 1) if qtype.endswith("u") else x
    rs = float(rangestat_arg)
    if rangestat == "meanstd":
        mu, sd = xs.mean(0), xs.std(0)
        rs = rs if rs > 0 else 1.0   # reference uses rs*std directly
        vmin, vmax = mu - sd * rs, mu + sd * rs
    elif rangestat == "quantiles":
        q = rs if rs > 0 else 0.01
        vmin = np.quantile(xs, q, axis=0)
        vmax = np.quantile(xs, 1.0 - q, axis=0)
    else:
        vmin, vmax = xs.min(0), xs.max(0)
        vmin, vmax = vmin - rs * (vmax - vmin), vmax + rs * (vmax - vmin)
    if qtype.endswith("u"):
        vmin = np.full(d, vmin[0], np.float32)
        vmax = np.full(d, vmax[0], np.float32)
    vmin = vmin.astype(np.float32)
    scale = np.maximum((vmax - vmin) / levels, 1e-10).astype(np.float32)
    return vmin, scale


def sq_encode(x: np.ndarray, vmin: np.ndarray, scale: np.ndarray,
              qtype: str, block: int = 1 << 20) -> np.ndarray:
    """Per-dimension codes [n, d] uint8 of ``x``: clip(rint((x - vmin) /
    scale), 0, levels), in f32 as the JAX package's ``_pack`` computes
    them, ``block`` rows at a time to bound the host's temporaries."""
    levels = sq_levels(qtype)
    out = np.empty(x.shape, np.uint8)
    for i in range(0, x.shape[0], block):
        out[i:i + block] = np.clip(np.rint((x[i:i + block] - vmin) / scale),
                                   0, levels)
    return out


# ---------------------------------------------------------------- indexes
# (port of auncel_tpu/index/flat.py:17-285, 362-501; the stored vectors and
# codes stay on the host, as the JAX package keeps them, and each search
# runs on the index's device)

def _xb_reconstruct(xb: np.ndarray, key: int) -> np.ndarray:
    """One stored row; a key out of range raises (numpy's negative indexing
    would return the last row)."""
    if not 0 <= key < xb.shape[0]:
        raise KeyError(f"id {key} not stored (ntotal={xb.shape[0]})")
    return xb[key].copy()


def _xb_reconstruct_batch(xb: np.ndarray, d: int,
                          keys: np.ndarray) -> np.ndarray:
    """Rows of an id array; negative keys give zeros."""
    keys = np.asarray(keys, np.int64).reshape(-1)
    if xb.shape[0] == 0:
        return np.zeros((keys.size, d), np.float32)
    out = xb[np.maximum(keys, 0)].copy()
    out[keys < 0] = 0.0
    return out


class FlatIndex(Index):
    """Exact k-NN over the stored vectors (reference ``IndexFlat``,
    IndexFlat.cpp:41-55) through ``ops/knn.py``: the coarse quantizer's
    building block, ground truth, and the tests' oracle."""
    # ids are storage positions
    position_keyed_ids = True

    def __init__(self, d: int, metric: Metric = Metric.L2, device="cuda"):
        self.d = d
        self.metric = Metric.parse(metric)
        self.device = resolve(device)
        self.is_trained = True
        self._xb = np.zeros((0, d), np.float32)

    @property
    def ntotal(self) -> int:
        return self._xb.shape[0]

    @property
    def xb(self) -> np.ndarray:
        return self._xb

    def train(self, x: np.ndarray) -> None:
        pass  # nothing to train (IndexFlat.h:21)

    def add(self, x: np.ndarray, ids=None) -> None:
        assert ids is None, "FlatIndex stores sequential ids"
        x = np.asarray(x, np.float32)
        assert x.shape[1] == self.d
        self._xb = np.concatenate([self._xb, x], axis=0)

    def search(self, q: np.ndarray, k: int):
        res = knn(q, self._xb, k, self.metric, device=self.device)
        return res.vals, res.ids.astype(np.int64)

    def reset(self) -> None:
        self._xb = np.zeros((0, self.d), np.float32)

    def reconstruct(self, key: int) -> np.ndarray:
        return _xb_reconstruct(self._xb, key)

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return self._xb[i0:i0 + n].copy()

    def reconstruct_batch(self, keys: np.ndarray) -> np.ndarray:
        return _xb_reconstruct_batch(self._xb, self.d, keys)

    def compute_distance_subset(self, q: np.ndarray,
                                labels: np.ndarray) -> np.ndarray:
        """Distances to each query's candidate rows, in label order
        (reference IndexFlat::compute_distance_subset); labels < 0 give the
        metric's worst value."""
        return compute_distance_subset(q, self._xb, labels, self.metric,
                                       device=self.device)

    def range_search(self, q: np.ndarray, radius: float,
                     block: int = 65536) -> RangeSearchResult:
        """Every stored vector within ``radius`` (reference
        IndexFlat::range_search: L2 squared distance < radius, IP score >
        radius), a block of the corpus at a time."""
        q = np.asarray(q, np.float32)
        nq = q.shape[0]
        qd = torch.as_tensor(q, device=self.device)
        all_q, all_l, all_d = [], [], []
        for j0 in range(0, self.ntotal, block):
            yb = torch.as_tensor(self._xb[j0:j0 + block], device=self.device)
            s = pairwise_scores(qd, yb, self.metric)
            hit = (s < radius) if self.metric.lower_is_better else (
                s > radius)
            qi, ji = hit.nonzero(as_tuple=True)   # row-major: qi sorted
            all_q.append(qi.cpu().numpy())
            all_l.append(j0 + ji.cpu().numpy())
            all_d.append(s[qi, ji].cpu().numpy())
        qi = np.concatenate(all_q) if all_q else np.zeros(0, np.int64)
        labels = (np.concatenate(all_l) if all_l
                  else np.zeros(0, np.int64)).astype(np.int64)
        dists = (np.concatenate(all_d) if all_d
                 else np.zeros(0, np.float32)).astype(np.float32)
        order = np.argsort(qi, kind="stable")   # group the hits by query
        lims = np.zeros(nq + 1, np.int64)
        np.cumsum(np.bincount(qi, minlength=nq), out=lims[1:])
        return RangeSearchResult(lims=lims, labels=labels[order],
                                 distances=dists[order])


class IndexRefineFlat(Index):
    """Re-rank a base index's shortlist with exact distances over the raw
    vectors (reference ``IndexRefineFlat``, IndexFlat.h:105-130): search
    the base for k * k_factor candidates, then rescore them on the host,
    as the JAX package does."""

    def __init__(self, base: Index, k_factor: float = 1.0):
        self.base = base
        self.d = base.d
        self.metric = base.metric
        self.k_factor = k_factor
        self._xb = np.zeros((0, self.d), np.float32)

    @property
    def ntotal(self) -> int:
        return self._xb.shape[0]

    @property
    def is_trained(self) -> bool:
        return self.base.is_trained

    @is_trained.setter
    def is_trained(self, v):  # the base owns its training state
        pass

    def train(self, x):
        self.base.train(x)

    def add(self, x, ids=None):
        assert ids is None, "IndexRefineFlat keeps sequential ids"
        x = np.asarray(x, np.float32)
        self.base.add(x)
        self._xb = np.concatenate([self._xb, x], 0)

    def reset(self):
        self.base.reset()
        self._xb = np.zeros((0, self.d), np.float32)

    def reconstruct(self, key: int) -> np.ndarray:
        return _xb_reconstruct(self._xb, key)

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return self._xb[i0:i0 + n].copy()

    def reconstruct_batch(self, keys: np.ndarray) -> np.ndarray:
        return _xb_reconstruct_batch(self._xb, self.d, keys)

    def search(self, q: np.ndarray, k: int, k_factor: float | None = None,
               **base_kwargs):
        q = np.asarray(q, np.float32)
        kf = k_factor if k_factor is not None else self.k_factor
        k_base = min(max(int(round(k * kf)), k), max(self.ntotal, k))
        _, ids = self.base.search(q, k_base, **base_kwargs)
        cand = self._xb[np.maximum(ids, 0)]              # [B, k_base, d]
        if self.metric.lower_is_better:
            dist = ((q[:, None, :] - cand) ** 2).sum(-1)
            dist = np.where(ids >= 0, dist, np.inf)
            order = np.argsort(dist, axis=1)[:, :k]
        else:
            dist = np.einsum("bkd,bd->bk", cand, q)
            dist = np.where(ids >= 0, dist, -np.inf)
            order = np.argsort(-dist, axis=1)[:, :k]
        return (np.take_along_axis(dist, order, 1),
                np.take_along_axis(ids, order, 1))


class IndexFlatL2BaseShift(FlatIndex):
    """Flat L2 whose distances carry a per-row additive shift (reference
    IndexFlatL2BaseShift, IndexFlat.h:53-66)."""

    def __init__(self, d: int, shift: np.ndarray | None = None,
                 device="cuda"):
        super().__init__(d, Metric.L2, device=device)
        self.shift = (np.asarray(shift, np.float32) if shift is not None
                      else np.zeros(0, np.float32))

    def add(self, x, ids=None, shift: np.ndarray | None = None):
        n = np.asarray(x).shape[0]
        super().add(x, ids)
        s = (np.asarray(shift, np.float32) if shift is not None
             else np.zeros(n, np.float32))
        assert s.shape[0] == n
        self.shift = np.concatenate([self.shift, s])

    def search(self, q, k: int):
        res = knn_l2sqr_base_shift(q, self._xb, k, self.shift,
                                   device=self.device)
        return res.vals, res.ids.astype(np.int64)


class IndexFlat1D(Index):
    """The 1-d flat index (reference IndexFlat1D, IndexFlat.h:134): values
    kept sorted; a search is one searchsorted and a top-k over the window
    of 2k values around each query. Host code, as in the JAX package."""

    def __init__(self):
        self.d = 1
        self.metric = Metric.L2
        self.is_trained = True
        self._vals = np.zeros(0, np.float32)
        self._ids = np.zeros(0, np.int64)
        self._sorted = False

    @property
    def ntotal(self) -> int:
        return self._vals.shape[0]

    def train(self, x):
        pass

    def add(self, x, ids=None):
        x = np.asarray(x, np.float32).reshape(-1)
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + x.size,
                            dtype=np.int64)
        self._vals = np.concatenate([self._vals, x])
        self._ids = np.concatenate([self._ids, np.asarray(ids, np.int64)])
        self._sorted = False

    def update_permutation(self):
        order = np.argsort(self._vals, kind="stable")
        self._vals = self._vals[order]
        self._ids = self._ids[order]
        self._sorted = True

    def search(self, q, k: int):
        if not self._sorted:
            self.update_permutation()
        q = np.asarray(q, np.float32).reshape(-1)
        n = self.ntotal
        k_eff = min(k, n)
        pos = np.searchsorted(self._vals, q)
        offs = np.arange(-k_eff, k_eff)
        raw = pos[:, None] + offs[None, :]
        valid = (raw >= 0) & (raw < n)   # clipped slots would repeat
        win = np.clip(raw, 0, max(n - 1, 0))
        cand = self._vals[win]
        d = np.where(valid, (cand - q[:, None]) ** 2, np.inf)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        vals = np.take_along_axis(d, order, 1)
        ids = np.where(np.isinf(vals), -1,
                       self._ids[np.take_along_axis(win, order, 1)])
        if k > n:
            pad = k - n
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return vals.astype(np.float32), ids

    def reset(self):
        self._vals = np.zeros(0, np.float32)
        self._ids = np.zeros(0, np.int64)
        self._sorted = False


class IndexScalarQuantizer(Index):
    """Scalar-quantized flat index (reference ``IndexScalarQuantizer``,
    IndexScalarQuantizer.h:92): the corpus stored as SQ codes and searched
    by an exhaustive decode and compare. As in the JAX package, the codes
    are packed into ``ROW_CAP``-wide rows of an ``IVFArrays`` and searched
    with the blocked full scan (``index/scan.py::ivf_full_scan``), each
    block decoded through the shared codec. ``qtype``: "sq8"/"sq4"
    (per-dimension range), "sq8u"/"sq4u" (one range), "sq6", "sq8d"
    (identity affine) or "bf16"."""

    position_keyed_ids = True
    ROW_CAP = 512

    def __init__(self, d: int, qtype: str = "sq8",
                 metric: Metric = Metric.L2, rangestat: str = "minmax",
                 rangestat_arg: float = 0.0, device="cuda"):
        assert qtype in ("sq8", "sq4", "sq8u", "sq4u", "sq6", "sq8d",
                         "bf16"), qtype
        sq_code_width(d, qtype)  # the d divisibility check
        assert rangestat in ("minmax", "meanstd", "quantiles"), rangestat
        self.rangestat = rangestat
        self.rangestat_arg = float(rangestat_arg)
        self.d = d
        self.qtype = qtype
        self.metric = Metric.parse(metric)
        self.device = resolve(device)
        # bf16 and 8bit_direct need no training (direct: identity affine)
        self.is_trained = qtype in ("bf16", "sq8d")
        self._scale = np.ones(d, np.float32) if qtype == "sq8d" else None
        self._vmin = np.zeros(d, np.float32) if qtype == "sq8d" else None
        self._codes = None       # host [n, width] codes (bf16: a tensor)
        self._arrays = None

    @property
    def ntotal(self) -> int:
        return 0 if self._codes is None else self._codes.shape[0]

    def train(self, x: np.ndarray) -> None:
        """The affine range of the training set (the reference's
        ScalarQuantizer::train RangeStat)."""
        if self.qtype in ("bf16", "sq8d"):
            return
        self._vmin, self._scale = sq_train_range(
            x, self.qtype, self.rangestat, self.rangestat_arg)
        self.is_trained = True

    def _encode(self, x: np.ndarray):
        if self.qtype == "bf16":
            return torch.as_tensor(x).to(torch.bfloat16)
        return sq_pack(sq_encode(x, self._vmin, self._scale, self.qtype),
                       self.qtype)

    def add(self, x: np.ndarray, ids=None) -> None:
        assert ids is None, "IndexScalarQuantizer stores sequential ids"
        assert self.is_trained, "train before add"
        codes = self._encode(np.asarray(x, np.float32))
        if self._codes is None:
            self._codes = codes
        elif self.qtype == "bf16":
            self._codes = torch.cat([self._codes, codes])
        else:
            self._codes = np.concatenate([self._codes, codes])
        self._arrays = None

    def _pack(self):
        """The rows-of-codes IVFArrays of the blocked full scan."""
        from auncel_tpu_torch.index.scan import IVFArrays
        if self._arrays is not None:
            return self._arrays
        dev = self.device
        n, rc = self.ntotal, self.ROW_CAP
        n_rows = max(-(-n // rc), 1)
        n_rows = ((n_rows + 7) // 8) * 8
        bf16 = self.qtype == "bf16"
        width = self.d if bf16 else sq_code_width(self.d, self.qtype)
        db = torch.zeros((n_rows * rc, width),
                         dtype=torch.bfloat16 if bf16 else torch.uint8)
        if n:
            db[:n] = torch.as_tensor(self._codes)
        vec_ids = torch.full((n_rows * rc,), -1, dtype=torch.int32)
        vec_ids[:n] = torch.arange(n, dtype=torch.int32)
        a = IVFArrays(
            centroids=torch.zeros((n_rows, self.d), device=dev),
            cent_sq=torch.zeros((n_rows,), device=dev),
            db=db.reshape(n_rows, rc, width).to(dev),
            db_sq=torch.zeros((n_rows, rc), device=dev),
            vec_ids=vec_ids.reshape(n_rows, rc).to(dev),
            list_sizes=torch.zeros((n_rows,), dtype=torch.int32, device=dev),
            interdis=torch.zeros((1, 1), device=dev),
            sq_scale=None if bf16 else torch.as_tensor(self._scale,
                                                       device=dev),
            sq_bias=None if bf16 else torch.as_tensor(self._vmin,
                                                      device=dev))
        # decoded norms, zero at the padding (which decodes to the bias)
        dec = a.decode_block(a.db)
        self._arrays = a._replace(db_sq=torch.where(
            a.vec_ids >= 0, (dec * dec).sum(-1), 0.0))
        return self._arrays

    def search(self, q: np.ndarray, k: int):
        from auncel_tpu_torch.index.scan import ivf_full_scan
        a = self._pack()
        qd = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        vals, ids = ivf_full_scan(a, qd, k, self.metric)
        return vals.cpu().numpy(), ids.cpu().numpy().astype(np.int64)

    def reconstruct(self, key: int) -> np.ndarray:
        a = self._pack()
        rc = self.ROW_CAP
        blk = a.db[key // rc, key % rc][None, None]
        return a.decode_block(blk).cpu().numpy()[0, 0]

    def reset(self) -> None:
        self._codes = None
        self._arrays = None
