"""IVF-Flat index (port of ``auncel_tpu/index/ivf.py``, float32 storage).

Lists are packed into a padded ``[nlist, cap, d]`` tensor on ``device``
(cap = the largest list, rounded up to 8; pad slots carry id -1), and
``enable_multirow`` keeps the tight row layout the bounded engine scans.
Not ported yet: the SQ/PQ/bf16 codecs, the IMI and HNSW coarse
quantizers, the dense-scan crossover, ``max_codes``, reconstruction and
updates; each raises ``NotImplementedError``.
"""

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.scan import (
    IVFArrays, coarse_rank, ivf_full_scan, scan_probe_range)
from auncel_tpu_torch.index.multirow import (
    MultiRowArrays, build_multirow, multirow_search_fixed)
from auncel_tpu_torch.ops.distance import (
    pairwise_ip, pairwise_l2sqr, pairwise_scores, sqnorms)
from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans
from auncel_tpu_torch.ops.topk import init_topk, topk_scores


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_interdis(centroids: np.ndarray, metric: Metric,
                     device="cpu") -> np.ndarray:
    """All-pairs centroid matrix: L2 squared distances, or for IP the
    angles arccos(<ci, cj>) of the normalised centroids; zero diagonal."""
    c = torch.as_tensor(np.asarray(centroids, np.float32),
                        device=resolve(device))
    if metric is Metric.L2:
        m = pairwise_l2sqr(c, c)
    else:
        cn = c / sqnorms(c).clamp_min(1e-20).sqrt()[:, None]
        m = torch.arccos(pairwise_ip(cn, cn).clamp(-1.0, 1.0))
    m.fill_diagonal_(0.0)
    return m.cpu().numpy()


def _assign_topk(x: torch.Tensor, centroids: torch.Tensor,
                 cent_sq: torch.Tensor, k: int, metric: Metric
                 ) -> torch.Tensor:
    """Top-k nearest centroids of every row, [n, k] int32."""
    block = 65536
    nlist = centroids.shape[0]
    ids = torch.arange(nlist, dtype=torch.int32, device=x.device)
    out = []
    for i in range(0, x.shape[0], block):
        s = pairwise_scores(x[i:i + block], centroids, metric,
                            y_sqnorms=cent_sq)
        out.append(topk_scores(s, ids.expand(s.shape), k, metric)[1])
    return torch.cat(out)


class IVFFlatIndex:
    INTERDIS_EAGER_MAX = 4096

    def __init__(self, d: int, nlist: int, metric: Metric = Metric.L2,
                 device="cpu", kmeans_params: KmeansParams | None = None,
                 cap_quantile: float = 1.0, storage: str = "f32",
                 coarse: str = "kmeans"):
        """``cap_quantile`` < 1 caps list capacity at that quantile of list
        sizes and spills the overflow (farthest from the centroid first) to
        each vector's next-nearest list with room."""
        if storage != "f32":
            raise NotImplementedError(
                f"storage {storage!r}: only 'f32' is ported")
        if coarse != "kmeans":
            raise NotImplementedError(
                f"coarse quantizer {coarse!r}: only 'kmeans' is ported")
        self.d = d
        self.nlist = nlist
        self.metric = Metric.parse(metric)
        self.device = resolve(device)
        self.storage = storage
        self.kmeans_params = kmeans_params or KmeansParams()
        self.cap_quantile = cap_quantile
        self.is_trained = False
        self.nprobe = 1
        self.centroids: np.ndarray | None = None
        self.interdis: np.ndarray | None = None
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []
        self._arrays: IVFArrays | None = None
        self._multirow: MultiRowArrays | None = None
        self._multirow_row_cap: int | None = None
        self._ntotal = 0

    @classmethod
    def from_state(cls, centroids: np.ndarray, arrays: IVFArrays,
                   metric: Metric = Metric.L2,
                   multirow: MultiRowArrays | None = None) -> "IVFFlatIndex":
        """An index on given centroids, packed arrays and (optionally)
        multi-row layout, for example the JAX package's state carried over
        by ``convert``, so both packages compute on identical index state.
        The stored vectors stay queued too, so a later ``add`` repacks
        all."""
        nlist, d = np.asarray(centroids).shape
        idx = cls(d, nlist, metric, device=arrays.db.device)
        idx.centroids = np.asarray(centroids, np.float32)
        idx.interdis = arrays.interdis.cpu().numpy()
        idx.is_trained = True
        keep = (arrays.vec_ids >= 0).cpu().numpy()
        x = arrays.db.cpu().numpy()[keep]
        ids = arrays.vec_ids.cpu().numpy()[keep].astype(np.int64)
        idx._pending = [(x, ids)]
        idx._ntotal = int(ids.size)
        idx._arrays = arrays
        if multirow is not None:
            idx._multirow = multirow
            idx._multirow_row_cap = multirow.rows.cap
        return idx

    # ------------------------------------------------------------- train

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        assert x.shape[1] == self.d
        res = kmeans(x, self.nlist, self.kmeans_params, self.metric,
                     device=self.device)
        self.set_centroids(res.centroids)

    def set_centroids(self, centroids: np.ndarray) -> None:
        centroids = np.asarray(centroids, np.float32)
        assert centroids.shape == (self.nlist, self.d)
        self.centroids = centroids
        self.interdis = (compute_interdis(centroids, self.metric, self.device)
                         if self.nlist <= self.INTERDIS_EAGER_MAX else None)
        self.is_trained = True
        self._arrays = None
        self._multirow = None

    def ensure_interdis(self) -> np.ndarray:
        if self.interdis is None:
            self.interdis = compute_interdis(self.centroids, self.metric,
                                             self.device)
            self._arrays = None
        return self.interdis

    # --------------------------------------------------------------- add

    @property
    def ntotal(self) -> int:
        return self._ntotal

    def add(self, x: np.ndarray, ids: np.ndarray | None = None) -> None:
        assert self.is_trained, "train before add"
        x = np.asarray(x, np.float32)
        if ids is None:
            ids = np.arange(self._ntotal, self._ntotal + x.shape[0],
                            dtype=np.int64)
        ids = np.asarray(ids, np.int64)
        assert x.shape[0] == ids.shape[0] and x.shape[1] == self.d
        if ids.size and (ids.max() > np.iinfo(np.int32).max
                         or ids.min() < 0):
            raise ValueError("ids must fit in int32 (packed vec_ids layout)")
        self._pending.append((x, ids))
        self._ntotal += x.shape[0]
        self._arrays = None
        self._multirow = None

    def _pack(self) -> None:
        """Scatter the queued vectors into the padded [nlist, cap, d]
        layout; with cap_quantile < 1, spill overflow to next-nearest
        lists."""
        assert self.is_trained
        dev = self.device
        x = (np.concatenate([p[0] for p in self._pending], 0)
             if self._pending else np.zeros((0, self.d), np.float32))
        vid = (np.concatenate([p[1] for p in self._pending], 0)
               if self._pending else np.zeros((0,), np.int64))
        n = x.shape[0]
        cents = torch.as_tensor(self.centroids, device=dev)
        cent_sq = sqnorms(cents)
        xd = torch.as_tensor(x, device=dev)
        spill = self.cap_quantile < 1.0 and n and self.nlist > 4
        n_choice = min(4 if spill else 1, self.nlist)
        choices = (_assign_topk(xd, cents, cent_sq, n_choice, self.metric)
                   .cpu().numpy().astype(np.int64) if n
                   else np.zeros((0, 1), np.int64))
        assign = choices[:, 0].copy()
        sizes = np.bincount(assign, minlength=self.nlist).astype(np.int64)
        if spill:
            cap = max(int(np.quantile(sizes, self.cap_quantile)),
                      -(-n // self.nlist))
            room = cap - np.minimum(sizes, cap)
            order0 = np.argsort(assign, kind="stable")
            starts0 = np.zeros(self.nlist + 1, np.int64)
            np.cumsum(sizes, out=starts0[1:])
            for l in np.where(sizes > cap)[0]:
                members = order0[starts0[l]:starts0[l + 1]]
                d2c = ((x[members] - self.centroids[l]) ** 2).sum(1)
                members = members[np.argsort(d2c)]
                for v in members[cap:]:
                    placed = False
                    for alt in choices[v, 1:]:
                        if room[alt] > 0:
                            assign[v] = alt
                            room[alt] -= 1
                            placed = True
                            break
                    if not placed:  # rare: dump into the emptiest list
                        alt = int(np.argmax(room))
                        if room[alt] <= 0:
                            cap += 8
                            room += 8
                        assign[v] = alt
                        room[alt] -= 1
            sizes = np.bincount(assign, minlength=self.nlist).astype(np.int64)
        cap = _round_up(max(int(sizes.max()) if n else 1, 8), 8)

        order = np.argsort(assign, kind="stable")
        starts = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        slot = np.empty(n, np.int64)
        slot[order] = np.arange(n, dtype=np.int64) - np.repeat(
            starts[:-1], sizes)
        vec_ids = np.full((self.nlist, cap), -1, np.int32)
        vec_ids[assign, slot] = vid.astype(np.int32)
        db = torch.zeros((self.nlist, cap, self.d), dtype=torch.float32,
                         device=dev)
        if n:
            db[torch.as_tensor(assign, device=dev),
               torch.as_tensor(slot, device=dev)] = xd
        self._arrays = IVFArrays(
            centroids=cents, cent_sq=cent_sq, db=db, db_sq=sqnorms(db),
            vec_ids=torch.as_tensor(vec_ids, device=dev),
            list_sizes=torch.as_tensor(sizes.astype(np.int32), device=dev),
            interdis=torch.as_tensor(
                self.interdis if self.interdis is not None
                else np.zeros((1, 1), np.float32), device=dev))

    @property
    def arrays(self) -> IVFArrays:
        if self._arrays is None:
            self._pack()
            if self._multirow_row_cap is not None:
                self._multirow = build_multirow(self._arrays,
                                                self._multirow_row_cap)
        return self._arrays

    def enable_multirow(self, row_cap: int | None = None) -> MultiRowArrays:
        """Build (and rebuild after every repack) the multi-row layout."""
        self._multirow_row_cap = row_cap if row_cap is not None else 256
        self._multirow = build_multirow(self.arrays, self._multirow_row_cap)
        return self._multirow

    @property
    def multirow(self) -> MultiRowArrays | None:
        if self._multirow is None and self._multirow_row_cap is not None:
            _ = self.arrays
        return self._multirow

    @property
    def packing_efficiency(self) -> float:
        a = self.arrays
        return self._ntotal / float(a.nlist * a.cap) if self._ntotal else 1.0

    # ------------------------------------------------------------- search

    def _q(self, q: np.ndarray) -> torch.Tensor:
        q = np.asarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(f"queries must be [n, {self.d}], got "
                             f"{q.shape}")
        return torch.as_tensor(q, device=self.device)

    def search(self, q: np.ndarray, k: int, nprobe: int | None = None):
        """Fixed-nprobe search: over the rows when the multi-row layout is
        enabled, else over the padded lists. Returns numpy (D, I)."""
        nprobe = min(int(nprobe if nprobe is not None else self.nprobe),
                     self.nlist)
        qt = self._q(q)
        mr = self.multirow
        if mr is not None:
            rpl = np.sort(mr.rows_per_list.cpu().numpy())[::-1]
            out_slots = int(rpl[:nprobe].sum())
            vals, ids = multirow_search_fixed(mr, qt, k, nprobe, out_slots,
                                              self.metric)
        else:
            a = self.arrays
            q_sq = sqnorms(qt)
            _, cids = coarse_rank(a, qt, self.metric, q_sq=q_sq)
            vals, ids = init_topk((qt.shape[0],), k, self.metric, qt.device)
            limit = torch.full((qt.shape[0],), nprobe, dtype=torch.int32,
                               device=qt.device)
            vals, ids = scan_probe_range(a, qt, q_sq, cids, vals, ids, limit,
                                         0, nprobe, self.metric)
        return vals.cpu().numpy(), ids.cpu().numpy().astype(np.int64)

    def exact_search(self, q: np.ndarray, k: int, batch: int = 1024):
        """Full scan (nprobe = nlist) whose distance values match the probe
        scans' within the kscaling tolerance: the profile trainer's ground
        truth."""
        q = np.asarray(q, np.float32)
        nq = q.shape[0]
        out_v = np.empty((nq, k), np.float32)
        out_i = np.empty((nq, k), np.int64)
        for q0 in range(0, nq, batch):
            v, i = ivf_full_scan(self.arrays, self._q(q[q0:q0 + batch]), k,
                                 self.metric)
            out_v[q0:q0 + batch] = v.cpu().numpy()
            out_i[q0:q0 + batch] = i.cpu().numpy()
        return out_v, out_i

