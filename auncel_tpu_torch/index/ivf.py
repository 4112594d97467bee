"""IVF-Flat index (port of ``auncel_tpu/index/ivf.py``).

Lists are packed into a padded ``[nlist, cap, d]`` tensor on ``device``
(the card, ``"cuda"``, unless the caller passes another; cap = the largest
list, rounded up to 8; pad slots carry id -1), which the padded engines
scan, and ``enable_multirow`` keeps the tight row layout the multi-row
engine scans. Storage: "f32", "bf16", the scalar quantizers "sq8",
"sq4", "sq8u", "sq4u", "sq6" and "sq8d" (uint8 codes with a per-dimension
affine range), or product quantization "pqM" (M uint8 codes a vector, of
the residual ``x - centroid[list]`` unless ``pq_residual=False``, with the
polysemous codebook order when ``polysemous``); every distance is on
decoded values. PQ storage is served by the padded engines only (K2
decodes the codes): the multi-row layout refuses it, as the JAX package's
does. Fixed-nprobe search takes the JAX package's routes: the polysemous
Hamming filter when ``polysemous_ht`` is set on PQ storage, the dense
crossover on the multi-row layout, and the ``max_codes`` budget on both
layouts, and adds to the ``index/aux.py`` counters. Stored vectors come
back decoded through the codec (``reconstruct`` and its family; residual
PQ with its list's centroid added back), ``update_vectors`` repacks with
the SQ range kept, and ``IVFFlatDedupIndex`` stores each distinct vector
once. ``coarse="imi"`` trains the IMI product cells
(``index/imi.py``: nlist = K^2 cells, the product centroids materialised),
which every layout, engine and search route then serves as ordinary
centroids; the inter-centroid matrix waits above ``INTERDIS_EAGER_MAX``
lists until ``ensure_interdis``. ``coarse_hnsw_m`` (the factory's
``IVFn_HNSWm`` cells) ranks the lists of fixed-nprobe search through an
HNSW graph over the centroids (``index/hnsw.py``, built at the first such
search) instead of the exact rank, then scans the padded lists (K2), as
the JAX package's ``_search_hnsw_coarse`` does; the error-bounded engines
keep the exact rank.
"""

import re
import time

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.aux import ivf_stats
from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.index.flat import (
    sq_code_width, sq_encode, sq_pack, sq_train_range)
from auncel_tpu_torch.index.hnsw import HNSWIndex
from auncel_tpu_torch.index.scan import (
    IVFArrays, coarse_rank, ivf_full_scan, ivf_search_fixed,
    ivf_search_fixed_ht, scan_probe_range)
from auncel_tpu_torch.index.multirow import (
    MultiRowArrays, build_multirow, multirow_dense_fixed,
    multirow_search_fixed)
from auncel_tpu_torch.ops.distance import (
    pairwise_ip, pairwise_l2sqr, pairwise_scores, sqnorms)
from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans
from auncel_tpu_torch.ops.pq import PQCodebooks, encode_pq, train_pq
from auncel_tpu_torch.ops.polysemous import reorder_codebook
from auncel_tpu_torch.ops.sq import sq_decode_dev, sq_kind
from auncel_tpu_torch.ops.topk import init_topk, topk_scores

# scalar-quantized storage codecs (reference ScalarQuantizer QT_* families,
# IndexScalarQuantizer.h:34-41; "u" = one range for all dims, "d" = direct)
SQ_STORAGE = ("sq8", "sq4", "sq8u", "sq4u", "sq6", "sq8d")
STORAGE = ("f32", "bf16") + SQ_STORAGE   # and "pqM", M subquantizers
# PQ training sample: at most this many (residual) vectors, as the JAX
# package's _pack takes
PQ_TRAIN_MAX = 200_000


def pq_subquantizers(storage: str) -> int | None:
    """M of a "pqM" storage name, else None."""
    m = re.fullmatch(r"pq(\d+)", storage)
    return int(m.group(1)) if m else None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_interdis(centroids: np.ndarray, metric: Metric,
                     device="cuda") -> np.ndarray:
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
                 cent_sq: torch.Tensor, k: int, metric: Metric,
                 decode=None) -> torch.Tensor:
    """Top-k nearest centroids of every row, [n, k] int32; ``decode``
    maps a block of rows to the vectors assigned (SQ codes to their
    decoded values)."""
    block = 65536
    nlist = centroids.shape[0]
    ids = torch.arange(nlist, dtype=torch.int32, device=x.device)
    out = []
    for i in range(0, x.shape[0], block):
        xb = x[i:i + block] if decode is None else decode(x[i:i + block])
        s = pairwise_scores(xb, centroids, metric, y_sqnorms=cent_sq)
        out.append(topk_scores(s, ids.expand(s.shape), k, metric)[1])
    return torch.cat(out)


def _decoded_norms(arrays: IVFArrays, block: int = 1 << 22) -> torch.Tensor:
    """Squared norms [nlist, cap] of the decoded stored vectors, a block of
    lists at a time (the decoded corpus never exists whole), zero at
    padding: the JAX package's ``_sq_norms_fused`` masked by id."""
    nlist, cap = arrays.vec_ids.shape
    step = max(1, block // max(cap, 1))
    out = torch.cat([sqnorms(arrays.decode_block(arrays.db[i:i + step]))
                     for i in range(0, nlist, step)])
    return torch.where(arrays.vec_ids >= 0, out, 0.0)


def preserve_sq_range(index) -> None:
    """Pin the current affine SQ range on an index about to be rebuilt
    from decoded vectors, so re-encoding reproduces the surviving codes
    instead of training a shifted range. No-op for other storage."""
    a = getattr(index, "_arrays", None)
    if a is not None and a.sq_scale is not None:
        index._sq_range_override = (a.sq_bias.cpu().numpy(),
                                    a.sq_scale.cpu().numpy())


class IVFFlatIndex(Index):
    INTERDIS_EAGER_MAX = 4096

    def __init__(self, d: int, nlist: int, metric: Metric = Metric.L2,
                 device="cuda", kmeans_params: KmeansParams | None = None,
                 cap_quantile: float = 1.0, storage: str = "f32",
                 coarse: str = "kmeans", sq_rangestat: str = "minmax",
                 sq_rangestat_arg: float = 0.0, pq_residual: bool = True,
                 polysemous: bool = False, polysemous_ht: int = 0):
        """``cap_quantile`` < 1 caps list capacity at that quantile of list
        sizes and spills the overflow (farthest from the centroid first) to
        each vector's next-nearest list with room. ``storage`` is one of
        ``STORAGE`` ("pqM" for M subquantizers, d % M == 0);
        ``sq_rangestat``/``sq_rangestat_arg`` choose the SQ range
        statistic (``index/flat.py::sq_train_range``). PQ storage:
        ``pq_residual`` encodes ``x - centroid[list]`` (the reference IVFPQ
        default), ``polysemous`` reorders each codebook so that code
        Hamming distance tracks codeword distance, and ``polysemous_ht`` >
        0 filters fixed-nprobe search by Hamming distance (0: off,
        IndexPQ.h:24)."""
        M = pq_subquantizers(storage)
        if storage not in STORAGE and M is None:
            raise NotImplementedError(
                f"storage {storage!r}: the port serves {STORAGE} and "
                f"'pqM'")
        if storage in SQ_STORAGE:
            sq_code_width(d, storage)  # d divisibility check
        if M is not None and (M <= 0 or d % M):
            raise ValueError(f"storage {storage!r}: d={d} is not divisible "
                             f"by M={M}")
        if coarse not in ("kmeans", "imi"):
            raise NotImplementedError(
                f"coarse quantizer {coarse!r}: the port trains 'kmeans' "
                f"and 'imi'")
        self.d = d
        self.nlist = nlist
        self.metric = Metric.parse(metric)
        self.device = resolve(device)
        self.storage = storage
        self.coarse = coarse   # "kmeans" | "imi" (IMI2x%d product cells)
        self.sq_rangestat = sq_rangestat
        self.sq_rangestat_arg = float(sq_rangestat_arg)
        self.pq_residual = pq_residual
        self.polysemous = polysemous
        self.polysemous_ht = polysemous_ht
        self._sq_range_override = None   # (vmin, scale) kept across repacks
        # the code-visit budget of fixed-nprobe search; 0 = unlimited
        # (IndexIVF.h:69)
        self.max_codes = 0
        # the dense crossover of fixed-nprobe search on the multi-row layout
        # (see search(); None disables, 0.0 forces)
        self.dense_cut: float | None = 0.25
        self.dense_batch_mult: float = 64.0
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
        # the IVF%d_HNSW%d factory cell: M of an HNSW graph over the
        # centroids that ranks the lists of fixed-nprobe search
        # (AutoTune.cpp:807-820); None = the exact rank
        self.coarse_hnsw_m: int | None = None
        self._hnswq: HNSWIndex | None = None

    @classmethod
    def from_state(cls, centroids: np.ndarray, arrays: IVFArrays,
                   metric: Metric = Metric.L2,
                   multirow: MultiRowArrays | None = None,
                   coarse: str = "kmeans") -> "IVFFlatIndex":
        """An index on given centroids, packed arrays and (optionally)
        multi-row layout, for example the JAX package's state carried over
        by ``convert``, so both packages compute on identical index state.
        It shares the arrays' tensors and lives on their device, with the
        arrays' storage codec. The stored vectors stay queued too, decoded,
        and an SQ index keeps its range, so a later ``add`` re-encodes the
        same codes (a PQ index trains its codebooks again on the decoded
        vectors). ``coarse`` names the quantizer that trained the centroids
        ("imi" for IMI product cells)."""
        nlist, d = np.asarray(centroids).shape
        if arrays.sq_scale is not None:
            storage = sq_kind(arrays.db.shape[-1], d)
        elif arrays.pq_codebooks is not None:
            storage = f"pq{arrays.db.shape[-1]}"
        else:
            storage = "bf16" if arrays.db.dtype == torch.bfloat16 else "f32"
        idx = cls(d, nlist, metric, device=arrays.db.device, storage=storage,
                  pq_residual=arrays.pq_residual, coarse=coarse)
        idx.centroids = np.asarray(centroids, np.float32)
        idx.interdis = arrays.interdis.cpu().numpy()
        idx.is_trained = True
        keep = (arrays.vec_ids >= 0).cpu().numpy()
        x = decoded_db(arrays)[keep]
        ids = arrays.vec_ids.cpu().numpy()[keep].astype(np.int64)
        idx._arrays = arrays
        preserve_sq_range(idx)
        idx._pending = [(x, ids)]
        idx._ntotal = int(ids.size)
        if multirow is not None:
            idx._multirow = multirow
            idx._multirow_row_cap = multirow.rows.cap
        return idx

    # ------------------------------------------------------------- train

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        assert x.shape[1] == self.d
        if self.coarse == "imi":
            from auncel_tpu_torch.index.imi import train_imi_centroids
            self.set_centroids(train_imi_centroids(
                x, self.nlist, self.metric, self.kmeans_params, self.device))
        else:
            res = kmeans(x, self.nlist, self.kmeans_params, self.metric,
                         device=self.device)
            self.set_centroids(res.centroids)

    def set_centroids(self, centroids: np.ndarray) -> None:
        centroids = np.array(centroids, np.float32)   # a writable copy
        assert centroids.shape == (self.nlist, self.d)
        self.centroids = centroids
        self.interdis = (compute_interdis(centroids, self.metric, self.device)
                         if self.nlist <= self.INTERDIS_EAGER_MAX else None)
        self.is_trained = True
        self._arrays = None
        self._multirow = None
        self._hnswq = None

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

    def assign(self, x: np.ndarray) -> np.ndarray:
        """Nearest-centroid assignment by the index metric (IP: the largest
        dot product), [n] int64."""
        from auncel_tpu_torch.ops.knn import knn
        res = knn(x, self.centroids, 1, self.metric, q_block=65536,
                  device=self.device)
        return res.ids[:, 0].astype(np.int64)

    def _sq_range(self, x: np.ndarray) -> tuple:
        """(vmin, scale) [d] f32 of the SQ codec: the pinned range if one
        is kept, the identity for sq8d (or no vectors), else trained on
        ``x``."""
        if self._sq_range_override is not None:
            return self._sq_range_override
        if self.storage == "sq8d" or not len(x):
            return (np.zeros(self.d, np.float32),
                    np.ones(self.d, np.float32))
        return sq_train_range(x, self.storage, self.sq_rangestat,
                              self.sq_rangestat_arg)

    def _pack(self) -> None:
        """Scatter the queued vectors into the padded [nlist, cap, d]
        layout; with cap_quantile < 1, spill overflow to next-nearest
        lists. SQ storage encodes on the host, as the JAX package does, and
        assigns the decoded vectors; bf16 storage assigns the f32 vectors
        and stores them rounded."""
        assert self.is_trained
        dev = self.device
        x = (np.concatenate([p[0] for p in self._pending], 0)
             if self._pending else np.zeros((0, self.d), np.float32))
        vid = (np.concatenate([p[1] for p in self._pending], 0)
               if self._pending else np.zeros((0,), np.int64))
        n = x.shape[0]
        cents = torch.as_tensor(self.centroids, device=dev)
        cent_sq = sqnorms(cents)
        sq = self.storage in SQ_STORAGE
        decode = None
        if sq:
            vmin, scale = self._sq_range(x)
            sq_scale = torch.as_tensor(scale, device=dev)
            sq_bias = torch.as_tensor(vmin, device=dev)
            codes = sq_encode(x, vmin, scale, self.storage)
            xd = torch.as_tensor(codes, device=dev)

            def decode(c):   # unpacked codes: the SQ8 decode
                return sq_decode_dev(c, self.d, sq_scale, sq_bias)
        else:
            sq_scale = sq_bias = None
            xd = torch.as_tensor(x, device=dev)
        spill = self.cap_quantile < 1.0 and n and self.nlist > 4
        n_choice = min(4 if spill else 1, self.nlist)
        choices = (_assign_topk(xd, cents, cent_sq, n_choice, self.metric,
                                decode).cpu().numpy().astype(np.int64) if n
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
        M = pq_subquantizers(self.storage)
        pq_books = None
        if sq:
            xd = torch.as_tensor(sq_pack(codes, self.storage), device=dev)
            dtype = torch.uint8
        elif M is not None and n:
            pq_books = self._train_pq(x, assign, M)
            target = xd
            if self.pq_residual:
                target = xd - cents[torch.as_tensor(assign, device=dev)]
            xd = encode_pq(PQCodebooks(pq_books), target)
            del target
            dtype = torch.uint8
        else:
            dtype = (torch.bfloat16 if self.storage == "bf16"
                     else torch.float32)
        db = torch.zeros((self.nlist, cap, xd.shape[1]), dtype=dtype,
                         device=dev)
        if n:
            db[torch.as_tensor(assign, device=dev),
               torch.as_tensor(slot, device=dev)] = xd.to(dtype)
        del xd
        arrays = IVFArrays(
            centroids=cents, cent_sq=cent_sq, db=db, db_sq=None,
            vec_ids=torch.as_tensor(vec_ids, device=dev),
            list_sizes=torch.as_tensor(sizes.astype(np.int32), device=dev),
            interdis=torch.as_tensor(
                self.interdis if self.interdis is not None
                else np.zeros((1, 1), np.float32), device=dev),
            sq_scale=sq_scale, sq_bias=sq_bias, pq_codebooks=pq_books,
            pq_residual=pq_books is not None and self.pq_residual)
        # f32: the stored vectors' norms (zero at padding, where the
        # vectors are zero); otherwise the decoded values', zeroed at
        # padding by id
        self._arrays = arrays._replace(
            db_sq=sqnorms(db) if dtype == torch.float32
            else _decoded_norms(arrays))

    def _train_pq(self, x: np.ndarray, assign: np.ndarray, M: int
                  ) -> torch.Tensor:
        """PQ codebooks [M, 256, d/M] on the device, trained on the first
        PQ_TRAIN_MAX vectors (their residuals for residual PQ), each
        reordered for ``polysemous`` (the JAX package's SA seeds)."""
        nt = min(x.shape[0], PQ_TRAIN_MAX)
        sample = x[:nt]
        if self.pq_residual:
            sample = sample - self.centroids[assign[:nt]]
        books = train_pq(sample, M, device=self.device).codebooks
        if self.polysemous:
            books = books.cpu().numpy()
            out = np.empty_like(books)
            for m in range(M):
                out[m, reorder_codebook(books[m], seed=123 + m)] = books[m]
            books = torch.as_tensor(out, device=self.device)
        return books

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

    def dense_route(self, batch: int, nprobe: int) -> bool:
        """Whether fixed-nprobe search serves a batch of ``batch`` queries
        at ``nprobe`` by the dense crossover, as the JAX package decides it
        (``auncel_tpu/index/ivf.py:541-572``): on the multi-row layout,
        without ``max_codes``, with at least 2048 rows unless ``dense_cut``
        is 0.0 (which forces it), when the batch's rows, B x nprobe x
        n_rows / nlist, reach dense_batch_mult x dense_cut x n_rows (one
        shared pass costs about the same whatever the batch; gathers grow
        with it). ``dense_cut`` None disables it."""
        mr = self.multirow
        if mr is None or self.dense_cut is None or self.max_codes:
            return False
        n_rows = mr.rows.db.shape[0]
        if not self.dense_cut:
            return True
        est_rows = nprobe * (n_rows / self.nlist)
        return (n_rows >= 2048 and batch * est_rows
                >= self.dense_batch_mult * self.dense_cut * n_rows)

    def search(self, q: np.ndarray, k: int, nprobe: int | None = None):
        """Fixed-nprobe search: with the polysemous filter on PQ storage
        when ``polysemous_ht`` is set, else over the rows when the
        multi-row layout is enabled (by the dense crossover when
        ``dense_route`` says so), else over the padded lists;
        ``max_codes`` > 0 stops each query after the ranked list that
        crosses that many codes. Returns numpy
        (D, I) and adds to ``ivf_stats``: ``ndis`` counts the slots the
        route's shape spans (the padded lists' cap, the corpus rows on the
        dense route, the nprobe largest lists' rows on the gathers)."""
        nprobe = min(int(nprobe if nprobe is not None else self.nprobe),
                     self.nlist)
        t0 = time.perf_counter()
        qt = self._q(q)
        B = qt.shape[0]
        mr = self.multirow
        max_codes = int(self.max_codes)
        ndis = B * nprobe * self.arrays.cap
        if self.coarse_hnsw_m:
            vals, ids = self._search_hnsw_coarse(qt, k, nprobe)
        elif self.polysemous_ht and self.arrays.pq_codebooks is not None:
            vals, ids = ivf_search_fixed_ht(self.arrays, qt, k, nprobe,
                                            int(self.polysemous_ht),
                                            self.metric)
        elif mr is not None and self.dense_route(B, nprobe):
            vals, ids = multirow_dense_fixed(mr, qt, nprobe, k, self.metric)
            ndis = B * mr.rows.db.shape[0] * mr.rows.cap
        elif mr is not None:
            # the exact sum of the nprobe largest per-list row counts (the
            # JAX package rounds it up to a power of two, a shape bucket;
            # the per-query limit masks the rest)
            rpl = np.sort(mr.rows_per_list.cpu().numpy())[::-1]
            out_slots = int(rpl[:nprobe].sum())
            vals, ids = multirow_search_fixed(
                mr, qt, k, nprobe, out_slots, self.metric,
                code_sizes=self.arrays.list_sizes if max_codes else None,
                max_codes=max_codes)
            ndis = B * out_slots * mr.rows.cap
        else:
            vals, ids = ivf_search_fixed(self.arrays, qt, k, nprobe,
                                         self.metric, max_codes)
        out = vals.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
        ivf_stats.nq += B
        ivf_stats.nlist_scanned += B * nprobe
        ivf_stats.ndis += ndis
        ivf_stats.search_time_ms += (time.perf_counter() - t0) * 1e3
        return out

    def hnsw_quantizer(self) -> HNSWIndex:
        """The HNSW graph over the centroids (the IVF%d_HNSW%d coarse
        quantizer), built at the first call after training."""
        if self._hnswq is None:
            hq = HNSWIndex(self.d, M=self.coarse_hnsw_m, metric=self.metric,
                           device=self.device)
            hq.add(self.centroids)
            hq.build()
            self._hnswq = hq
        return self._hnswq

    def hnsw_probes(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """Each query's nprobe lists as the centroid graph ranks them,
        explored at ef = max(4 nprobe, 64) (the coarse rank gates
        everything downstream, and the graph holds nlist nodes); -1 past
        the lists the graph found."""
        _, cids = self.hnsw_quantizer().search(np.asarray(q, np.float32),
                                               nprobe,
                                               ef=max(4 * nprobe, 64))
        return cids

    def _search_hnsw_coarse(self, q: torch.Tensor, k: int, nprobe: int):
        """Fixed-nprobe search over the graph-ranked lists (the reference's
        quantizer->search through IndexHNSW): the padded lists' scan, each
        query limited to the lists the graph found."""
        cids = self.hnsw_probes(q.cpu().numpy(), nprobe)
        dev = q.device
        vals, ids = init_topk((q.shape[0],), k, self.metric, dev)
        limit = torch.as_tensor((cids >= 0).sum(1).astype(np.int32),
                                device=dev)
        probe = torch.as_tensor(np.maximum(cids, 0).astype(np.int32),
                                device=dev)
        return scan_probe_range(self.arrays, q, sqnorms(q), probe, vals, ids,
                                limit, 0, nprobe, self.metric)

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


    def coarse_rank_np(self, q: np.ndarray):
        """Every list ranked per query: numpy (cdis, cids) [nq, nlist]."""
        cdis, cids = coarse_rank(self.arrays, self._q(q), self.metric)
        return cdis.cpu().numpy(), cids.cpu().numpy()

    def update_vectors(self, ids: np.ndarray, x: np.ndarray) -> None:
        """Replace the stored vectors of the given ids and repack (each
        updated vector goes to its new nearest list). An SQ index keeps its
        range, so the untouched rows re-encode to the same codes."""
        ids = np.asarray(ids, np.int64)
        x = np.asarray(x, np.float32)
        assert ids.shape[0] == x.shape[0] and x.shape[1] == self.d
        a = self.arrays
        db = decoded_db(a)
        stored_ids = a.vec_ids.cpu().numpy()
        keep = stored_ids >= 0
        flat_x = db[keep].astype(np.float32)
        flat_ids = stored_ids[keep].astype(np.int64)
        lut = {int(i): j for j, i in enumerate(ids)}
        for j, vid in enumerate(flat_ids):
            if int(vid) in lut:
                flat_x[j] = x[lut[int(vid)]]
        preserve_sq_range(self)
        self.reset()
        self.add(flat_x, ids=flat_ids)

    def reconstruct(self, key: int) -> np.ndarray:
        return _ivf_reconstruct(self, np.asarray([key], np.int64))[0]

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return _ivf_reconstruct(self, np.arange(i0, i0 + n, dtype=np.int64))

    def reconstruct_from_offset(self, list_no: int, offset: int
                                ) -> np.ndarray:
        """The stored vector at (list, slot), decoded through the codec."""
        a = self.arrays
        if not 0 <= list_no < self.nlist:
            raise KeyError(f"list {list_no} out of range (nlist="
                           f"{self.nlist})")
        size = int(a.list_sizes[list_no])
        if not 0 <= offset < size:
            raise KeyError(f"offset {offset} out of range for list "
                           f"{list_no} (size {size})")
        blk = a.db[list_no, offset][None, None]
        return np.array(a.decode_block(blk).cpu().numpy()[0, 0])

    def reconstruct_batch(self, keys: np.ndarray) -> np.ndarray:
        """The stored vectors of an id array in one pass; negative keys
        give zeros."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        out = np.zeros((keys.size, self.d), np.float32)
        valid = keys >= 0
        if valid.any():
            out[valid] = _ivf_reconstruct(self, keys[valid])
        return out

    def reset(self) -> None:
        self._pending = []
        self._arrays = None
        self._multirow = None
        self._ntotal = 0


class IVFFlatDedupIndex(IVFFlatIndex):
    """IVF-Flat that stores each distinct vector once (reference
    IndexIVFFlatDedup, IndexIVFFlat.h:79): exact duplicates, across add
    batches too, map to the stored instance, and searches expand them back
    into the result at the same distance."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._dup: dict[int, list[int]] = {}
        self._sig: dict[bytes, int] = {}   # vector bytes -> kept id

    def add(self, x: np.ndarray, ids=None) -> None:
        x = np.asarray(x, np.float32)
        if ids is None:
            n0 = self._ntotal + sum(len(v) for v in self._dup.values())
            ids = np.arange(n0, n0 + x.shape[0], dtype=np.int64)
        ids = np.asarray(ids, np.int64)
        keep_rows, kept_ids = [], []
        for row in range(x.shape[0]):
            sig = x[row].tobytes()
            kept = self._sig.get(sig)
            if kept is None:
                self._sig[sig] = int(ids[row])
                keep_rows.append(row)
                kept_ids.append(int(ids[row]))
            else:
                self._dup.setdefault(kept, []).append(int(ids[row]))
        if keep_rows:
            super().add(x[keep_rows], ids=np.asarray(kept_ids, np.int64))

    def reset(self) -> None:
        super().reset()
        self._dup = {}
        self._sig = {}

    def search(self, q: np.ndarray, k: int, nprobe: int | None = None):
        vals, ids = super().search(q, k, nprobe=nprobe)
        if not self._dup:
            return vals, ids
        out_v = np.empty_like(vals)
        out_i = np.empty_like(ids)
        for r in range(ids.shape[0]):
            vs, is_ = [], []
            for v, i in zip(vals[r], ids[r]):
                is_.append(i)
                vs.append(v)
                for dup in self._dup.get(int(i), ()):
                    is_.append(dup)
                    vs.append(v)          # the same vector, same distance
                if len(is_) >= k:
                    break
            out_v[r] = np.asarray(vs[:k], vals.dtype)
            out_i[r] = np.asarray(is_[:k], ids.dtype)
        return out_v, out_i


def decoded_db(a: IVFArrays) -> np.ndarray:
    """The whole decoded [nlist, cap, d] float32 database on the host, with
    each list's centroid added back for residual PQ: the route of every
    host-side reconstruction."""
    db = a.decode_block(a.db)
    if a.pq_residual:
        db = db + a.centroids[:, None, :]
    return db.cpu().numpy()


def _ivf_reconstruct(index: IVFFlatIndex, keys: np.ndarray) -> np.ndarray:
    """Stored vectors by id from the packed layout (one sorted lookup over
    the id tensor), decoded through the codec; KeyError for an id not
    stored."""
    a = index.arrays
    flat_ids = a.vec_ids.cpu().numpy().reshape(-1)
    flat_db = decoded_db(a).reshape(-1, index.d)
    order = np.argsort(flat_ids, kind="stable")
    pos = np.searchsorted(flat_ids, keys, sorter=order)
    got = flat_ids[order[np.clip(pos, 0, flat_ids.size - 1)]]
    if not np.array_equal(got, keys):
        missing = keys[got != keys]
        raise KeyError(f"ids not stored: {missing[:5]}...")
    return flat_db[order[pos]]
