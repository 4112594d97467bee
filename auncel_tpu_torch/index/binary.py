"""Binary indexes in Hamming space (port of ``auncel_tpu/index/binary.py``;
the reference's ``IndexBinaryFlat``, ``IndexBinaryIVF``,
``IndexBinaryFromFloat`` and ``index_binary_factory``).

Vectors are bitstrings of d bits, stored packed (uint8, d/8 bytes,
little-endian bit order). Distances are integers, so ties are everywhere:
every ranking here keeps the JAX package's order exactly, the lower
position first among equal distances (``lax.top_k`` keeps the first
occurrence).

- ``BinaryFlatIndex`` and the coarse rank of ``BinaryIVFIndex`` take the
  Hamming distance from one fp32 matrix product over {0, 1} bit planes,
  ``popcount(a) + popcount(b) - 2 <a, b>``, exact below 2^24 bits (the JAX
  package multiplies bf16 planes with f32 accumulation, also exact), and
  a stable top-k a block of the corpus at a time.
- ``BinaryIVFIndex.search`` scans each query's candidates (the members of
  its probed lists) by XOR and popcount of the packed codes, batched over
  queries. The JAX package loops over queries and ranks each query's
  candidates in ascending id order (``np.unique``); the batch ranks by
  (distance, id), the same order.

- ``BinaryHNSWIndex`` runs the float HNSW graph (``index/hnsw.py``) over
  the unpacked {0, 1} planes: their squared L2 distance is the Hamming
  distance, exactly. ``BinaryIVFIndex(coarse_hnsw_m=m)`` (the factory's
  ``BIVFn_HNSWm``) ranks its probes through such a graph over the
  centroid codes; a -1 the graph leaves probes cell 0, as in the JAX
  package, and a cell probed twice is scanned once.
"""

import re

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.index.hnsw import HNSWIndex
from auncel_tpu_torch.index.scan import popcount8
from auncel_tpu_torch.ops.kmeans import KmeansParams, kmeans
from auncel_tpu_torch.ops.topk import init_topk, merge_topk, topk_scores
from auncel_tpu_torch.types import Metric

INT32_MAX = np.iinfo(np.int32).max
# corpus rows a Hamming product step; candidate slots a scan step
DB_BLOCK = 65536
CAND_BLOCK = 1 << 24


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """{0,1} [n, d] -> packed uint8 [n, d/8] (little-endian bit order,
    as np.unpackbits(bitorder='little') reads it)."""
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def unpack_bits(codes: np.ndarray, d: int) -> np.ndarray:
    return np.unpackbits(codes, axis=1, count=d, bitorder="little")


def bit_planes(codes: np.ndarray, d: int, device) -> torch.Tensor:
    """Packed codes as float32 {0, 1} planes [n, d] on ``device``."""
    return torch.as_tensor(unpack_bits(np.asarray(codes, np.uint8), d),
                           device=device).to(torch.float32)


def hamming_topk(qbits: torch.Tensor, dbbits: torch.Tensor,
                 db_pop: torch.Tensor, k: int, n_real: int | None = None):
    """The k smallest Hamming distances of {0,1} float32 planes ``qbits``
    [B, d] against ``dbbits`` [N, d] (popcounts ``db_pop``), as float32
    values and int32 positions, best first; ties keep the lower position.
    Rows past ``n_real`` are excluded. k past the rows pads with inf and
    id -1."""
    B, dev = qbits.shape[0], qbits.device
    n = dbbits.shape[0] if n_real is None else n_real
    q_pop = qbits.sum(1)
    vals, ids = init_topk((B,), k, Metric.L2, dev)
    for b0 in range(0, n, DB_BLOCK):
        b1 = min(b0 + DB_BLOCK, n)
        ham = q_pop[:, None] + db_pop[None, b0:b1] - 2.0 * (
            qbits @ dbbits[b0:b1].T)
        bids = torch.arange(b0, b1, dtype=torch.int32,
                            device=dev).expand(ham.shape)
        bv, bi = topk_scores(ham, bids, min(k, b1 - b0), Metric.L2)
        vals, ids = merge_topk(vals, ids, bv, bi, k, Metric.L2)
    return vals, ids


def int_distances(vals: np.ndarray) -> np.ndarray:
    """Float Hamming values as int32, a pad's inf as the int32 maximum
    (casting inf is undefined and would rank a pad first in a merge)."""
    out = np.full(vals.shape, INT32_MAX, np.int32)
    fin = np.isfinite(vals)
    out[fin] = np.rint(vals[fin]).astype(np.int32)
    return out


class BinaryFlatIndex(Index):
    """Exact Hamming k-NN (reference IndexBinaryFlat)."""

    position_keyed_ids = True   # sequential ids: IndexShards translates

    def __init__(self, d: int, device="cuda"):
        assert d % 8 == 0, "binary dimension must be a multiple of 8 bits"
        self.d = d                       # dimension in bits
        self.metric = Metric.L2          # Hamming: smaller is better
        self.device = resolve(device)
        self.is_trained = True
        self._codes = np.zeros((0, d // 8), np.uint8)
        self._bits = None

    @property
    def ntotal(self) -> int:
        return self._codes.shape[0]

    @property
    def codes(self) -> np.ndarray:
        return self._codes

    def train(self, x) -> None:
        pass

    def add(self, codes: np.ndarray, ids=None) -> None:
        assert ids is None, "BinaryFlat stores sequential ids"
        codes = np.asarray(codes, np.uint8)
        assert codes.shape[1] == self.d // 8
        self._codes = np.concatenate([self._codes, codes], 0)
        self._bits = None

    def _device_bits(self):
        if self._bits is None:
            b = bit_planes(self._codes, self.d, self.device)
            self._bits = (b, b.sum(1))
        return self._bits

    def search(self, q_codes: np.ndarray, k: int):
        """q_codes: packed uint8 [nq, d/8]. Returns (Hamming distances
        [nq, k] int32, ids [nq, k] int64); k past ntotal pads with the
        int32 maximum and id -1."""
        dbbits, db_pop = self._device_bits()
        qbits = bit_planes(q_codes, self.d, self.device)
        vals, ids = hamming_topk(qbits, dbbits, db_pop, k)
        return (int_distances(vals.cpu().numpy()),
                ids.cpu().numpy().astype(np.int64))

    def reset(self) -> None:
        self._codes = np.zeros((0, self.d // 8), np.uint8)
        self._bits = None


class BinaryIVFIndex(Index):
    """IVF over Hamming space (reference IndexBinaryIVF): binary centroids
    from k-means on the unpacked bit planes, rounded by majority; the
    nprobe nearest cells by exact Hamming rank, or with ``coarse_hnsw_m``
    through a binary HNSW over the centroid codes (the BIVF%d_HNSW%d cell,
    AutoTune.cpp:980-985); their members scanned exactly."""

    position_keyed_ids = True

    def __init__(self, d: int, nlist: int, coarse_hnsw_m: int | None = None,
                 device="cuda"):
        assert d % 8 == 0
        self.d = d
        self.nlist = nlist
        self.metric = Metric.L2
        self.device = resolve(device)
        self.is_trained = False
        self.nprobe = 1
        self.coarse_hnsw_m = coarse_hnsw_m
        self._coarse_g = None
        self.centroid_bits: np.ndarray | None = None  # {0,1} [nlist, d]
        self._codes = np.zeros((0, d // 8), np.uint8)
        self._dev = None

    @property
    def ntotal(self) -> int:
        return self._codes.shape[0]

    def train(self, codes: np.ndarray) -> None:
        bits = unpack_bits(np.asarray(codes, np.uint8), self.d)
        res = kmeans(bits.astype(np.float32), self.nlist,
                     KmeansParams(niter=10), device=self.device)
        # majority vote (the reference trains float centroids, then rounds)
        self.centroid_bits = (res.centroids > 0.5).astype(np.uint8)
        self._coarse_g = None
        self.is_trained = True

    def add(self, codes: np.ndarray, ids=None) -> None:
        assert self.is_trained and ids is None
        codes = np.asarray(codes, np.uint8)
        self._codes = np.concatenate([self._codes, codes], 0)
        self._dev = None

    def _build(self):
        """The lists on the device: each code's nearest centroid (ties to
        the lower one), the members of every list in ascending id order in
        a padded [nlist, cap] table (id -1 past a list's size), the packed
        codes and the centroid planes."""
        if self._dev is not None:
            return self._dev
        dev = self.device
        cb = torch.as_tensor(self.centroid_bits, device=dev).to(
            torch.float32)
        cpop = cb.sum(1)
        n = self.ntotal
        assign = torch.empty((n,), dtype=torch.int64, device=dev)
        for r0 in range(0, n, DB_BLOCK):
            xb = bit_planes(self._codes[r0:r0 + DB_BLOCK], self.d, dev)
            ham = xb.sum(1)[:, None] + cpop[None] - 2.0 * (xb @ cb.T)
            # the first of equal distances, as top_k(., 1) keeps it
            assign[r0:r0 + DB_BLOCK] = torch.argmin(ham, dim=1)
        sizes = torch.bincount(assign, minlength=self.nlist)
        cap = max(int(sizes.max()) if n else 1, 1)
        order = torch.argsort(assign, stable=True)
        starts = torch.cumsum(sizes, 0) - sizes
        slot = torch.arange(n, device=dev) - starts[assign[order]]
        members = torch.full((self.nlist, cap), -1, dtype=torch.int64,
                             device=dev)
        members[assign[order], slot] = order
        codes = torch.as_tensor(self._codes, device=dev)
        self._dev = (members, codes, cb, cpop)
        return self._dev

    def search(self, q_codes: np.ndarray, k: int,
               nprobe: int | None = None):
        """(Hamming distances [nq, k] int32, ids [nq, k] int64) over the
        members of each query's nprobe nearest cells; fewer candidates
        than k pad with the int32 maximum and id -1."""
        members, codes, cb, cpop = self._build()
        nprobe = min(nprobe or self.nprobe, self.nlist)
        q_codes = np.asarray(q_codes, np.uint8)
        dev = self.device
        nq = q_codes.shape[0]
        qb = bit_planes(q_codes, self.d, dev)
        probes = self._coarse_probes(q_codes, qb, cb, cpop, nprobe)
        qc = torch.as_tensor(q_codes, device=dev)
        cap = members.shape[1]
        chunk = max(1, CAND_BLOCK // (nprobe * cap))
        n = max(self.ntotal, 1)
        out_v = np.empty((nq, k), np.int32)
        out_i = np.empty((nq, k), np.int64)
        for q0 in range(0, nq, chunk):
            p = probes[q0:q0 + chunk]
            cand = torch.where(p[:, :, None] >= 0, members[p.clamp_min(0)],
                               -1).reshape(-1, nprobe * cap)   # [c, P*cap]
            ok = cand >= 0
            x = codes[cand.clamp_min(0)]                       # [c, P*cap, w]
            ham = popcount8(x ^ qc[q0:q0 + chunk, None, :]).sum(
                -1, dtype=torch.int64)
            # (distance, id) in one key: distances <= d, ids < n
            key = torch.where(ok, ham * n + cand, torch.iinfo(torch.int64).max)
            key = torch.sort(key, dim=1).values[:, :k]
            if key.shape[1] < k:
                key = torch.cat([key, torch.full(
                    (key.shape[0], k - key.shape[1]),
                    torch.iinfo(torch.int64).max, device=dev)], 1)
            pad = key == torch.iinfo(torch.int64).max
            out_v[q0:q0 + chunk] = torch.where(
                pad, INT32_MAX, key // n).cpu().numpy()
            out_i[q0:q0 + chunk] = torch.where(pad, -1, key % n).cpu().numpy()
        return out_v, out_i

    def _coarse_probes(self, q_codes: np.ndarray, qb, cb, cpop,
                       nprobe: int) -> torch.Tensor:
        """Each query's probed cells [nq, nprobe] (int64): the exact
        Hamming rank, or with ``coarse_hnsw_m`` the binary HNSW over the
        centroid codes at ef = max(4 nprobe, 32) (built at the first
        call), its -1 pads as cell 0 and a repeated cell as -1 (the JAX
        package scans the union of the probed cells)."""
        if self.coarse_hnsw_m is None:
            return hamming_topk(qb, cb, cpop, nprobe)[1].long()
        if self._coarse_g is None:
            g = BinaryHNSWIndex(self.d, M=self.coarse_hnsw_m,
                                ef_search=max(4 * nprobe, 32),
                                device=self.device)
            g.add(pack_bits(self.centroid_bits))
            g.build()
            self._coarse_g = g
        _, probes = self._coarse_g.search(q_codes, nprobe,
                                          ef=max(4 * nprobe, 32))
        p = torch.as_tensor(np.maximum(probes, 0), device=self.device)
        s, order = torch.sort(p, dim=1, stable=True)
        rep = torch.cat([torch.zeros_like(s[:, :1], dtype=torch.bool),
                         s[:, 1:] == s[:, :-1]], 1)
        return torch.where(torch.zeros_like(rep).scatter(1, order, rep), -1,
                           p)

    def reset(self) -> None:
        self._codes = np.zeros((0, self.d // 8), np.uint8)
        self._dev = None
        self._coarse_g = None


class BinaryHNSWIndex(Index):
    """Binary-code HNSW (reference IndexBinaryHNSW): the float HNSW graph
    over the unpacked {0, 1} planes, whose squared L2 distance is the
    Hamming distance (b1 XOR b2 popcount = ||b1 - b2||^2), so the graph
    returns true Hamming distances."""

    position_keyed_ids = True

    def __init__(self, d: int, M: int = 16, ef_search: int = 32,
                 device="cuda"):
        assert d % 8 == 0, "binary dimension must be a multiple of 8 bits"
        self.d = d                      # bits per code
        self.metric = Metric.L2         # L2 over {0, 1} is Hamming
        self.is_trained = True
        self._g = HNSWIndex(d, M=M, ef_search=ef_search, device=device)

    @property
    def ntotal(self) -> int:
        return self._g.ntotal

    def train(self, codes) -> None:
        pass

    def add(self, codes: np.ndarray, ids=None) -> None:
        assert ids is None, "BinaryHNSWIndex stores sequential ids"
        self._g.add(unpack_bits(np.asarray(codes, np.uint8), self.d)
                    .astype(np.float32))

    def build(self) -> None:
        self._g.build()

    def search(self, q_codes: np.ndarray, k: int, ef: int | None = None):
        """(Hamming distances [nq, k] int32, ids [nq, k] int64); pads carry
        the int32 maximum and id -1."""
        q = unpack_bits(np.asarray(q_codes, np.uint8),
                        self.d).astype(np.float32)
        vals, ids = self._g.search(q, k, ef=ef)
        return int_distances(vals), ids

    def reset(self) -> None:
        self._g.reset()


class IndexBinaryFromFloat(Index):
    """A binary index backed by any float index (reference
    IndexBinaryFromFloat.h:28): codes map bit -> ±1 floats
    (``binary_to_real``, utils.cpp:1564), train, add and search run on the
    float index, and its L2 distances divided by 4 are the Hamming
    distances (each differing bit contributes (±2)^2 = 4)."""

    def __init__(self, sub: Index, d: int):
        assert d % 8 == 0, "binary dimension must be a multiple of 8 bits"
        assert sub.d == d, "float sub-index dimension must equal bit count"
        self.d = d
        self.metric = Metric.L2
        self.sub = sub

    @property
    def is_trained(self):
        return self.sub.is_trained

    @is_trained.setter
    def is_trained(self, v):  # pragma: no cover - keeps the Index contract
        pass

    @property
    def ntotal(self) -> int:
        return self.sub.ntotal

    def _to_real(self, codes: np.ndarray) -> np.ndarray:
        bits = unpack_bits(np.asarray(codes, np.uint8), self.d)
        return (2.0 * bits - 1.0).astype(np.float32)

    def train(self, codes: np.ndarray) -> None:
        self.sub.train(self._to_real(codes))

    def add(self, codes: np.ndarray, ids=None) -> None:
        if ids is not None:
            self.sub.add(self._to_real(codes), ids)
        else:
            self.sub.add(self._to_real(codes))

    def search(self, q_codes: np.ndarray, k: int, **kw):
        vals, ids = self.sub.search(self._to_real(q_codes), k, **kw)
        return int_distances(np.asarray(vals, np.float64) / 4.0), ids

    def reset(self) -> None:
        self.sub.reset()


def index_binary_factory(d: int, description: str,
                         device="cuda") -> Index:
    """The binary factory grammar (reference ``index_binary_factory``,
    AutoTune.cpp:973-1008), ``d`` in bits: "BFlat", "BIVF%d", "BHNSW%d"
    (M 32 by default) and "BIVF%d_HNSW%d" (or "BIVF%d_BHNSW%d")."""
    m = re.fullmatch(r"BIVF(\d+)_B?HNSW(\d+)", description)
    if m:
        return BinaryIVFIndex(d, nlist=int(m.group(1)),
                              coarse_hnsw_m=int(m.group(2)), device=device)
    m = re.fullmatch(r"BHNSW(\d+)?", description)
    if m:
        return BinaryHNSWIndex(d, M=int(m.group(1) or 32), device=device)
    m = re.fullmatch(r"BIVF(\d+)", description)
    if m:
        return BinaryIVFIndex(d, nlist=int(m.group(1)), device=device)
    if description == "BFlat":
        return BinaryFlatIndex(d, device=device)
    raise NotImplementedError(
        f"binary factory description {description!r} "
        "(grammar: BFlat | BIVF%d | BHNSW%d | BIVF%d_HNSW%d)")
