"""IVFPQ with a refinement product quantizer (port of
``auncel_tpu/index/ivfpqr.py``; reference ``IndexIVFPQR``,
IndexIVFPQ.h:155-195).

The base IVFPQ search (the padded lists, scored by K2 on the codes) takes
``k_factor * k`` candidates; each is re-ranked against its two-stage
reconstruction

    recon(x) = centroid[list(x)] + pq_decode(code(x)) + refine_decode(x)

and the top-k of the re-ranked distances is returned. The refine PQ
(``M_refine`` subquantizers) is trained on the residual the first stage
leaves (``train_residual``, IndexIVFPQ.cpp:1194-1214). The raw vectors
stay on the host, keyed by id, to train it again after every repack; the
first-stage decode, the residuals and their encoding run on the index's
device a chunk at a time. The re-rank is one pass of plain PyTorch: a
gather of both code stages for every candidate, the decode, the fp32 L2
distance and a stable top-k (ties keep the better base rank, as
``lax.top_k`` keeps the first occurrence).
"""

import numpy as np
import torch

from auncel_tpu_torch.index.ivf import IVFFlatIndex, PQ_TRAIN_MAX
from auncel_tpu_torch.ops.pq import PQCodebooks, decode_pq, encode_pq, \
    train_pq
from auncel_tpu_torch.types import Metric

# vectors decoded, differenced and encoded at a time by _ensure_refine
REFINE_CHUNK = 1 << 20


class IndexIVFPQR(IVFFlatIndex):
    """L2 only, as the reference's factory rejects "PQ%d+%d" under inner
    product (AutoTune.cpp:854-859)."""

    def __init__(self, d: int, nlist: int, M: int = 8, M_refine: int = 8,
                 k_factor: float = 4.0, **kw):
        metric = Metric.parse(kw.pop("metric", Metric.L2))
        assert metric is Metric.L2, \
            "IVFPQR not implemented for inner product search " \
            "(AutoTune.cpp:858)"
        assert d % M == 0 and d % M_refine == 0
        super().__init__(d, nlist, metric=metric, storage=f"pq{M}", **kw)
        self.M_refine = int(M_refine)
        self.k_factor = float(k_factor)
        self._raw_x = np.zeros((0, d), np.float32)
        self._raw_ids = np.zeros((0,), np.int64)
        self._refine = None          # (sorted_ids, pos, codes, books)
        self._refine_of = None       # the arrays the refine belongs to
        self._frozen_codes = False

    def add(self, x: np.ndarray, ids: np.ndarray | None = None) -> None:
        if self._frozen_codes:
            raise RuntimeError(
                "this IndexIVFPQR was loaded from exact codes; growing it "
                "requires the original vectors (re-add to a fresh index)")
        x = np.asarray(x, np.float32)
        if ids is None:
            ids = np.arange(self._ntotal, self._ntotal + x.shape[0],
                            dtype=np.int64)
        ids = np.asarray(ids, np.int64)
        self._raw_x = np.concatenate([self._raw_x, x], 0)
        self._raw_ids = np.concatenate([self._raw_ids, ids], 0)
        super().add(x, ids)

    def reset(self) -> None:
        super().reset()
        self._raw_x = np.zeros((0, self.d), np.float32)
        self._raw_ids = np.zeros((0,), np.int64)
        self._refine = None
        self._refine_of = None
        # an emptied index holds no frozen codes
        self._frozen_codes = False

    def _residual2(self, a, pos: torch.Tensor, src: np.ndarray
                   ) -> torch.Tensor:
        """x - first-stage reconstruction of the stored slots ``pos`` (flat
        [nlist * cap] positions) whose raw vectors are rows ``src``: the
        decode plus, for residual PQ, the list's centroid, bitwise the JAX
        package's ``decoded_db`` values."""
        x = torch.as_tensor(self._raw_x[src], device=self.device)
        return x - first_stage(a, pos)

    def _ensure_refine(self):
        """Train and encode the refine PQ against the current packed
        layout (the first PQ trains at pack time, so a repack retrains
        this one): (sorted stored ids on the host, their flat slots, their
        refine codes, the refine codebooks), the last three on the
        device."""
        a = self.arrays  # packs if needed
        if self._refine is not None and self._refine_of is a:
            return self._refine
        ids_flat = a.vec_ids.reshape(-1)
        pos_valid = torch.nonzero(ids_flat >= 0).squeeze(1)
        stored, order = torch.sort(ids_flat[pos_valid].long(), stable=True)
        pos = pos_valid[order].to(torch.int32)   # flat [nlist * cap] slot
        sorted_ids = stored.cpu().numpy()
        raw_order = np.argsort(self._raw_ids, kind="stable")
        raw_sorted = self._raw_ids[raw_order]
        idx = np.searchsorted(raw_sorted, sorted_ids)
        idx = np.clip(idx, 0, max(len(raw_sorted) - 1, 0))
        if not (len(raw_sorted) and np.array_equal(raw_sorted[idx],
                                                   sorted_ids)):
            raise RuntimeError("refine PQ: stored ids missing raw vectors")
        src = raw_order[idx]
        n = len(sorted_ids)
        nt = min(n, PQ_TRAIN_MAX)
        books = train_pq(self._residual2(a, pos[:nt], src[:nt]).cpu()
                         .numpy(), self.M_refine, device=self.device)
        codes = torch.empty((n, self.M_refine), dtype=torch.uint8,
                            device=self.device)
        for c0 in range(0, n, REFINE_CHUNK):
            c1 = min(c0 + REFINE_CHUNK, n)
            codes[c0:c1] = encode_pq(books, self._residual2(
                a, pos[c0:c1], src[c0:c1]))
        self._refine = (sorted_ids, pos, codes, books.codebooks)
        self._refine_of = a
        return self._refine

    def search(self, q: np.ndarray, k: int, nprobe: int | None = None):
        """k_factor * k IVFPQ candidates, re-ranked in one device pass
        (IndexIVFPQ.cpp IndexIVFPQR::search_preassigned)."""
        q = np.asarray(q, np.float32)
        if self.ntotal == 0:
            return (np.full((q.shape[0], k), np.inf, np.float32),
                    np.full((q.shape[0], k), -1, np.int64))
        sorted_ids, pos, codes, books = self._ensure_refine()
        # k2 >= k: the base search pads past ntotal with -1 (masked below)
        k2 = max(int(round(self.k_factor * k)), k)
        base_v, base_i = super().search(q, k2, nprobe)
        # candidate ids -> refine rows; a -1 pad maps to row 0, masked
        rows = np.searchsorted(sorted_ids, np.maximum(base_i, 0))
        rows = np.clip(rows, 0, len(sorted_ids) - 1)
        ok = (base_i >= 0) & (sorted_ids[rows] == np.maximum(base_i, 0))
        dev = self.device
        vals, sel = _rerank(self.arrays, self._q(q),
                            torch.as_tensor(rows, device=dev), pos, codes,
                            books, torch.as_tensor(ok, device=dev), k)
        sel = sel.cpu().numpy()
        ids = np.take_along_axis(base_i, sel, axis=1)
        ids = np.where(np.take_along_axis(ok, sel, axis=1), ids, -1)
        return vals.cpu().numpy(), ids

    def reconstruct(self, key: int) -> np.ndarray:
        return self.reconstruct_batch(np.asarray([key], np.int64))[0]

    def reconstruct_batch(self, keys: np.ndarray) -> np.ndarray:
        """Two-stage reconstructions (reference reconstruct_from_offset,
        IndexIVFPQ.cpp:1273-1282): the first stage is bitwise the base
        index's ``reconstruct``, plus the refine decode; KeyError for an
        id not stored."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        sorted_ids, pos, codes, books = self._ensure_refine()
        rows = np.searchsorted(sorted_ids, keys)
        if not np.array_equal(
                sorted_ids[np.clip(rows, 0, len(sorted_ids) - 1)], keys):
            raise KeyError("ids not stored")
        rows = torch.as_tensor(rows, device=self.device)
        return two_stage(self.arrays, pos[rows], codes[rows],
                         books).cpu().numpy()


def first_stage(a, pos: torch.Tensor) -> torch.Tensor:
    """First-stage reconstructions of flat slots ``pos`` [...]: the PQ
    decode plus, for residual PQ, the centroid of the list ``pos // cap``
    (the order of the JAX package's ``decoded_db``)."""
    pos = pos.long()
    rec = a.decode_block(a.db.reshape(-1, a.db.shape[-1])[pos])
    if a.pq_residual:
        rec = rec + a.centroids[pos // a.cap]
    return rec


def two_stage(a, pos: torch.Tensor, codes: torch.Tensor,
              books: torch.Tensor) -> torch.Tensor:
    """First stage plus the refine decode of ``codes`` [..., M_refine]."""
    return first_stage(a, pos) + decode_pq(PQCodebooks(books), codes)


def _rerank(arrays, q: torch.Tensor, rows: torch.Tensor, pos, codes, books,
            ok: torch.Tensor, k: int):
    """Both code stages of every candidate [B, K2] gathered and decoded,
    the fp32 L2 distance to the query, the -1 pads at inf, and a stable
    top-k: (values [B, k], candidate positions [B, k])."""
    rows = rows.long()
    recon = two_stage(arrays, pos[rows], codes[rows], books)
    diff = q[:, None, :] - recon
    dist = torch.where(ok, (diff * diff).sum(-1), float("inf"))
    vals, sel = torch.sort(dist, dim=1, stable=True)
    return vals[:, :k], sel[:, :k]
