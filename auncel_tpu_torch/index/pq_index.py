"""Standalone product-quantizer index (port of
``auncel_tpu/index/pq_index.py``; reference ``IndexPQ.{h,cpp}``).

Vectors are stored as M-byte PQ codes and searched by asymmetric distance:
decode a block of codes and contract it with the queries (the same values
as a table-based ADC, since the subspaces partition the dimensions), with
the optional polysemous filter (``IndexPQ.h:24``: codebooks reordered so
that code Hamming distance tracks codeword distance; a code more than
``ht`` bits from the query's code is dropped). The code-domain search
types (Hamming, generalized Hamming, symmetric distance) scan the codes
alone. The JAX package computes these scans with XLA, not a Pallas
kernel; here they are plain PyTorch, a block of codes at a time, on the
index's device.
"""

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.index.scan import popcount8
from auncel_tpu_torch.ops.pq import (PQCodebooks, decode_pq, encode_pq,
                                     train_pq)
from auncel_tpu_torch.ops.polysemous import reorder_codebook
from auncel_tpu_torch.ops.topk import init_topk, topk_scores
from auncel_tpu_torch.types import Metric, worst_value

BLOCK = 4096   # codes a scan step


def _block_ids(b0: int, n: int, B: int, dev) -> torch.Tensor:
    return torch.arange(b0, b0 + n, dtype=torch.int32,
                        device=dev).expand(B, n)


def _pq_scan(pq: PQCodebooks, codes: torch.Tensor, q: torch.Tensor,
             qcodes: torch.Tensor, ht: int, k: int, metric: Metric):
    """Blocked ADC scan (decode, fp32 product, exact merge) with the
    Hamming filter when ``ht`` > 0 (``auncel_tpu/index/pq_index.py:35-73``).
    """
    B = q.shape[0]
    worst = worst_value(metric)
    q_sq = (q * q).sum(-1)
    vals, ids = init_topk((B,), k, metric, q.device)
    for b0 in range(0, codes.shape[0], BLOCK):
        blk = codes[b0:b0 + BLOCK]
        rec = decode_pq(pq, blk)                          # [n, d]
        dots = q @ rec.T
        if metric is Metric.L2:
            scores = (q_sq[:, None] + (rec * rec).sum(-1)[None]
                      - 2.0 * dots).clamp_min(0.0)
        else:
            scores = dots
        bids = _block_ids(b0, blk.shape[0], B, q.device)
        if ht > 0:
            ham = popcount8(blk[None] ^ qcodes[:, None, :]).sum(
                -1, dtype=torch.int32)
            keep = ham <= ht
            scores = torch.where(keep, scores, worst)
            bids = torch.where(keep, bids, -1)
        vals, ids = topk_scores(torch.cat([vals, scores], -1),
                                torch.cat([ids, bids], -1), k, metric)
    return vals, ids


def _code_scan(codes: torch.Tensor, qcodes: torch.Tensor,
               qrows: torch.Tensor | None, k: int, mode: str):
    """Blocked code-domain scan (``auncel_tpu/index/pq_index.py:75-114``,
    reference IndexPQ.h:75-82): "he" bit Hamming over the M code bytes,
    "ghe" the count of differing sub-codes, "sdc" the symmetric PQ
    distance summed from the query codes' rows ``qrows`` [B, M, 256] of the
    SDC tables. All rank ascending."""
    B, M = qcodes.shape
    vals, ids = init_topk((B,), k, Metric.L2, qcodes.device)
    for b0 in range(0, codes.shape[0], BLOCK):
        blk = codes[b0:b0 + BLOCK]
        if mode == "sdc":
            # the table entry of each stored sub-code: a gather of the
            # one-hot product the JAX package contracts
            idx = blk.long().T[None].expand(B, M, blk.shape[0])
            scores = torch.gather(qrows, 2, idx).sum(1)
        else:
            diff = blk[None] ^ qcodes[:, None, :]             # [B, n, M]
            if mode == "he":
                scores = popcount8(diff).sum(-1, dtype=torch.int32).float()
            else:
                scores = (diff != 0).sum(-1, dtype=torch.int32).float()
        bids = _block_ids(b0, blk.shape[0], B, qcodes.device)
        vals, ids = topk_scores(torch.cat([vals, scores], -1),
                                torch.cat([ids, bids], -1), k, Metric.L2)
    return vals, ids


class IndexPQ(Index):
    """``search_type`` as the reference's enum (IndexPQ.h:75-82): "pq"
    (ADC, the default), "he" / "ghe" ((generalized) Hamming over the
    codes), "sdc" (symmetric PQ distance), "polysemous" (ADC with the
    Hamming prefilter; needs ``polysemous=True`` training and ht > 0)."""

    SEARCH_TYPES = ("pq", "he", "ghe", "sdc", "polysemous")

    def __init__(self, d: int, M: int = 8, metric: Metric = Metric.L2,
                 polysemous: bool = False, polysemous_ht: int = 0,
                 search_type: str = "pq", device="cuda"):
        assert search_type in self.SEARCH_TYPES, search_type
        self.search_type = search_type
        self.d = d
        self.M = M
        self.metric = Metric.parse(metric)
        self.device = resolve(device)
        self.polysemous = polysemous
        self.polysemous_ht = polysemous_ht  # 0 = filter off (IndexPQ.h:24)
        self.pq: PQCodebooks | None = None
        self.is_trained = False
        self._codes = np.zeros((0, M), np.uint8)
        self._dev = None
        self._sdc = None

    @property
    def ntotal(self) -> int:
        return self._codes.shape[0]

    def train(self, x: np.ndarray, sa_iters: int = 30_000) -> None:
        x = np.asarray(x, np.float32)
        self.pq = train_pq(x, self.M, device=self.device)
        if self.polysemous:
            # each subquantizer reordered so that Hamming distance tracks
            # codeword distance (PolysemousTraining::optimize_pq_for_hamming)
            books = self.pq.codebooks.cpu().numpy()
            out = np.empty_like(books)
            for m in range(self.M):
                perm = reorder_codebook(books[m], n_iter=sa_iters,
                                        seed=123 + m)
                out[m, perm] = books[m]
            self.pq = PQCodebooks(torch.as_tensor(out, device=self.device))
        self._sdc = None  # the SDC tables follow the codebooks
        self.is_trained = True

    def add(self, x: np.ndarray, ids=None) -> None:
        assert ids is None, "IndexPQ stores sequential ids"
        assert self.is_trained, "train before add"
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        codes = encode_pq(self.pq, x).cpu().numpy()
        self._codes = np.concatenate([self._codes, codes], 0)
        self._dev = None

    def reset(self) -> None:
        self._codes = np.zeros((0, self.M), np.uint8)
        self._dev = None

    def _sdc_table(self) -> torch.Tensor:
        """[M, 256, 256] per-subspace squared-L2 codeword tables (reference
        ProductQuantizer::compute_sdc_table), built once per codebook."""
        if self._sdc is None:
            cb = self.pq.codebooks                         # [M, 256, d/M]
            sq = (cb * cb).sum(-1)
            dots = torch.bmm(cb, cb.transpose(1, 2))
            self._sdc = (sq[:, :, None] + sq[:, None, :]
                         - 2.0 * dots).clamp_min(0.0)
        return self._sdc

    def search(self, q: np.ndarray, k: int, ht: int | None = None,
               search_type: str | None = None):
        """Search under ``search_type`` (default: the constructor's). For
        "pq" and "polysemous", ``ht`` > 0 applies the Hamming prefilter
        (reference search_core_polysemous)."""
        st = search_type or self.search_type
        assert st in self.SEARCH_TYPES, st
        ht = self.polysemous_ht if ht is None else ht
        if self._dev is None:   # the codes on the device, until add/reset
            self._dev = torch.as_tensor(self._codes, device=self.device)
        qd = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        qcodes = encode_pq(self.pq, qd)
        if st in ("he", "ghe", "sdc"):
            qrows = None
            if st == "sdc":
                if self.metric is not Metric.L2:
                    raise ValueError("ST_SDC is an L2 capability "
                                     "(IndexPQ.cpp search_core_sdc)")
                m = torch.arange(self.M, device=self.device)[None, :]
                qrows = self._sdc_table()[m, qcodes.long()]  # [B, M, 256]
            vals, ids = _code_scan(self._dev, qcodes, qrows, k, st)
        else:
            vals, ids = _pq_scan(self.pq, self._dev, qd, qcodes,
                                 int(ht) if ht and ht > 0 else 0, k,
                                 self.metric)
        return vals.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
