"""Search an IVF index from disk without loading its lists (port of
``auncel_tpu/index/ondisk.py``).

Capability parity with the reference's ``OnDiskInvertedLists``
(``OnDiskInvertedLists.h:51``: mmap'd inverted lists and
``prefetch_lists``): the padded list tensor stays a memory-mapped ``.npy``
of a directory written by ``index/io.py::save_index_ondisk``; a search
pages only the lists its query batch probes, each once however many
queries probe it, into pinned host memory, uploads them as one compact
block batch (the vectors, their ids and the stored list sizes) with
non-blocking copies, and scans the batch on the device with K2 through
``scan_probe_range``. Host memory holds the centroids and the touched
pages, the card the centroids and one block batch, so a corpus larger than
the card is served at the cost of one upload a phase.

The blocks' norms are computed from the paged float32 vectors on the
device, as the JAX package computes them (it reads no stored norm). Each
block keeps its list's stored size: K2 reads only slots below it, so a
block without its size would read as empty. The block batch is as large
as the distinct lists paged, with no power-of-two bucket.
"""

import json
import os

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.scan import IVFArrays, scan_probe_range
from auncel_tpu_torch.ops.distance import pairwise_scores, sqnorms
from auncel_tpu_torch.ops.topk import init_topk, topk_scores
from auncel_tpu_torch.profile.bounded import bounded_search_decide_ranked
from auncel_tpu_torch.profile.geometry import n_boundaries
from auncel_tpu_torch.types import Metric


def _gather(src, rows: np.ndarray, out: np.ndarray) -> None:
    """out[i] = src[rows[i]]: numpy's take straight into ``out`` for an
    array or memmap (indexing the memmap is what pages the rows in);
    anything else that indexes like an array is indexed."""
    if isinstance(src, np.ndarray):
        np.take(src, rows, axis=0, out=out, mode="clip")
    else:
        out[:] = src[rows]


class OnDiskIVFIndex:
    """Read-only IVF-Flat index served from a directory written by
    ``save_index_ondisk``, on ``device`` (the card unless the caller says
    otherwise). Serves fixed-nprobe search and, after ``attach_profile``,
    per-query error-bounded search (the reference's OnDiskInvertedLists
    in the tune branch of search_preassigned, IndexIVF.cpp:497-673); each
    phase pages only the lists it scans."""

    def __init__(self, dirpath: str, device="cuda"):
        with open(os.path.join(dirpath, "header.json")) as f:
            self.header = json.load(f)
        if self.header["kind"] != "IVFFlatOnDisk":
            raise ValueError(f"{dirpath} holds kind {self.header['kind']!r}, "
                             "not an on-disk IVF directory")
        self.d = self.header["d"]
        self.nlist = self.header["nlist"]
        self.ntotal = self.header["ntotal"]
        self.metric = Metric.parse(self.header["metric"])
        self.device = resolve(device)
        # the lists stay on disk; indexing the memmaps pages them in
        self.db = np.load(os.path.join(dirpath, "db.npy"), mmap_mode="r")
        self.vec_ids = np.load(os.path.join(dirpath, "vec_ids.npy"),
                               mmap_mode="r")
        self.list_sizes = np.load(os.path.join(dirpath, "list_sizes.npy"))
        self.centroids = np.load(os.path.join(dirpath, "centroids.npy"))
        self._cents = torch.as_tensor(self.centroids, device=self.device)
        self._cent_sq = sqnorms(self._cents)
        # bounded-search state (attach_profile)
        self.traces = None
        self.multipler = 1.0
        self.std_m = 1.0
        self.max_topk = 100
        self._interdis = None

    def _q(self, q: np.ndarray) -> torch.Tensor:
        q = np.asarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(f"queries must be [n, {self.d}], got {q.shape}")
        return torch.as_tensor(q, device=self.device)

    def _coarse(self, q: torch.Tensor, nprobe: int):
        """The best ``nprobe`` lists of each query: (cdis, cids)."""
        scores = pairwise_scores(q, self._cents, self.metric,
                                 y_sqnorms=self._cent_sq)
        ids = torch.arange(self.nlist, dtype=torch.int32,
                           device=q.device).expand(scores.shape)
        return topk_scores(scores, ids, nprobe, self.metric)

    def _page(self, uniq: np.ndarray) -> tuple:
        """Page the lists ``uniq`` (sorted, distinct) from disk into host
        tensors, pinned when the index serves a card: (blocks [n, cap, d]
        f32, ids [n, cap] i32, sizes [n] i32), at least one block."""
        n = max(int(uniq.size), 1)
        cap = self.db.shape[1]
        pin = self.device.type == "cuda"
        alloc = torch.empty if uniq.size else torch.zeros  # rows written
        blocks = alloc((n, cap, self.d), dtype=torch.float32, pin_memory=pin)
        block_ids = torch.full((n, cap), -1, dtype=torch.int32,
                               pin_memory=pin)
        sizes = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
        if uniq.size:
            _gather(self.db, uniq, blocks.numpy())
            _gather(self.vec_ids, uniq, block_ids.numpy())
            sizes.numpy()[:] = self.list_sizes[uniq]
        return blocks, block_ids, sizes

    def _upload(self, host: tuple) -> tuple:
        """The paged batch on the index's device: non-blocking copies from
        pinned memory on the current stream."""
        return tuple(t.to(self.device, non_blocking=True) for t in host)

    def _page_blocks(self, lists: np.ndarray) -> tuple:
        """Page the distinct lists among ``lists`` and upload them as one
        block batch: (blocks, block_ids, block_sizes, uniq); block j holds
        list ``uniq[j]``."""
        uniq = np.unique(np.asarray(lists).ravel())
        uniq = uniq[uniq >= 0]
        return (*self._upload(self._page(uniq)), uniq)

    def _compact(self, blocks, block_ids, sizes, interdis=None) -> IVFArrays:
        """The block batch as padded arrays over the true centroids, with
        norms from the paged vectors (zero at padding)."""
        dev = blocks.device
        return IVFArrays(
            centroids=self._cents, cent_sq=self._cent_sq, db=blocks,
            db_sq=torch.where(block_ids >= 0, sqnorms(blocks), 0.0),
            vec_ids=block_ids, list_sizes=sizes,
            interdis=(interdis if interdis is not None else
                      torch.zeros((1, 1), dtype=torch.float32, device=dev)))

    def _scan_uploaded(self, blocks, block_ids, sizes, q, probe, nprobe: int,
                       k: int):
        """Device half of a fixed-nprobe search: the first ``nprobe`` slots
        of ``probe`` [B, nprobe] (block ids) for every query."""
        B = q.shape[0]
        vals, ids = init_topk((B,), k, self.metric, q.device)
        limit = torch.full((B,), nprobe, dtype=torch.int32, device=q.device)
        return scan_probe_range(self._compact(blocks, block_ids, sizes), q,
                                sqnorms(q), probe, vals, ids, limit, 0,
                                nprobe, self.metric)

    def _finish_uploaded(self, blocks, block_ids, sizes, q, q_sq, scan_slots,
                         vals, ids, target, start: int, width: int):
        """Phase B of bounded search: probe slots [start, start + width) of
        each query's ranking, mapped to blocks by ``scan_slots``, under
        its limit ``target``."""
        return scan_probe_range(self._compact(blocks, block_ids, sizes), q,
                                q_sq, scan_slots, vals, ids, target, start,
                                width, self.metric)

    def attach_profile(self, traces, multipler: float = 1.0,
                       std_m: float = 1.0, max_topk: int = 100) -> None:
        """Bind a trained phi -> U profile for error-bounded serving:
        ``traces`` is an ErrorSys's TraceSet or a path ``save_trace_set``
        wrote. The inter-centroid matrix is computed from the resident
        centroids (the lists stay on disk)."""
        from auncel_tpu_torch.index.ivf import compute_interdis
        if isinstance(traces, str):
            from auncel_tpu_torch.profile.trace import load_trace_set
            traces = load_trace_set(traces, self.device)
        self.traces = traces
        self.multipler = float(multipler)
        self.std_m = float(std_m)
        self.max_topk = int(max_topk)
        if self._interdis is None:
            self._interdis = torch.as_tensor(
                compute_interdis(self.centroids, self.metric, self.device),
                device=self.device)

    def search_bounded(self, q: np.ndarray, require_acc: np.ndarray,
                       query_k: int):
        """Per-query error-bounded search served from disk, in two phases:
        the decision phase pages the lists of each query's ranking prefix
        (nlist/8 probe slots and the boundary window), then phase B pages
        only the lists of each query's decided budget past the prefix.
        Decisions and ids are the resident padded engine's; values agree
        within 1e-5. Returns numpy (vals [B, query_k], ids, n_scanned):
        n_scanned is min(max(my_nprobe, decided_at), nlist), the lists
        each query scanned."""
        assert self.traces is not None, "attach_profile first"
        qd = self._q(q)
        B, nlist, dev = qd.shape[0], self.nlist, self.device
        rank_k = max(min(nlist, n_boundaries(nlist) + 1),
                     min(nlist, nlist // 8))
        cdis, cids = self._coarse(qd, rank_k)
        cids_np = cids.cpu().numpy()
        blocks, block_ids, sizes, uniq = self._page_blocks(cids_np)
        slots = torch.as_tensor(
            np.searchsorted(uniq, cids_np).astype(np.int32), device=dev)
        f32 = torch.float32
        vals, ids, my_np, decided_at, _, q_sq = bounded_search_decide_ranked(
            self._compact(blocks, block_ids, sizes, self._interdis),
            self.traces, qd,
            torch.as_tensor(np.asarray(require_acc, np.float32), device=dev),
            torch.tensor(self.multipler, dtype=f32, device=dev),
            torch.tensor(self.std_m, dtype=f32, device=dev),
            cdis, cids, slots, query_k, self.max_topk, self.metric)
        del blocks, block_ids, sizes   # the phase's batch, before phase B's
        target = torch.maximum(my_np, decided_at).clamp_max(nlist)
        target = target.cpu().numpy().astype(np.int32)
        cap_stage = nlist // 8
        if np.any(target > cap_stage):
            width = int(target.max()) - cap_stage
            _, cids_f = self._coarse(qd, cap_stage + width)
            cids_f = cids_f.cpu().numpy()
            # page only the tail slots some query scans
            tail = [cids_f[r, cap_stage:target[r]]
                    for r in range(B) if target[r] > cap_stage]
            blocks, block_ids, sizes, uniq = self._page_blocks(
                np.concatenate(tail))
            t = cids_f[:, cap_stage:]
            pos = np.clip(np.searchsorted(uniq, t), 0, max(uniq.size - 1, 0))
            # a slot a query never scans (>= its target) maps to block 0;
            # its limit masks it before any distance counts
            sl2 = np.zeros((B, cap_stage + width), np.int32)
            sl2[:, cap_stage:] = np.where(uniq[pos] == t, pos, 0)
            vals, ids = self._finish_uploaded(
                blocks, block_ids, sizes, qd, q_sq,
                torch.as_tensor(sl2, device=dev), vals, ids,
                torch.as_tensor(target, device=dev), cap_stage, width)
        return (vals[:, :query_k].cpu().numpy(),
                ids[:, :query_k].cpu().numpy().astype(np.int64), target)

    def search(self, q: np.ndarray, k: int, nprobe: int = 8):
        """Fixed-nprobe search: rank the centroids on the device, page and
        upload the distinct probed lists, scan them. Never reads a list the
        batch does not probe. Returns numpy (vals [B, k], ids)."""
        qd = self._q(q)
        nprobe = min(nprobe, self.nlist)
        _, cids = self._coarse(qd, nprobe)
        cids = cids.cpu().numpy()
        blocks, block_ids, sizes, uniq = self._page_blocks(cids)
        probe = torch.as_tensor(np.searchsorted(uniq, cids).astype(np.int32),
                                device=self.device)
        vals, ids = self._scan_uploaded(blocks, block_ids, sizes, qd, probe,
                                        nprobe, k)
        return vals.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
