"""HNSW graph index (port of ``auncel_tpu/index/hnsw.py``; the reference's
``HNSW.h``/``HNSW.cpp`` and ``IndexHNSW.{h,cpp}``).

A hierarchical navigable small-world graph: levels drawn geometrically
(level = floor(-ln U / ln M), 2M links at level 0 and M above), a greedy
descent through the upper levels, an ef-bounded exploration of level 0,
and the occlusion heuristic for neighbour selection (keep a candidate only
while it is closer to the point than to every neighbour kept before it).

As in the JAX package, search is one batched program: each query keeps a
sorted top-ef candidate buffer with expansion flags, and every step
expands the best unexpanded candidate of every query at once (gather its
neighbours, one fp32 distance block, merge with an (id, flag) dedup sort
and a stable distance sort). A query whose best unexpanded candidate is no
better than its ef-th result stops. The build inserts points in batches
that double with the graph (8 up to 16384), each searched against the
graph built so far (points inside a batch do not see each other); the
links are set on the host (forward edges, reverse edges with an occlusion
re-prune of rows that overflow), then every level is made reachable from
the entry point and one or more refinement passes re-link every node
against the finished graph.

Everything on the device is plain torch: gathers, ``bmm``, and stable
sorts, so ties keep the JAX package's order (``jnp.argsort`` is stable;
``argmin``/``argmax`` take the first occurrence in both). Distances sum
the float32 vectors in float64 and round once to float32: the card's
and the CPU's fp32 sums run in other orders, and an ulp between two
candidates would send a search (or a build) down another path on each;
the JAX package sums in fp32, within 1e-5 of these values. The JAX package's fixed-trip ``fori_loop``s are
device loops here with no host sync a step; every ``EXIT_CHECK`` steps one
sync asks whether any query still moves, and the loop ends when none does
(a step that moves no query leaves the state as it is, so the results are
the fixed loop's). The JAX package pads each insertion batch and
refinement chunk to a power-of-two bucket (one XLA compile a bucket); the
port runs each batch at its own size, with the same batch sizes.

Compressed storage (``IndexHNSWSQ``, ``IndexHNSWPQ``, ``IndexHNSW2Level``)
keeps its codes on the device and decodes them at every gather
(``storage_decode``); the host mirror ``_xb`` holds the decoded vectors,
so the host's graph surgery sees the device's values. Files are the JAX
package's ``.npz`` layout: either package reads the other's.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.ops.pq import PQCodebooks, decode_pq, encode_pq, train_pq
from auncel_tpu_torch.types import Metric, worst_value

# insertion batches double with the graph (a batch never exceeds the frozen
# graph it searches), capped to bound device memory a step
BUILD_BATCH_MIN = 8
BUILD_BATCH_MAX = 16384
DESCENT_ITERS = 16       # greedy steps a level (the walk is O(log N))
EXIT_CHECK = 8           # device-loop steps between "does any query move?"
_BIG = 2_147_000_000     # sort key of an empty candidate slot


def _better(a, b, metric: Metric):
    return a < b if metric.lower_is_better else a > b


def _arg_best(d: torch.Tensor, metric: Metric) -> torch.Tensor:
    """The first best position along the last axis."""
    return d.argmin(-1) if metric.lower_is_better else d.argmax(-1)


def _block_dist(q: torch.Tensor, blocks: torch.Tensor,
                metric: Metric) -> torch.Tensor:
    """q [B, d] against blocks [B, K, d] -> [B, K] float32 metric values:
    L2 from the block norms computed here, ``max(q_sq + sum x^2 - 2 dot,
    0)``, in the JAX package's order. The float32 inputs are summed in
    float64 (their products are exact there) and the value rounded once
    to float32, so the card and the CPU give one value whatever order
    their fp32 sums would take, and a search or a build walks the same
    graph on both."""
    q, blocks = q.double(), blocks.double()
    dots = torch.bmm(blocks, q[:, :, None])[..., 0]
    if metric is Metric.L2:
        dots = ((q * q).sum(-1)[:, None] + (blocks * blocks).sum(-1)
                - 2.0 * dots).clamp_min(0.0)
    return dots.float()


class HNSWCodec(NamedTuple):
    """Device-storage codec of the compressed variants (reference
    IndexHNSWSQ / IndexHNSWPQ / IndexHNSW2Level): SQ8 (``scale`` and
    ``bias`` [d]), PQ (``books`` [M, 256, d/M]), or two-level codes
    (``books`` and ``centroids`` [nlist, d]: 4 little-endian bytes of the
    coarse list id, then the PQ code of the residual)."""
    scale: torch.Tensor | None = None
    bias: torch.Tensor | None = None
    books: torch.Tensor | None = None
    centroids: torch.Tensor | None = None


def storage_decode(x: torch.Tensor, codec: HNSWCodec | None) -> torch.Tensor:
    """A gathered storage block [..., width] -> float32 vectors [..., d]."""
    if codec is None:
        return x
    if codec.centroids is not None:
        b = x[..., :4].long()
        lid = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (
            b[..., 3] << 24)
        return codec.centroids[lid] + decode_pq(PQCodebooks(codec.books),
                                                x[..., 4:])
    if codec.books is not None:
        return decode_pq(PQCodebooks(codec.books), x)
    # two roundings, as the host mirror's numpy decode
    return x.to(torch.float32) * codec.scale + codec.bias


def _gather_dist(xb, ids, q, metric: Metric, codec):
    """Distances of q [B, d] to the stored vectors ids [B, K] (clamped at
    0; the caller masks the invalid ones)."""
    return _block_dist(q, storage_decode(xb[ids.clamp_min(0)], codec), metric)


def greedy_descent(xb, table, g2u, q, cur, cur_d, iters: int,
                   metric: Metric, codec: HNSWCodec | None = None):
    """Reference ``greedy_update_nearest``: each query moves to its best
    neighbour while that improves, for at most ``iters`` steps."""
    worst = worst_value(metric)
    for it in range(iters):
        up = g2u[cur]
        nbrs = table[up.clamp_min(0)]                          # [B, M]
        valid = (nbrs >= 0) & (up >= 0)[:, None]
        d = torch.where(valid, _gather_dist(xb, nbrs, q, metric, codec),
                        worst)
        j = _arg_best(d, metric)[:, None]
        bd = d.gather(1, j)[:, 0]
        better = _better(bd, cur_d, metric)
        cur = torch.where(better, nbrs.gather(1, j)[:, 0], cur)
        cur_d = torch.where(better, bd, cur_d)
        if (it + 1) % EXIT_CHECK == 0 and not bool(better.any()):
            break
    return cur, cur_d


def beam_search(xb, table, g2u, q, entry, entry_d, ef: int, iters: int,
                metric: Metric, codec: HNSWCodec | None = None):
    """ef-bounded exploration (reference ``search_from_candidates``) for
    at most ``iters`` expansions. Returns (cand_ids [B, ef] int64,
    cand_d [B, ef]) sorted best-first, -1 and the worst value past the
    candidates found."""
    B, dev = q.shape[0], q.device
    worst = worst_value(metric)
    sign = 1.0 if metric.lower_is_better else -1.0
    cand_ids = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
    cand_ids[:, 0] = entry
    cand_d = torch.full((B, ef), worst, dtype=torch.float32, device=dev)
    cand_d[:, 0] = entry_d
    expanded = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for it in range(iters):
        unexp = ~expanded & (cand_ids >= 0)
        pos = unexp.to(torch.int32).argmax(1)       # best unexpanded
        dpos = cand_d.gather(1, pos[:, None])[:, 0]
        # stop rule: the best unexpanded is no better than the ef-th result
        # (check_relative_distance, HNSW.cpp search_from_candidates)
        active = unexp.any(1) & (_better(dpos, cand_d[:, -1], metric)
                                 | (cand_ids[:, -1] < 0))
        node = cand_ids.gather(1, pos[:, None])[:, 0]
        up = g2u[node.clamp_min(0)]
        nbrs = table[up.clamp_min(0)]                          # [B, K]
        valid = (nbrs >= 0) & (up >= 0)[:, None] & active[:, None]
        nd = torch.where(valid, _gather_dist(xb, nbrs, q, metric, codec),
                         worst)
        nbrs = torch.where(valid, nbrs, -1)
        expanded[rows, pos] |= active
        # merge + dedup: sorted by (id, expanded first), the surviving
        # copy of a revisited node keeps its flag
        ids_all = torch.cat([cand_ids, nbrs], 1)
        d_all = torch.cat([cand_d, nd], 1)
        exp_all = torch.cat([expanded, torch.zeros_like(valid)], 1)
        key = torch.where(ids_all >= 0, ids_all * 2 + (~exp_all).long(), _BIG)
        order = torch.sort(key, dim=1, stable=True).indices
        ids_s, d_s = ids_all.gather(1, order), d_all.gather(1, order)
        exp_s = exp_all.gather(1, order)
        dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                         ids_s[:, 1:] == ids_s[:, :-1]], 1)
        bad = dup | (ids_s < 0)
        d_s = torch.where(bad, worst, d_s)
        ids_s = torch.where(bad, -1, ids_s)
        order2 = torch.sort(sign * d_s, dim=1, stable=True).indices[:, :ef]
        cand_ids, cand_d = ids_s.gather(1, order2), d_s.gather(1, order2)
        expanded = exp_s.gather(1, order2)
        if (it + 1) % EXIT_CHECK == 0 and not bool(active.any()):
            break
    return cand_ids, cand_d


def _merge_ranked(ids_a, d_a, ids_b, d_b, self_ids, out_k: int,
                  metric: Metric):
    """Two candidate sets a row merged, duplicates and self-links dropped:
    the best ``out_k`` best-first."""
    B, dev = ids_a.shape[0], ids_a.device
    worst = worst_value(metric)
    sign = 1.0 if metric.lower_is_better else -1.0
    ids_all = torch.cat([ids_a, ids_b], 1)
    d_all = torch.cat([d_a, d_b], 1)
    bad = (ids_all < 0) | (ids_all == self_ids[:, None])
    order = torch.sort(torch.where(bad, _BIG, ids_all), dim=1,
                       stable=True).indices
    ids_s, d_s = ids_all.gather(1, order), d_all.gather(1, order)
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                     ids_s[:, 1:] == ids_s[:, :-1]], 1)
    bad2 = dup | (ids_s < 0) | (ids_s == self_ids[:, None])
    d_s = torch.where(bad2, worst, d_s)
    ids_s = torch.where(bad2, -1, ids_s)
    order2 = torch.sort(sign * d_s, dim=1, stable=True).indices[:, :out_k]
    return ids_s.gather(1, order2), d_s.gather(1, order2)


def heuristic_keep(xb, cand_ids, cand_d, M: int, metric: Metric,
                   codec: HNSWCodec | None = None) -> torch.Tensor:
    """The occlusion heuristic (``shrink_neighbor_list``) over candidates
    [Q, K] sorted best-first: walking them nearest first, keep v iff
    dist(point, v) beats dist(v, s) for every kept s, up to M. Returns the
    keep mask [Q, K]."""
    Q, K = cand_ids.shape
    vecs = storage_decode(xb[cand_ids.clamp_min(0)], codec).double()
    pair = torch.bmm(vecs, vecs.transpose(1, 2))     # float64, as _block_dist
    if metric is Metric.L2:
        sq = (vecs * vecs).sum(-1)
        pair = sq[:, :, None] + sq[:, None, :] - 2.0 * pair
    pair = pair.float()
    keep = torch.zeros((Q, K), dtype=torch.bool, device=cand_ids.device)
    # occl[q, v]: the best distance from candidate v to a kept neighbour
    occl = torch.full((Q, K), worst_value(metric), dtype=torch.float32,
                      device=cand_ids.device)
    kept = torch.zeros((Q,), dtype=torch.int64, device=cand_ids.device)
    for r in range(K):
        ok = ((cand_ids[:, r] >= 0) & (kept < M)
              & _better(cand_d[:, r], occl[:, r], metric))
        keep[:, r] = ok
        upd = _better(pair[:, r, :], occl, metric) & ok[:, None]
        occl = torch.where(upd, pair[:, r, :], occl)
        kept = kept + ok
    return keep


def _sorted_by_dist(xb, qv, cand: np.ndarray, metric: Metric, codec):
    """Candidate rows [n, K] (-1 padded) sorted by their distance to qv
    [n, d] (stable): (ids, distances) on the device."""
    c = torch.as_tensor(cand, device=qv.device).long()
    d = torch.where(c >= 0, _gather_dist(xb, c, qv, metric, codec),
                    worst_value(metric))
    sign = 1.0 if metric.lower_is_better else -1.0
    order = torch.sort(sign * d, dim=1, stable=True).indices
    return c.gather(1, order), d.gather(1, order)


class HNSWIndex(Index):
    """Standalone HNSW index over raw vectors (reference IndexHNSWFlat), on
    ``device`` (the card unless the caller passes another)."""

    def __init__(self, d: int, M: int = 32, metric: Metric = Metric.L2,
                 ef_construction: int = 40, ef_search: int = 16,
                 seed: int = 1234, refine_passes: int = 1, device="cuda"):
        self.d = d
        self.M = int(M)
        self.metric = Metric.parse(metric)
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)
        self.refine_passes = int(refine_passes)
        self.level_mult = 1.0 / np.log(self.M)  # set_default_probas
        self.rng = np.random.RandomState(seed)
        self.device = resolve(device)
        self.is_trained = True
        self._xb = np.zeros((0, d), np.float32)
        self._built = False
        self._codec: HNSWCodec | None = None  # compressed-storage decode
        # optional refined re-rank hook (reference IndexHNSW.h:80)
        self.reconstruct_from_neighbors = None
        # graph state: host tables, and their device copies in _dev
        self.levels: np.ndarray | None = None
        self.entry_point = -1
        self.max_level = -1
        self.nb_tables: list = []    # per level: [n_l, K] int32 global ids
        self.g2u: list = []          # per level: [N] int32 -> row or -1
        self._dev = None             # (storage, [(table, g2u)] per level)
        self._storage = None         # device storage, kept until add/reset
        # seconds of the last build: insert, repair, refine
        self.build_times: dict = {}

    # ------------------------------------------------------------- state

    @property
    def ntotal(self) -> int:
        return self._xb.shape[0]

    def train(self, x):
        pass

    def add(self, x: np.ndarray, ids=None) -> None:
        assert ids is None, "HNSWIndex stores sequential ids"
        x = np.asarray(x, np.float32)
        assert x.shape[1] == self.d
        self._xb = np.concatenate([self._xb, x], 0)
        self._storage = None
        self._built = False

    def reset(self):
        self._xb = np.zeros((0, self.d), np.float32)
        self._built = False
        self._dev = None
        self._storage = None

    def _caps(self, level: int) -> int:
        return 2 * self.M if level == 0 else self.M

    def _device_storage(self) -> np.ndarray:
        """What the device holds as the vector table: the raw vectors, or
        the compressed variants' codes (decoded at gather)."""
        return self._xb

    def _push_dev(self):
        """Copy the host tables (and, after an add, the storage) to the
        device; the copies stay frozen while the host edits its tables."""
        if self._storage is None:
            self._storage = torch.tensor(self._device_storage(),
                                         device=self.device)
        self._dev = (self._storage,
                     [(torch.tensor(t, dtype=torch.int64, device=self.device),
                       torch.tensor(g, dtype=torch.int64, device=self.device))
                      for t, g in zip(self.nb_tables, self.g2u)])

    def _entry_dist(self, q: torch.Tensor) -> tuple:
        """Every query at the entry point, with its distance."""
        cur = torch.full((q.shape[0],), self.entry_point, dtype=torch.int64,
                         device=self.device)
        return cur, _gather_dist(self._dev[0], cur[:, None], q, self.metric,
                                 self._codec)[:, 0]

    # ------------------------------------------------------------- build

    def build(self) -> None:
        """(Re)build the graph over the stored vectors in frozen-graph
        batches; ``build_times`` gets the seconds of the insertion, the
        connectivity repair and the refinement."""
        n = self.ntotal
        if n == 0:
            self._built = True
            return
        t0 = time.perf_counter()
        levels = np.floor(-np.log(np.maximum(
            self.rng.rand(n), 1e-12)) * self.level_mult).astype(np.int64)
        self.levels = levels
        self.max_level = int(levels.max())
        self.entry_point = int(np.argmax(levels))
        self.nb_tables = []
        self.g2u = []
        for l in range(self.max_level + 1):
            members = np.where(levels >= l)[0].astype(np.int32)
            g2u = np.full(n, -1, np.int32)
            g2u[members] = np.arange(members.size, dtype=np.int32)
            self.nb_tables.append(
                np.full((members.size, self._caps(l)), -1, np.int32))
            self.g2u.append(g2u)

        # the entry point seeds the graph alone; everything else inserts in
        # growing frozen-graph batches
        rest = np.arange(n, dtype=np.int64)
        rest = rest[rest != self.entry_point]
        self._push_dev()
        self._insert_batch(np.asarray([self.entry_point], np.int64))
        done = 0
        while done < rest.size:
            bs = min(max(BUILD_BATCH_MIN, done + 1), BUILD_BATCH_MAX)
            self._insert_batch(rest[done:done + bs])
            done += bs
        self._built = True
        t1 = time.perf_counter()
        for l in range(self.max_level + 1):
            self._repair_connectivity(l)
        self._push_dev()
        t2 = time.perf_counter()
        if self.refine_passes:
            self.refine(self.refine_passes)
        self.build_times = {"insert": t1 - t0, "repair": t2 - t1,
                            "refine": time.perf_counter() - t2}

    def refine(self, passes: int = 1, ef: int | None = None,
               batch: int = 8192) -> None:
        """Re-search the finished graph for every node, re-select its
        neighbours from (beam candidates and current links) with the
        occlusion heuristic, then add them with their reverse edges
        (``_rebuild_level``): the edges the frozen batches missed (points
        of one batch never link to each other)."""
        assert self._built
        if self.ntotal <= 1:
            return
        ef = int(ef if ef is not None else
                 max(self.ef_construction, 2 * self.M, 64))
        worst = worst_value(self.metric)
        for _ in range(passes):
            xb_d, tables_d = self._dev
            for l in range(self.max_level + 1):
                members = np.where(self.levels >= l)[0].astype(np.int64)
                if members.size <= 1:
                    continue
                table = self.nb_tables[l]
                g2u = self.g2u[l]
                sel_all = np.full((members.size, self.M), -1, np.int32)
                for c0 in range(0, members.size, batch):
                    chunk = members[c0:c0 + batch]
                    q = torch.as_tensor(self._xb[chunk], device=self.device)
                    cur, cur_d = self._entry_dist(q)
                    for lv in range(self.max_level, l, -1):
                        tb, gg = tables_d[lv]
                        cur, cur_d = greedy_descent(
                            xb_d, tb, gg, q, cur, cur_d, DESCENT_ITERS,
                            self.metric, self._codec)
                    tb, gg = tables_d[l]
                    cand_ids, cand_d = beam_search(
                        xb_d, tb, gg, q, cur, cur_d, ef, ef, self.metric,
                        self._codec)
                    nbrs = torch.as_tensor(table[g2u[chunk]],
                                           device=self.device).long()
                    nd = torch.where(nbrs >= 0, _gather_dist(
                        xb_d, nbrs, q, self.metric, self._codec), worst)
                    m_ids, m_d = _merge_ranked(
                        cand_ids, cand_d, nbrs, nd,
                        torch.as_tensor(chunk, device=self.device), ef,
                        self.metric)
                    keep = heuristic_keep(xb_d, m_ids, m_d, self.M,
                                          self.metric, self._codec)
                    m_np, k_np = m_ids.cpu().numpy(), keep.cpu().numpy()
                    for i in range(chunk.size):
                        s = m_np[i][k_np[i] & (m_np[i] >= 0)][: self.M]
                        sel_all[c0 + i, : s.size] = s
                self._rebuild_level(l, members, sel_all)
            for l in range(self.max_level + 1):
                # the overflow re-prune can strand outliers again
                self._repair_connectivity(l)
            self._push_dev()

    def _repair_connectivity(self, level: int = 0,
                             max_rounds: int = 8) -> int:
        """Make every node of the level reachable from the entry point: a
        BFS over out-edges, then an edge to each unreachable node from its
        nearest reachable one (into a free slot, else replacing that row's
        worst link not written by this repair). Returns the edges added."""
        table = self.nb_tables[level]
        g2u = self.g2u[level]
        members = np.where(self.levels >= level)[0].astype(np.int64)
        if members.size <= 1:
            return 0
        xb = self._xb
        added = 0
        # slots written by this call are protected from replacement:
        # outliers often share their nearest anchor
        protected: set = set()
        for _ in range(max_rounds):
            seen = np.zeros(self.ntotal, bool)
            frontier = np.asarray([self.entry_point], np.int64)
            seen[frontier] = True
            while frontier.size:
                nxt = table[g2u[frontier]].ravel()
                nxt = np.unique(nxt[nxt >= 0])
                nxt = nxt[~seen[nxt]]
                seen[nxt] = True
                frontier = nxt
            unreach = members[~seen[members]]
            if unreach.size == 0:
                break
            reach = members[seen[members]]
            # nearest reachable node a unreachable one: [chunk, |reach|]
            # score blocks on the device
            # (float64 sums rounded to float32, as _block_dist)
            rr = torch.as_tensor(xb[reach], device=self.device).double()
            rr_sq = (rr * rr).sum(1)
            j = np.empty(unreach.size, np.int64)
            for c0 in range(0, unreach.size, 1024):
                xu = torch.as_tensor(xb[unreach[c0:c0 + 1024]],
                                     device=self.device).double()
                dots = xu @ rr.T
                if self.metric.lower_is_better:
                    sc = (xu * xu).sum(1)[:, None] + rr_sq - 2.0 * dots
                    j[c0:c0 + 1024] = sc.float().argmin(1).cpu().numpy()
                else:
                    j[c0:c0 + 1024] = dots.float().argmax(1).cpu().numpy()
            for ui, u in enumerate(unreach):
                r = int(reach[j[ui]])
                row = g2u[r]
                lst = table[row]
                free = np.where(lst < 0)[0]
                if free.size:
                    slot = int(free[0])
                else:
                    # replace the worst unprotected neighbour by the index
                    # metric (numpy's sort, as the JAX package calls it)
                    if self.metric.lower_is_better:
                        dr = ((xb[lst] - xb[r]) ** 2).sum(1)
                        order = np.argsort(dr)[::-1]   # farthest first
                    else:
                        dr = xb[lst] @ xb[r]
                        order = np.argsort(dr)          # lowest IP first
                    cand = [int(s) for s in order
                            if (row, int(s)) not in protected]
                    if not cand:
                        continue  # row saturated by repairs; next round
                    slot = cand[0]
                table[row, slot] = u
                protected.add((row, slot))
                added += 1
        return added

    def _rebuild_level(self, level: int, members: np.ndarray,
                       sel: np.ndarray) -> None:
        """Add the refined selections and their reverse edges to the
        level's links; only rows past the level's cap are re-pruned with
        the occlusion heuristic (additive: a wholesale replace loses links
        the incremental build got right)."""
        g2u = self.g2u[level]
        cap = self._caps(level)
        old = self.nb_tables[level]
        uu = np.repeat(members, self.M)
        vv = sel.ravel().astype(np.int64)
        ok = vv >= 0
        ou = np.repeat(members, old.shape[1])
        ov = old[g2u[members]].ravel().astype(np.int64)
        ook = ov >= 0
        e_from = np.concatenate([uu[ok], vv[ok], ou[ook]])
        e_to = np.concatenate([vv[ok], uu[ok], ov[ook]])
        rows = g2u[e_from].astype(np.int64)
        # dedup (row, neighbour) pairs
        key = np.unique(rows * (self.ntotal + 1) + e_to)
        rows_u = (key // (self.ntotal + 1)).astype(np.int64)
        to_u = (key % (self.ntotal + 1)).astype(np.int32)
        counts = np.bincount(rows_u, minlength=members.size)
        table = np.full((members.size, cap), -1, np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)])
        fit = counts <= cap
        # rows that fit: each row's sorted neighbours, left-aligned
        live = np.repeat(fit, counts)
        col = np.arange(key.size) - np.repeat(starts[:-1], counts)
        table[rows_u[live], col[live]] = to_u[live]
        over_rows = np.where(~fit)[0]
        if over_rows.size:
            maxk = int(counts[over_rows].max())
            maxk = min(((maxk + 7) // 8) * 8, max(cap * 8, 64))
            cand = np.full((over_rows.size, maxk), -1, np.int32)
            for i, r in enumerate(over_rows):
                lst = to_u[starts[r]:starts[r + 1]][:maxk]
                cand[i, : lst.size] = lst
            nodes = members[over_rows]
            qv = torch.as_tensor(self._xb[nodes], device=self.device)
            cand_s, d_s = _sorted_by_dist(self._dev[0], qv, cand,
                                          self.metric, self._codec)
            keep = heuristic_keep(self._dev[0], cand_s, d_s, cap,
                                  self.metric, self._codec)
            cand_np, keep_np = cand_s.cpu().numpy(), keep.cpu().numpy()
            for i, r in enumerate(over_rows):
                s = cand_np[i][keep_np[i] & (cand_np[i] >= 0)][:cap]
                table[r, : s.size] = s
        self.nb_tables[level] = table

    def _insert_batch(self, pts: np.ndarray) -> None:
        if pts.size == 0:
            return
        tgt = self.levels[pts]
        xb_d, tables_d = self._dev
        q = torch.as_tensor(self._xb[pts], device=self.device)
        cur, cur_d = self._entry_dist(q)
        efc = self.ef_construction
        new_edges = {}   # level -> (src pts, candidates, keep mask)
        for l in range(self.max_level, -1, -1):
            table_d, g2u_d = tables_d[l]
            # queries whose target is below l only descend greedily
            cur, cur_d = greedy_descent(xb_d, table_d, g2u_d, q, cur, cur_d,
                                        DESCENT_ITERS, self.metric,
                                        self._codec)
            link = tgt >= l
            if not link.any():
                continue
            cand_ids, cand_d = beam_search(xb_d, table_d, g2u_d, q, cur,
                                           cur_d, efc, efc, self.metric,
                                           self._codec)
            keep = heuristic_keep(xb_d, cand_ids, cand_d, self.M,
                                  self.metric, self._codec)
            cand_np = cand_ids.cpu().numpy()
            keep_np = keep.cpu().numpy() & (cand_np >= 0) & link[:, None]
            # no self-link (the seed insert sees itself)
            keep_np &= cand_np != pts[:, None]
            new_edges[l] = (pts[link], cand_np[link], keep_np[link])
            # the descent continues from the best candidate
            ok = cand_ids[:, 0] >= 0
            cur = torch.where(ok, cand_ids[:, 0], cur)
            cur_d = torch.where(ok, cand_d[:, 0], cur_d)
        for l, (src, cands, keeps) in new_edges.items():
            self._connect(l, src, cands, keeps)
        self._push_dev()

    def _connect(self, level: int, src: np.ndarray, cands: np.ndarray,
                 keeps: np.ndarray) -> None:
        """Host link surgery: forward edges src -> selected, reverse edges
        selected -> src, overflowing rows re-pruned (reference add_link and
        shrink_neighbor_list)."""
        table = self.nb_tables[level]
        g2u = self.g2u[level]
        overflow: dict[int, list[int]] = {}
        for i, s in enumerate(src):
            sel = cands[i][keeps[i]][: self.M]
            table[g2u[s], : sel.size] = sel
            for v in sel:
                vrow = g2u[v]
                lst = table[vrow]
                if s in lst:
                    continue
                free = np.flatnonzero(lst < 0)
                if free.size:
                    table[vrow, free[0]] = s
                else:
                    overflow.setdefault(int(v), []).append(int(s))
        if overflow:
            self._reprune(level, overflow)

    def _reprune(self, level: int, overflow: dict) -> None:
        """Re-select each overflowing node's links from its row and the new
        reverse edges with the occlusion heuristic, on the device."""
        table = self.nb_tables[level]
        g2u = self.g2u[level]
        cap = self._caps(level)
        nodes = np.fromiter(overflow.keys(), np.int64)
        maxk = cap + max(len(v) for v in overflow.values())
        maxk = ((maxk + 7) // 8) * 8
        cand = np.full((nodes.size, maxk), -1, np.int32)
        for i, v in enumerate(nodes):
            lst = [x for x in table[g2u[v]] if x >= 0] + overflow[int(v)]
            cand[i, : len(lst)] = lst
        qv = torch.as_tensor(self._xb[nodes], device=self.device)
        cand_s, d_s = _sorted_by_dist(self._dev[0], qv, cand, self.metric,
                                      self._codec)
        keep = heuristic_keep(self._dev[0], cand_s, d_s, cap, self.metric,
                              self._codec)
        cand_np, keep_np = cand_s.cpu().numpy(), keep.cpu().numpy()
        for i, v in enumerate(nodes):
            sel = cand_np[i][keep_np[i] & (cand_np[i] >= 0)][:cap]
            row = np.full(cap, -1, np.int32)
            row[: sel.size] = sel
            table[g2u[v]] = row

    # ------------------------------------------------------------ search

    def search(self, q: np.ndarray, k: int, ef: int | None = None):
        """(values [nq, k] float32, ids [nq, k] int64) best-first: the
        greedy descent, then the beam at max(ef, k) (``ef_search`` by
        default); with ``reconstruct_from_neighbors`` set, the top
        ``k_reorder`` re-ranked by the refined reconstructions (L2)."""
        if not self._built:
            self.build()
        q = np.asarray(q, np.float32)
        ef = max(int(ef if ef is not None else self.ef_search), k)
        if self.ntotal == 0:
            return (np.full((q.shape[0], k), worst_value(self.metric),
                            np.float32),
                    np.full((q.shape[0], k), -1, np.int64))
        xb_d, tables_d = self._dev
        qd = torch.as_tensor(q, device=self.device)
        cur, cur_d = self._entry_dist(qd)
        for l in range(self.max_level, 0, -1):
            table_d, g2u_d = tables_d[l]
            cur, cur_d = greedy_descent(xb_d, table_d, g2u_d, qd, cur, cur_d,
                                        DESCENT_ITERS, self.metric,
                                        self._codec)
        table_d, g2u_d = tables_d[0]
        cand_ids, cand_d = beam_search(xb_d, table_d, g2u_d, qd, cur, cur_d,
                                       ef, ef, self.metric, self._codec)
        vals = cand_d[:, :k].cpu().numpy()
        ids = cand_ids[:, :k].cpu().numpy()
        rfn = self.reconstruct_from_neighbors
        if rfn is not None and getattr(rfn, "k_reorder", -1) != 0:
            # re-rank the top k_reorder through the refined neighbour
            # reconstructions (reference IndexHNSW::search,
            # IndexHNSW.cpp:260-285); L2 only, as the reference's
            # compute_distances
            assert self.metric is Metric.L2, \
                "reconstruct_from_neighbors re-rank is L2-only"
            kr = getattr(rfn, "k_reorder", -1)
            kr = k if (kr == -1 or kr > k) else int(kr)
            d2 = rfn.compute_distances(q, ids[:, :kr])
            order = np.argsort(d2, axis=1, kind="stable")
            ids[:, :kr] = np.take_along_axis(ids[:, :kr], order, 1)
            vals[:, :kr] = np.take_along_axis(d2, order, 1)
        return vals, ids

    # ---------------------------------------------------------------- io

    def _io_extra(self) -> dict:
        """Storage payloads beyond the graph (codes, codebooks); called on
        a trained index only."""
        return {}

    def _io_restore(self, z) -> None:
        """Rebuild the codec and storage state from ``_io_extra``'s
        payloads (absent in an untrained save)."""

    def _io_rebuild_xb(self):
        """The decoded host mirror from the restored codes (compressed
        variants store codes, not vectors); None for the flat index."""
        return None

    def _io_stores_codes(self) -> bool:
        return False

    def state(self) -> dict:
        """The file's payload: the graph, and the vectors or the codes."""
        assert self._built or self.ntotal == 0
        extra = self._io_extra() if self.is_trained else {}
        payload = {} if self._io_stores_codes() else dict(xb=self._xb)
        levels = (self.levels if self.levels is not None
                  else np.zeros((0,), np.int32))   # a never-built empty index
        return dict(kind=type(self).__name__, d=self.d, levels=levels,
                    entry=self.entry_point, max_level=self.max_level,
                    M=self.M, ef_search=self.ef_search,
                    metric=self.metric.value,
                    **{f"table{l}": t for l, t in enumerate(self.nb_tables)},
                    **{f"g2u{l}": g for l, g in enumerate(self.g2u)},
                    **payload, **extra)

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` layout (``HNSWIndex.save``)."""
        np.savez(path, **self.state())

    @classmethod
    def _from_io(cls, z, device) -> "HNSWIndex":
        d = int(z["d"]) if "d" in z else int(np.asarray(z["xb"]).shape[1])
        return cls(d, M=int(z["M"]), metric=Metric(str(z["metric"])),
                   ef_search=int(z["ef_search"]), device=device)

    @classmethod
    def from_state(cls, z, device="cuda") -> "HNSWIndex":
        """The index a file's payload (or the JAX package's state as the
        same keys) describes, on ``device``, of the class its ``kind``
        names."""
        kind = str(z["kind"]) if "kind" in z else "HNSWIndex"
        klass = {c.__name__: c for c in (
            HNSWIndex, IndexHNSWSQ, IndexHNSWPQ, IndexHNSW2Level)}.get(
                kind, cls)
        idx = klass._from_io(z, device)
        idx.levels = np.asarray(z["levels"])
        idx.entry_point = int(z["entry"])
        idx.max_level = int(z["max_level"])
        idx.nb_tables = [np.array(z[f"table{l}"], np.int32)
                         for l in range(idx.max_level + 1)]
        idx.g2u = [np.array(z[f"g2u{l}"], np.int32)
                   for l in range(idx.max_level + 1)]
        idx._io_restore(z)
        if "xb" in z:
            idx._xb = np.array(z["xb"], np.float32)
        else:
            xb = idx._io_rebuild_xb()
            assert xb is not None, "file has neither xb nor codes"
            idx._xb = xb
        idx._push_dev()
        idx._built = True
        return idx

    @classmethod
    def load(cls, path: str, device="cuda") -> "HNSWIndex":
        with np.load(path) as z:
            return cls.from_state(z, device)


def _sq_decode_host(codes: np.ndarray, scale: np.ndarray,
                    vmin: np.ndarray) -> np.ndarray:
    return codes.astype(np.float32) * scale + vmin


class IndexHNSWSQ(HNSWIndex):
    """HNSW over SQ8 codes (reference IndexHNSWSQ, IndexHNSW.h:158; the
    factory's "HNSW%d_SQ8"): the device holds uint8 codes, every gather
    decodes them through the per-dimension affine range, and distances are
    asymmetric (float query against decoded codes)."""

    def __init__(self, d: int, M: int = 16, **kw):
        super().__init__(d, M=M, **kw)
        self.is_trained = False
        self._scale: np.ndarray | None = None
        self._vmin: np.ndarray | None = None
        self._codes = np.zeros((0, d), np.uint8)

    def _set_codec(self):
        self._codec = HNSWCodec(
            scale=torch.as_tensor(self._scale, device=self.device),
            bias=torch.as_tensor(self._vmin, device=self.device))
        self.is_trained = True

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        self._vmin = x.min(0).astype(np.float32)
        self._scale = np.maximum((x.max(0) - self._vmin) / 255.0,
                                 1e-10).astype(np.float32)
        self._set_codec()

    def add(self, x: np.ndarray, ids=None) -> None:
        assert self.is_trained, "train before add"
        x = np.asarray(x, np.float32)
        codes = np.clip(np.rint((x - self._vmin) / self._scale), 0,
                        255).astype(np.uint8)
        self._codes = np.concatenate([self._codes, codes], 0)
        super().add(_sq_decode_host(codes, self._scale, self._vmin))

    def _device_storage(self):
        return self._codes

    def reset(self):
        super().reset()
        self._codes = np.zeros((0, self.d), np.uint8)

    def _io_extra(self):
        return dict(sq_scale=self._scale, sq_vmin=self._vmin,
                    sq_codes=self._codes)

    def _io_restore(self, z):
        if "sq_scale" not in z:      # untrained save
            return
        self._scale = np.asarray(z["sq_scale"], np.float32)
        self._vmin = np.asarray(z["sq_vmin"], np.float32)
        self._codes = np.array(z["sq_codes"], np.uint8)
        self._set_codec()

    def _io_rebuild_xb(self):
        if not self.is_trained:
            return None
        return _sq_decode_host(self._codes, self._scale, self._vmin)

    def _io_stores_codes(self) -> bool:
        return self.is_trained


class IndexHNSWPQ(HNSWIndex):
    """HNSW over PQ codes (reference IndexHNSWPQ, IndexHNSW.h:147; the
    factory's "HNSW%d_PQ%d"): the device holds pq_m bytes a vector, decoded
    through the codebooks at every gather."""

    def __init__(self, d: int, pq_m: int = 8, M: int = 16, **kw):
        assert d % pq_m == 0, f"d={d} must divide into pq_m={pq_m}"
        super().__init__(d, M=M, **kw)
        self.is_trained = False
        self.pq_m = int(pq_m)
        self._pq: PQCodebooks | None = None
        self._codes = np.zeros((0, pq_m), np.uint8)

    def _set_books(self, books: torch.Tensor):
        self._pq = PQCodebooks(books)
        self._codec = HNSWCodec(books=books)
        self.is_trained = True

    def train(self, x: np.ndarray) -> None:
        self._set_books(train_pq(np.asarray(x, np.float32), self.pq_m,
                                 device=self.device).codebooks)

    def _decode_host(self, codes: np.ndarray) -> np.ndarray:
        return decode_pq(self._pq, torch.as_tensor(
            codes, device=self.device)).cpu().numpy()

    def add(self, x: np.ndarray, ids=None) -> None:
        assert self.is_trained, "train before add"
        x = np.asarray(x, np.float32)
        codes = encode_pq(self._pq, torch.as_tensor(
            x, device=self.device)).cpu().numpy()
        self._codes = np.concatenate([self._codes, codes], 0)
        super().add(self._decode_host(codes))

    def _device_storage(self):
        return self._codes

    def reset(self):
        super().reset()
        self._codes = np.zeros((0, self.pq_m), np.uint8)

    def _io_extra(self):
        return dict(pq_books=self._pq.codebooks.cpu().numpy(),
                    pq_codes=self._codes)

    @classmethod
    def _from_io(cls, z, device):
        d = int(z["d"]) if "d" in z else int(np.asarray(z["xb"]).shape[1])
        pq_m = int(np.asarray(z["pq_books"]).shape[0]) if "pq_books" in z \
            else 8
        return cls(d, pq_m=pq_m, M=int(z["M"]),
                   metric=Metric(str(z["metric"])),
                   ef_search=int(z["ef_search"]), device=device)

    def _io_restore(self, z):
        if "pq_books" not in z:      # untrained save
            return
        self._set_books(torch.tensor(np.asarray(z["pq_books"], np.float32),
                                     device=self.device))
        self._codes = np.array(z["pq_codes"], np.uint8)

    def _io_rebuild_xb(self):
        if not self.is_trained:
            return None
        return self._decode_host(self._codes)

    def _io_stores_codes(self) -> bool:
        return self.is_trained


def pack_two_level(list_ids: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """(list id, PQ code) rows -> [n, 4 + M] bytes: the id little-endian,
    then the code."""
    lid = np.asarray(list_ids).astype(np.uint32)
    packed = np.empty((len(lid), 4 + codes.shape[1]), np.uint8)
    for b in range(4):
        packed[:, b] = (lid >> (8 * b)) & 0xFF
    packed[:, 4:] = codes
    return packed


class IndexHNSW2Level(HNSWIndex):
    """HNSW over two-level codes (reference IndexHNSW2Level,
    IndexHNSW.cpp:1054-1100; the factory's "HNSW%d_%d+PQ%d" and
    "HNSW%d_2x%d+PQ%d"): an ``Index2Layer`` (``storage``) holds each
    vector's coarse list id and the PQ code of its residual; the device
    holds them packed, 4 + pq_m bytes a vector, decoded at every gather."""

    def __init__(self, d: int, nlist: int, pq_m: int = 8, M: int = 16,
                 quantizer=None, **kw):
        super().__init__(d, M=M, **kw)
        from auncel_tpu_torch.index.twolayer import Index2Layer
        self.is_trained = False
        self.storage = Index2Layer(d, nlist, pq_m, metric=self.metric,
                                   quantizer=quantizer, device=self.device)
        self._codes = np.zeros((0, 4 + pq_m), np.uint8)

    def _set_codec(self):
        st = self.storage
        self._codec = HNSWCodec(
            books=st._pq.codebooks,
            centroids=torch.as_tensor(st.centroids, device=self.device))
        self.is_trained = True

    def train(self, x: np.ndarray) -> None:
        self.storage.train(x)
        self._set_codec()

    def add(self, x: np.ndarray, ids=None) -> None:
        assert self.is_trained, "train before add"
        x = np.asarray(x, np.float32)
        n0 = self.storage.ntotal
        self.storage.add(x)
        self._codes = np.concatenate([self._codes, pack_two_level(
            self.storage.list_ids[n0:], self.storage.codes[n0:])], 0)
        super().add(self.storage.reconstruct_n(n0))

    def _device_storage(self):
        return self._codes

    def reset(self):
        super().reset()
        self.storage.reset()
        self._codes = np.zeros((0, 4 + self.storage.M), np.uint8)

    def _io_extra(self):
        # the packed codes are a byte-packing of (list ids, codes), rebuilt
        # on load
        st = self.storage
        return dict(tl_centroids=st.centroids,
                    tl_books=st._pq.codebooks.cpu().numpy(),
                    tl_list_ids=st.list_ids, tl_codes=st.codes)

    @classmethod
    def _from_io(cls, z, device):
        d = int(z["d"]) if "d" in z else int(np.asarray(z["xb"]).shape[1])
        nlist = int(np.asarray(z["tl_centroids"]).shape[0]) \
            if "tl_centroids" in z else 1
        pq_m = int(np.asarray(z["tl_books"]).shape[0]) if "tl_books" in z \
            else 8
        return cls(d, nlist=nlist, pq_m=pq_m, M=int(z["M"]),
                   metric=Metric(str(z["metric"])),
                   ef_search=int(z["ef_search"]), device=device)

    def _io_restore(self, z):
        if "tl_centroids" not in z:  # untrained save
            return
        st = self.storage
        st.centroids = np.array(z["tl_centroids"], np.float32)
        st._pq = PQCodebooks(torch.tensor(np.asarray(z["tl_books"],
                                                     np.float32),
                                          device=self.device))
        st.list_ids = np.array(z["tl_list_ids"], np.int32)
        st.codes = np.array(z["tl_codes"], np.uint8)
        st.is_trained = True
        self._codes = pack_two_level(st.list_ids, st.codes)
        self._set_codec()

    def _io_rebuild_xb(self):
        if not self.is_trained:
            return None
        return self.storage.reconstruct_n(0)

    def _io_stores_codes(self) -> bool:
        return self.is_trained
