"""Meta indexes (port of ``auncel_tpu/index/meta.py``; reference
MetaIndexes.h, IndexShards.h, IndexReplicas.h): id mapping, in-process
sharding, dimension splitting and replication, all host-side compositions
of the wrapped indexes' own searches.

``IndexIDMap`` and ``IndexIDMap2`` remap sequential ids to user ids;
``IndexShards`` fans a query out to every shard and merges the top-k by
value (binary shards too: packed uint8 codes in, integer distances
out); ``IndexSplitVectors`` composes k=1 searches over dimension slices;
``IndexReplicas`` round-robins whole queries across identical replicas.
"""

import numpy as np

from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.types import Metric


def kway_merge_topk(vals: np.ndarray, ids: np.ndarray,
                    lower_is_better: bool):
    """Per-query top-k of S best-first shard lists: vals and ids [S, B, k]
    -> ([B, k], [B, k]). A stable sort over (shard, rank) order, so a tie
    goes to the earlier shard, then the better rank: the JAX package's
    ``native.kway_merge_topk`` (its C++ merge and its numpy fallback both
    keep that order). Integer distances (the binary indexes' Hamming
    distances, their pads at the int32 maximum) stay integers, as the
    numpy merge keeps them; float ones come back float32."""
    S, B, k = vals.shape
    flat_v = np.transpose(vals, (1, 0, 2)).reshape(B, S * k)
    flat_i = np.transpose(ids, (1, 0, 2)).reshape(B, S * k)
    order = np.argsort(flat_v if lower_is_better else -flat_v, axis=1,
                       kind="stable")[:, :k]
    out_v = np.take_along_axis(flat_v, order, 1)
    if not np.issubdtype(out_v.dtype, np.integer):
        out_v = out_v.astype(np.float32)
    return out_v, np.take_along_axis(flat_i, order, 1).astype(np.int64)


class IndexIDMap(Index):
    """Remaps sequential ids to arbitrary user ids (MetaIndexes.h)."""

    def __init__(self, sub: Index):
        self.sub = sub
        self.d = sub.d
        self.metric = sub.metric
        self._ids = np.zeros(0, np.int64)

    @property
    def is_trained(self):
        return self.sub.is_trained

    @is_trained.setter
    def is_trained(self, v):  # pragma: no cover - keeps Index contract
        pass

    @property
    def ntotal(self):
        return self.sub.ntotal

    def train(self, x):
        self.sub.train(x)

    def add(self, x, ids=None):
        assert ids is not None, "IndexIDMap exists to carry user ids"
        self._ids = np.concatenate([self._ids, np.asarray(ids, np.int64)])
        self.sub.add(x)

    def search(self, q, k, **sub_kwargs):
        # pass-through knobs (nprobe, ...) reach the wrapped index like
        # the reference ParameterSpace recursing into IndexIDMap
        # (AutoTune.cpp:505-508)
        vals, ids = self.sub.search(q, k, **sub_kwargs)
        mapped = np.where(ids >= 0, self._ids[np.maximum(ids, 0)], -1)
        return vals, mapped

    def reset(self):
        self.sub.reset()
        self._ids = np.zeros(0, np.int64)

    def remove_ids(self, selector) -> int:
        """Remove by USER id (reference IndexIDMap::remove_ids,
        MetaIndexes.cpp — the selector matches the remapped ids, then the
        wrapped index drops the corresponding positions). Rebuilds the
        sub-index from its decoded vectors, the same route
        aux.remove_ids takes for storage codecs."""
        keep = ~selector.is_member(self._ids)
        removed = int((~keep).sum())
        if removed == 0:
            return 0
        x = self.sub.reconstruct_n(0, self.sub.ntotal)
        from auncel_tpu_torch.index.ivf import preserve_sq_range
        preserve_sq_range(self.sub)   # keep SQ codes bit-stable
        self.sub.reset()
        if keep.any():
            self.sub.add(x[keep])
        self._ids = self._ids[keep]
        return removed


class IndexIDMap2(IndexIDMap):
    """IndexIDMap with an id -> sequential-position reverse map for
    efficient reconstruction by user id (MetaIndexes.h:59-77:
    ``rev_map`` + ``reconstruct``)."""

    def __init__(self, sub: Index):
        super().__init__(sub)
        self._rev: dict[int, int] = {}

    def construct_rev_map(self) -> None:
        """Rebuild the reverse map from scratch (MetaIndexes.cpp
        ``construct_rev_map``) — e.g. after loading state."""
        self._rev = {int(u): i for i, u in enumerate(self._ids)}

    def add(self, x, ids=None):
        base = self._ids.shape[0]
        super().add(x, ids)
        for i, u in enumerate(self._ids[base:]):
            self._rev[int(u)] = base + i

    def reconstruct(self, key: int) -> np.ndarray:
        """Decode the stored vector for user id ``key`` via the reverse
        map (one dict lookup, not a scan of _ids)."""
        pos = self._rev.get(int(key))
        if pos is None:
            raise KeyError(f"id {key} not in IndexIDMap2")
        return self.sub.reconstruct(pos)

    def remove_ids(self, selector) -> int:
        removed = super().remove_ids(selector)
        if removed:
            self.construct_rev_map()   # positions renumbered
        return removed

    def reset(self):
        super().reset()
        self._rev = {}


class IndexShards(Index):
    """Fan out to every shard, merge the top-k by value (IndexShards.h:20).
    With ``successive_ids``, a position-keyed shard's results (a Flat
    index stores sequential positions) are translated back to the global
    ids they were added under."""

    def __init__(self, d: int, metric: Metric = Metric.L2,
                 successive_ids: bool = True):
        self.d = d
        self.metric = Metric.parse(metric)
        self.successive_ids = successive_ids
        self.shards: list[Index] = []
        # per-shard position -> global id (for position-keyed shards)
        self._pos_maps: list[np.ndarray] = []

    @property
    def is_trained(self):
        return all(s.is_trained for s in self.shards)

    @is_trained.setter
    def is_trained(self, v):  # pragma: no cover
        pass

    @property
    def ntotal(self):
        return sum(s.ntotal for s in self.shards)

    def add_shard(self, index: Index):
        assert index.d == self.d and index.metric is self.metric
        self.shards.append(index)
        self._pos_maps.append(np.zeros((0,), np.int64))

    def train(self, x):
        for s in self.shards:
            s.train(x)

    def add(self, x, ids=None):
        """Round-robin rows across shards (like dist/split.cpp)."""
        assert self.shards, "add_shard first"
        n = x.shape[0]
        base = self.ntotal
        if ids is None:
            ids = np.arange(base, base + n, dtype=np.int64)
        ids = np.asarray(ids, np.int64)
        for i, s in enumerate(self.shards):
            sel = slice(i, None, len(self.shards))
            if self._position_keyed(s):
                # record the global id of every stored position: later
                # adds restart at shard 0, so no stride formula holds
                s.add(x[sel])
                self._pos_maps[i] = np.concatenate(
                    [self._pos_maps[i], ids[sel]])
            else:
                s.add(x[sel], ids=ids[sel])

    @staticmethod
    def _position_keyed(s) -> bool:
        """A shard that stores sequential position ids (FlatIndex) needs
        its results translated back to global ids."""
        return bool(getattr(s, "position_keyed_ids", False))

    def search(self, q, k):
        all_v, all_i = [], []
        for i, s in enumerate(self.shards):
            v, idx = s.search(q, k)
            if self.successive_ids and self._position_keyed(s):
                pm = self._pos_maps[i]
                idx = np.where(idx >= 0,
                               pm[np.clip(idx, 0, max(len(pm) - 1, 0))],
                               -1)
            all_v.append(v)
            all_i.append(idx)
        return kway_merge_topk(np.stack(all_v),
                               np.stack(all_i).astype(np.int64),
                               self.metric.lower_is_better)

    def reset(self):
        for s in self.shards:
            s.reset()
        self._pos_maps = [np.zeros((0,), np.int64) for _ in self.shards]


class IndexSplitVectors(Index):
    """Dimension-sliced federation (reference ``IndexSplitVectors``,
    MetaIndexes.h:82, MetaIndexes.cpp:224-297): each sub-index owns a
    contiguous slice of the dimensions; a k=1 search runs every sub-index
    on its slice and composes the result as a multi-index cell: label =
    sum(label_i * prod(ntotal of the earlier subs)), distance = the sum of
    the sub-distances. ``add`` and ``train`` raise, as in the reference
    (the sub-indexes are filled directly)."""

    def __init__(self, d: int, threaded: bool = False):
        self.d = d
        self.threaded = threaded  # the reference's flag; runs in turn here
        self.metric = Metric.L2
        self.sub_indexes: list[Index] = []
        self.sum_d = 0
        self.is_trained = True

    @property
    def ntotal(self):
        if not self.sub_indexes:
            return 0
        n = 1
        for s in self.sub_indexes:
            n *= s.ntotal
        return n

    def add_sub_index(self, index: Index):
        self.sub_indexes.append(index)
        self.sum_d += index.d

    def add(self, x, ids=None):
        raise NotImplementedError(
            "IndexSplitVectors: add sub-indexes, not vectors "
            "(MetaIndexes.cpp:218)")

    def train(self, x):
        raise NotImplementedError("not implemented (MetaIndexes.cpp:299)")

    def search(self, q, k):
        assert k == 1, "search implemented only for k=1 (reference parity)"
        assert self.sum_d == self.d, \
            "not enough indexes compared to # dimensions"
        q = np.asarray(q, np.float32)
        n = q.shape[0]
        vals = np.zeros((n, 1), np.float32)
        ids = np.zeros((n, 1), np.int64)
        ofs, factor = 0, 1
        for i, sub in enumerate(self.sub_indexes):
            v, lab = sub.search(q[:, ofs:ofs + sub.d], 1)
            lab = np.asarray(lab, np.int64)
            if i == 0:
                vals, ids = np.array(v), lab
            else:
                bad = (ids < 0) | (lab < 0)
                ids = np.where(bad, -1, ids + lab * factor)
                vals = np.where(bad, np.nan, vals + v)
            ofs += sub.d
            factor *= sub.ntotal
        return vals, ids

    def reset(self):
        for s in self.sub_indexes:
            s.reset()


class IndexReplicas(Index):
    """Round-robin queries across identical replicas (IndexReplicas.h):
    any replica's answer is the answer."""

    def __init__(self, d: int, metric: Metric = Metric.L2):
        self.d = d
        self.metric = Metric.parse(metric)
        self.replicas: list[Index] = []
        self._next = 0

    @property
    def is_trained(self):
        return all(r.is_trained for r in self.replicas)

    @is_trained.setter
    def is_trained(self, v):  # pragma: no cover
        pass

    @property
    def ntotal(self):
        return self.replicas[0].ntotal if self.replicas else 0

    def add_replica(self, index: Index):
        assert index.d == self.d
        self.replicas.append(index)

    def train(self, x):
        for r in self.replicas:
            r.train(x)

    def add(self, x, ids=None):
        for r in self.replicas:
            r.add(x, ids=ids) if ids is not None else r.add(x)

    def search(self, q, k):
        assert self.replicas
        r = self.replicas[self._next % len(self.replicas)]
        self._next += 1
        return r.search(q, k)

    def reset(self):
        for r in self.replicas:
            r.reset()
