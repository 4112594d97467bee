"""Id-mapping wrappers (port of ``IndexIDMap`` and ``IndexIDMap2`` of
``auncel_tpu/index/meta.py``; reference MetaIndexes.h): sequential ids of
the wrapped index remapped to user ids, host-side. ``IndexShards``,
``IndexSplitVectors`` and ``IndexReplicas`` are not ported yet
(``ROADMAP.md`` queue 1 item 7).
"""

import numpy as np

from auncel_tpu_torch.index.base import Index


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
