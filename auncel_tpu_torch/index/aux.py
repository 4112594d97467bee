"""Search counters and the range-search result (port of ``SearchStats``/
``ivf_stats`` and ``RangeSearchResult`` in ``auncel_tpu/index/aux.py``;
reference ``indexIVF_stats``, IndexIVF.h:361-374).
``IVFFlatIndex.search`` adds to ``ivf_stats``; ``FlatIndex.range_search``
returns a ``RangeSearchResult``.

Not ported yet: the IVF ``range_search``, ``remove_ids``, the
``IDSelector`` family and ``InterruptCallback`` (``ROADMAP.md`` queue 1
item 7).
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class RangeSearchResult:
    """CSR-style container (reference AuxIndexStructures.h:31): query i's
    hits are labels[lims[i]:lims[i+1]] / distances[...]."""
    lims: np.ndarray        # [nq + 1] int64
    labels: np.ndarray      # [nres] int64
    distances: np.ndarray   # [nres] float32


@dataclass
class SearchStats:
    """Per-process counters, updated by the search entry points that opt
    in."""
    nq: int = 0
    nlist_scanned: int = 0
    ndis: int = 0
    quantization_time_ms: float = 0.0
    search_time_ms: float = 0.0

    def reset(self):
        self.nq = self.nlist_scanned = self.ndis = 0
        self.quantization_time_ms = self.search_time_ms = 0.0


ivf_stats = SearchStats()
