"""Search counters (port of ``SearchStats``/``ivf_stats`` in
``auncel_tpu/index/aux.py``; reference ``indexIVF_stats``,
IndexIVF.h:361-374). ``IVFFlatIndex.search`` adds to ``ivf_stats``.

Not ported yet: ``range_search``, ``remove_ids``, the ``IDSelector``
family and ``InterruptCallback`` (``ROADMAP.md`` queue 1 item 7).
"""

from dataclasses import dataclass


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
