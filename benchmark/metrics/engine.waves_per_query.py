"""``engine.waves_per_query``: the engine's waves that launched a scan
(``ivf_stats.waves``: an ``auncel.wave`` span holding an ``auncel.scan``)
a traced query (``spans.py``)."""

from benchmark import spans


def read(rec: dict):
    return spans.per_query(rec, "waves")
