"""``engine.syncs_per_query``: the calls a traced query made that block the
host on the card's stream (``ivf_stats.host_syncs``, one ``auncel.sync``
span each: reads of a device value, copies from pageable host memory),
over the traced queries (``spans.py``)."""

from benchmark import spans


def read(rec: dict):
    return spans.per_query(rec, "host_syncs")
