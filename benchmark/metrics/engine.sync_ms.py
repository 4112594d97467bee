"""``engine.sync_ms``: host time a traced query spent in ``auncel.sync``
spans, the calls that wait for the card (``spans.py``)."""

from benchmark import spans


def read(rec: dict):
    return spans.self_ms(rec, ("auncel.sync",))
