"""``scan.host_ms``: host self time a traced query of the scan layer:
``auncel.scan`` (probe gathers and masks around the kernels) and the K1
and K2 wrappers' calls, ``auncel.k1`` and ``auncel.k2`` (``spans.py``)."""

from benchmark import spans


def read(rec: dict):
    return spans.self_ms(rec, ("auncel.scan", "auncel.k1", "auncel.k2"))
