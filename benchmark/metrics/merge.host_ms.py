"""``merge.host_ms``: host time a traced query of the running top-k merge,
``auncel.merge`` (``ops/topk.py::merge_topk_verified`` and its kernel's
wrapper; ``spans.py``)."""

from benchmark import spans


def read(rec: dict):
    return spans.self_ms(rec, ("auncel.merge",))
