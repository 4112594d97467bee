"""``engine.self_ms``: host self time a traced query of the engine's own
spans, outside every child span: ``auncel.search``, ``.inputs``, ``.rank``,
``.wave``, ``.round`` and ``.record`` (``spans.py``)."""

from benchmark import spans

NAMES = ("auncel.search", "auncel.inputs", "auncel.rank", "auncel.wave",
         "auncel.round", "auncel.record")


def read(rec: dict):
    return spans.self_ms(rec, NAMES)
