"""``routing.host_ms``: host time a traced query of the decision steps,
``auncel.decide`` (the error profile's predicate and the budget it sets;
``spans.py``)."""

from benchmark import spans


def read(rec: dict):
    return spans.self_ms(rec, ("auncel.decide",))
