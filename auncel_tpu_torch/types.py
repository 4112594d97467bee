"""Shared enums and small value types (a copy of ``auncel_tpu/types.py``;
the port cannot import it without importing jax).

Mirrors the capability surface of the reference Auncel's ``MetricType``
(``Auncel/Index.h``): L2 (squared Euclidean, smaller is
better) and inner product (larger is better; the reference's TEXT10M dataset
is L2-normalized so IP values live in [-1, 1] and can be mapped to angles).
"""

import enum


class Metric(enum.Enum):
    L2 = "l2"
    IP = "ip"

    @property
    def lower_is_better(self) -> bool:
        return self is Metric.L2

    @staticmethod
    def parse(value) -> "Metric":
        if isinstance(value, Metric):
            return value
        v = str(value).lower()
        if v in ("l2", "l2sqr", "euclidean"):
            return Metric.L2
        if v in ("ip", "inner_product", "dot"):
            return Metric.IP
        raise ValueError(f"unknown metric: {value!r}")


# Sentinel "worst" score per metric: padding slots take this value so they
# never enter a top-k result (reference pads heaps with HUGE_VAL,
# Auncel/Heap.h:52-88).
WORST_L2 = float("inf")
WORST_IP = float("-inf")


def worst_value(metric: Metric) -> float:
    return WORST_L2 if metric is Metric.L2 else WORST_IP
