"""Worst-case recall by distance threshold (a copy of the numpy helpers in
``auncel_tpu/autotune.py``)."""

import numpy as np

from auncel_tpu_torch.types import Metric


def recall_counts(D: np.ndarray, gt_D: np.ndarray, k: int,
                  metric: Metric) -> np.ndarray:
    """Distance-threshold intersection count per query (reference
    ``inter_sec``, eval/bound.cpp:117-128). The slack is RELATIVE: an
    absolute 1e-6 fails at large distance scales when the k-th GT distance
    is hit by a vector whose distance a differently-shaped (equally exact)
    kernel computed."""
    thresh = gt_D[:, k - 1]
    slack = np.maximum(1e-6, 1e-5 * np.abs(thresh))
    if metric is Metric.L2:
        cnt = (D[:, :k] <= (thresh + slack)[:, None]).sum(1)
    else:
        cnt = (D[:, :k] >= (thresh - slack)[:, None]).sum(1)
    return np.minimum(cnt, k)


def worst_case_recall(D: np.ndarray, gt_D: np.ndarray, k: int,
                      metric: Metric) -> float:
    """min over queries of the distance-threshold intersection."""
    return float(recall_counts(D, gt_D, k, metric).min() / k)
