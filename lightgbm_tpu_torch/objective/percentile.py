"""Copied from ``lightgbm_tpu/objective/percentile.py`` for the PyTorch port
(which imports nothing of the JAX package); unchanged but for this line.

Percentile helpers matching the reference's selection semantics
(src/objective/regression_objective.hpp:18-75 PercentileFun/WeightedPercentileFun),
used by L1/quantile/MAPE boost-from-score and leaf renewal.  Host numpy, so
that leaf values equal the JAX package's."""
from __future__ import annotations

import numpy as np


def percentile(data: np.ndarray, alpha: float) -> float:
    cnt = len(data)
    if cnt == 0:
        return 0.0
    if cnt <= 1:
        return float(data[0])
    d = np.sort(data)[::-1]  # descending, like ArgMaxAtK partitions
    float_pos = (1.0 - alpha) * cnt
    pos = int(float_pos)
    if pos < 1:
        return float(d[0])
    if pos >= cnt:
        return float(d[-1])
    bias = float_pos - pos
    v1, v2 = float(d[pos - 1]), float(d[pos])
    return v1 - (v1 - v2) * bias


def weighted_percentile(data: np.ndarray, weights: np.ndarray,
                        alpha: float) -> float:
    cnt = len(data)
    if cnt == 0:
        return 0.0
    if cnt <= 1:
        return float(data[0])
    order = np.argsort(data, kind="stable")
    vals = np.asarray(data, dtype=np.float64)[order]
    cdf = np.cumsum(np.asarray(weights, dtype=np.float64)[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(vals[pos])
    v1, v2 = float(vals[pos - 1]), float(vals[pos])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return (threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) * (v2 - v1) + v1
    return v2
