"""Copied from ``lightgbm_tpu/metric/binary.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports and device hooks differ.

Binary metrics: logloss, error, AUC (src/metric/binary_metric.hpp)."""
from __future__ import annotations

import numpy as np

from .metric import Metric

K_EPSILON = 1e-15


class _BinaryMetric(Metric):
    metric_name = ""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = [self.metric_name]

    def point_loss(self, label, prob):
        raise NotImplementedError

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        if objective is not None:
            prob = np.asarray(objective.convert_output(s))
        else:
            prob = 1.0 / (1.0 + np.exp(-s))
        return [self._avg(self.point_loss(self.label, prob))]


class BinaryLoglossMetric(_BinaryMetric):
    metric_name = "binary_logloss"

    def point_loss(self, label, prob):
        pos = np.maximum(prob, K_EPSILON)
        neg = np.maximum(1.0 - prob, K_EPSILON)
        return np.where(label > 0, -np.log(pos), -np.log(neg))


class BinaryErrorMetric(_BinaryMetric):
    metric_name = "binary_error"

    def point_loss(self, label, prob):
        return np.where(prob <= 0.5, label > 0, label <= 0).astype(np.float64)


def weighted_auc(label: np.ndarray, score: np.ndarray,
                 weights=None) -> float:
    """Threshold-sweep AUC with tie handling (binary_metric.hpp:191-250)."""
    n = len(label)
    if n == 0:
        return 1.0
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    pos_w = np.where(label > 0, w, 0.0)
    neg_w = np.where(label <= 0, w, 0.0)
    order = np.argsort(-score, kind="stable")
    s = score[order]
    pw = pos_w[order]
    nw = neg_w[order]
    # group by unique score (ties share a threshold)
    boundary = np.concatenate([[True], s[1:] != s[:-1]])
    group = np.cumsum(boundary) - 1
    ng = group[-1] + 1
    gpos = np.bincount(group, weights=pw, minlength=ng)
    gneg = np.bincount(group, weights=nw, minlength=ng)
    sum_pos_before = np.concatenate([[0.0], np.cumsum(gpos)[:-1]])
    accum = (gneg * (gpos * 0.5 + sum_pos_before)).sum()
    sum_pos = gpos.sum()
    sum_all = w.sum()
    if sum_pos > 0 and sum_pos != sum_all:
        return float(accum / (sum_pos * (sum_all - sum_pos)))
    return 1.0


class AUCMetric(Metric):
    factor_to_bigger_better = 1.0

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = ["auc"]

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        return [weighted_auc(self.label, s, self.weights)]
