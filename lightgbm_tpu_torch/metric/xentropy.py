"""Copied from ``lightgbm_tpu/metric/xentropy.py`` for the PyTorch port (which imports
nothing of the JAX package); unchanged but for this note.

Cross-entropy metrics (src/metric/xentropy_metric.hpp): cross_entropy,
cross_entropy_lambda, kullback_leibler."""
from __future__ import annotations

import numpy as np

from .metric import Metric

_LOG_EPS = 1.0e-12


def _xent_loss(label, prob):
    a = label * np.log(np.maximum(prob, _LOG_EPS))
    b = (1.0 - label) * np.log(np.maximum(1.0 - prob, _LOG_EPS))
    return -(a + b)


class CrossEntropyMetric(Metric):
    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = ["cross_entropy"]

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        prob = 1.0 / (1.0 + np.exp(-s))
        return [self._avg(_xent_loss(self.label, prob))]


class CrossEntropyLambdaMetric(Metric):
    """Loss under the lambda parameterization: hhat = log1p(exp(f)),
    prob = 1 - exp(-w*hhat) (xentropy_metric.hpp xentlambda)."""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = ["cross_entropy_lambda"]

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        w = np.ones_like(s) if self.weights is None else self.weights
        hhat = np.log1p(np.exp(s))
        prob = 1.0 - np.exp(-w * hhat)
        loss = _xent_loss(self.label, prob)
        return [float(loss.sum() / self.num_data)]


class KullbackLeiblerDivergence(Metric):
    """KL(label || prob) = xent(label, prob) - H(label)."""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = ["kullback_leibler"]
        p = self.label
        self.label_entropy = _xent_loss(p, np.clip(p, _LOG_EPS, 1 - _LOG_EPS))

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        prob = 1.0 / (1.0 + np.exp(-s))
        return [self._avg(_xent_loss(self.label, prob) - self.label_entropy)]
