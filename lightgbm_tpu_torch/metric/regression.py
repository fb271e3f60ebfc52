"""Copied from ``lightgbm_tpu/metric/regression.py`` for the PyTorch port (which imports
nothing of the JAX package); unchanged but for this note.

Pointwise regression metrics (src/metric/regression_metric.hpp)."""
from __future__ import annotations

import numpy as np

from .metric import Metric


class _RegressionMetric(Metric):
    metric_name = ""
    use_objective_convert = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = [self.metric_name]

    def point_loss(self, label, score):
        raise NotImplementedError

    def average(self, sum_loss, sum_weights):
        return sum_loss / sum_weights

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        if objective is not None and self.use_objective_convert:
            s = np.asarray(objective.convert_output(s))
        pointwise = self.point_loss(self.label, s)
        if self.weights is not None:
            total = float((pointwise * self.weights).sum())
        else:
            total = float(pointwise.sum())
        return [self.average(total, self.sum_weights)]


class L2Metric(_RegressionMetric):
    metric_name = "l2"

    def point_loss(self, y, s):
        return (s - y) ** 2


class RMSEMetric(L2Metric):
    metric_name = "rmse"

    def average(self, sum_loss, sum_weights):
        return float(np.sqrt(sum_loss / sum_weights))


class L1Metric(_RegressionMetric):
    metric_name = "l1"

    def point_loss(self, y, s):
        return np.abs(s - y)


class QuantileMetric(_RegressionMetric):
    metric_name = "quantile"

    def point_loss(self, y, s):
        delta = y - s
        a = self.config.alpha
        return np.where(delta < 0, (a - 1.0) * delta, a * delta)


class HuberLossMetric(_RegressionMetric):
    metric_name = "huber"

    def point_loss(self, y, s):
        diff = s - y
        a = self.config.alpha
        return np.where(np.abs(diff) <= a, 0.5 * diff * diff,
                        a * (np.abs(diff) - 0.5 * a))


class FairLossMetric(_RegressionMetric):
    metric_name = "fair"

    def point_loss(self, y, s):
        x = np.abs(s - y)
        c = self.config.fair_c
        return c * x - c * c * np.log(1.0 + x / c)


class PoissonMetric(_RegressionMetric):
    metric_name = "poisson"

    def point_loss(self, y, s):
        s = np.maximum(s, 1e-10)
        return s - y * np.log(s)


class MAPEMetric(_RegressionMetric):
    metric_name = "mape"

    def point_loss(self, y, s):
        return np.abs(y - s) / np.maximum(1.0, np.abs(y))


class GammaMetric(_RegressionMetric):
    metric_name = "gamma"

    def point_loss(self, y, s):
        # negative gamma log-likelihood with psi=1 (regression_metric.hpp:261-268)
        safe = np.maximum(s, 1e-20)
        theta = -1.0 / safe
        b = -np.log(np.maximum(-theta, 1e-20))
        ysafe = np.maximum(y, 1e-20)
        c = np.log(ysafe) - np.log(ysafe)
        return -((y * theta - b) + c)


class GammaDevianceMetric(_RegressionMetric):
    metric_name = "gamma_deviance"

    def point_loss(self, y, s):
        tmp = y / (s + 1e-9)
        return tmp - np.log(np.maximum(tmp, 1e-20)) - 1

    def average(self, sum_loss, sum_weights):
        return sum_loss * 2


class TweedieMetric(_RegressionMetric):
    metric_name = "tweedie"

    def point_loss(self, y, s):
        rho = self.config.tweedie_variance_power
        s = np.maximum(s, 1e-10)
        a = y * np.exp((1 - rho) * np.log(s)) / (1 - rho)
        b = np.exp((2 - rho) * np.log(s)) / (2 - rho)
        return -a + b
