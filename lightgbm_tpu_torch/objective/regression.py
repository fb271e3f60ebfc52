"""Regression objectives: l2, l1, huber, fair, poisson, quantile, mape, gamma,
tweedie.

Counterpart of ``lightgbm_tpu/objective/regression.py`` (the reference's
src/objective/regression_objective.hpp; formulas cited per class).  Gradients
are elementwise torch on the objective's device, in the JAX package's f32
operations and order; boost-from-score and the leaf renewal of l1, quantile
and mape run on host numpy (``percentile.py``), as there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike
from ..utils.log import Log
from .base import ObjectiveFunction
from .percentile import percentile, weighted_percentile


class RegressionL2Loss(ObjectiveFunction):
    """L2: grad = score - label, hess = 1 (regression_objective.hpp:110-125);
    optional sqrt label transform (reg_sqrt, :97-107,131-137)."""
    name = "regression"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sqrt:
            self.label_np = (np.sign(self.label_np)
                             * np.sqrt(np.abs(self.label_np))).astype(np.float32)
            self.label = torch.as_tensor(self.label_np, device=self.device)

    def get_gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights_np is not None:
            return float(np.average(self.label_np, weights=self.weights_np))
        return float(self.label_np.mean())

    def convert_output(self, scores):
        if self.sqrt:
            return np.sign(scores) * scores * scores
        return scores


class RegressionL1Loss(RegressionL2Loss):
    """L1: grad = sign(score - label) (:199-215); median boost (:218);
    leaf renewal to the residual median (:233-273)."""
    name = "regression_l1"
    is_renew_tree_output = True

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights_np is not None:
            return weighted_percentile(self.label_np, self.weights_np, 0.5)
        return percentile(self.label_np, 0.5)

    def renew_tree_output(self, leaf_rows_residual, leaf_rows_weight) -> float:
        if leaf_rows_weight is not None:
            return weighted_percentile(leaf_rows_residual, leaf_rows_weight, 0.5)
        return percentile(leaf_rows_residual, 0.5)


class RegressionHuberLoss(RegressionL2Loss):
    """Huber with delta = alpha (:295-321)."""
    name = "huber"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.alpha = float(config.alpha)
        self.sqrt = False

    def get_gradients(self, score):
        diff = score - self.label
        grad = torch.where(torch.abs(diff) <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)


class RegressionFairLoss(RegressionL2Loss):
    """Fair loss with scale c (:348-370)."""
    name = "fair"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        x = score - self.label
        ax = torch.abs(x)
        grad = self.c * x / (ax + self.c)
        hess = (self.c * self.c) / ((ax + self.c) ** 2)
        return self._apply_weights(grad, hess)


class RegressionPoissonLoss(RegressionL2Loss):
    """Poisson: internal score is log-rate; grad = exp(f) - y,
    hess = exp(f + poisson_max_delta_step) (:426-441)."""
    name = "poisson"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.max_delta_step = float(config.poisson_max_delta_step)
        self.sqrt = False

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label_np.min() < 0:
            Log.fatal("[%s]: at least one target label is negative", self.name)
        if self.label_np.sum() == 0:
            Log.fatal("[%s]: sum of labels is zero", self.name)

    def get_gradients(self, score):
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + self.max_delta_step)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = RegressionL2Loss.boost_from_score(self, class_id)
        return float(np.log(max(mean, 1e-20)))

    def convert_output(self, scores):
        return np.exp(scores)


class RegressionQuantileLoss(RegressionL2Loss):
    """Pinball loss at quantile alpha (:476-502); percentile boost + renewal."""
    name = "quantile"
    is_renew_tree_output = True

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.alpha = float(config.alpha)
        if not 0 < self.alpha < 1:
            Log.fatal("[%s]: alpha %f should be in (0, 1)", self.name,
                      self.alpha)

    def get_gradients(self, score):
        f32 = dict(dtype=torch.float32, device=score.device)
        grad = torch.where(score - self.label >= 0,
                           torch.tensor(1.0 - self.alpha, **f32),
                           torch.tensor(-self.alpha, **f32))
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights_np is not None:
            return weighted_percentile(self.label_np, self.weights_np, self.alpha)
        return percentile(self.label_np, self.alpha)

    def renew_tree_output(self, leaf_rows_residual, leaf_rows_weight) -> float:
        if leaf_rows_weight is not None:
            return weighted_percentile(leaf_rows_residual, leaf_rows_weight,
                                       self.alpha)
        return percentile(leaf_rows_residual, self.alpha)


class RegressionMAPELoss(RegressionL1Loss):
    """MAPE: L1 re-weighted by 1/max(1, |label|) (:571-612)."""
    name = "mape"
    is_renew_tree_output = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if (np.abs(self.label_np) < 1).any():
            Log.warning("Met 'abs(label) < 1', will convert them to '1' in MAPE "
                        "objective and metric")
        lw = 1.0 / np.maximum(1.0, np.abs(self.label_np))
        if self.weights_np is not None:
            lw = lw * self.weights_np
        self.label_weight_np = lw.astype(np.float32)
        self.label_weight = torch.as_tensor(self.label_weight_np,
                                            device=self.device)

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self.label_weight
        hess = (torch.ones_like(score) if self.weights is None else
                self.weights.expand_as(score).clone())
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self.label_np, self.label_weight_np, 0.5)

    def renew_tree_output(self, leaf_rows_residual, leaf_rows_weight) -> float:
        # leaf_rows_weight here carries the MAPE label weights (GBDT passes them)
        return weighted_percentile(leaf_rows_residual, leaf_rows_weight, 0.5)


class RegressionGammaLoss(RegressionPoissonLoss):
    """Gamma deviance with log link: grad = 1 - y*exp(-f), hess = y*exp(-f)
    (:671-693; weights applied to both terms, as the JAX package does)."""
    name = "gamma"

    def get_gradients(self, score):
        rate = self.label * torch.exp(-score)
        grad = 1.0 - rate
        hess = rate
        return self._apply_weights(grad, hess)


class RegressionTweedieLoss(RegressionPoissonLoss):
    """Tweedie with variance power rho (:707-730)."""
    name = "tweedie"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        grad = -self.label * e1 + e2
        hess = -self.label * (1.0 - self.rho) * e1 + (2.0 - self.rho) * e2
        return self._apply_weights(grad, hess)
