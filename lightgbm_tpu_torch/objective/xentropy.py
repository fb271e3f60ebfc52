"""Cross-entropy objectives for probabilistic labels in [0, 1].

Counterpart of ``lightgbm_tpu/objective/xentropy.py`` (the reference's
src/objective/xentropy_objective.hpp): elementwise torch on the objective's
device, in the JAX package's f32 operations and order."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction

K_EPSILON = 1e-15


class CrossEntropy(ObjectiveFunction):
    """grad = sigmoid(f) - y (:76-93); initscore = logit(mean y) (:112-134)."""
    need_accurate_prediction = False
    name = "cross_entropy"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label_np.min() < 0 or self.label_np.max() > 1:
            Log.fatal("[%s]: label should be in the interval [0, 1]", self.name)

    def get_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score))
        grad = z - self.label
        hess = z * (1.0 - z)
        return self._apply_weights(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights_np is not None:
            pavg = float(np.average(self.label_np, weights=self.weights_np))
        else:
            pavg = float(self.label_np.mean())
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        init = float(np.log(pavg / (1.0 - pavg)))
        Log.info("[%s:BoostFromScore]: pavg = %f -> initscore = %f",
                 self.name, pavg, init)
        return init

    def convert_output(self, scores):
        return 1.0 / (1.0 + np.exp(-scores))


class CrossEntropyLambda(ObjectiveFunction):
    """Alternative parameterization with weight-dependent link (:185-260)."""
    need_accurate_prediction = False
    name = "cross_entropy_lambda"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label_np.min() < 0 or self.label_np.max() > 1:
            Log.fatal("[%s]: label should be in the interval [0, 1]", self.name)

    def get_gradients(self, score):
        if self.weights is None:
            z = 1.0 / (1.0 + torch.exp(-score))
            grad = z - self.label
            hess = z * (1.0 - z)
            return grad, hess
        w = self.weights
        y = self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights_np is not None:
            havg = float(np.average(self.label_np, weights=self.weights_np))
        else:
            havg = float(self.label_np.mean())
        init = float(np.log(max(np.exp(havg) - 1.0, K_EPSILON)))
        Log.info("[%s:BoostFromScore]: havg = %f -> initscore = %f",
                 self.name, havg, init)
        return init

    def convert_output(self, scores):
        # output is the normalized exponential parameter (:228-231)
        return np.log1p(np.exp(scores))
