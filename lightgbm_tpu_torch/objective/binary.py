"""Binary log-loss objective (src/objective/binary_objective.hpp:21-215).

Counterpart of ``lightgbm_tpu/objective/binary.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike
from ..utils.log import Log
from .base import ObjectiveFunction

K_EPSILON = 1e-15


class BinaryLogloss(ObjectiveFunction):
    """grad = -y*sig / (1 + exp(y*sig*score)) with y in {-1, +1}
    (binary_objective.hpp:108-137); class re-weighting via is_unbalance /
    scale_pos_weight (:95-105); initscore = log(pavg/(1-pavg))/sigmoid
    (:139-160).  ``is_pos`` maps labels to the positive class (``label >
    0`` by default; one-vs-all multiclass passes ``label == k``)."""
    need_accurate_prediction = False
    name = "binary"

    def __init__(self, config, device: DeviceLike = None, is_pos=None):
        super().__init__(config, device)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        self._is_pos = is_pos or (lambda label: label > 0)
        self.need_train = True
        self.num_pos_data = 0

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        pos = self._is_pos(self.label_np)
        cnt_pos = int(pos.sum())
        cnt_neg = num_data - cnt_pos
        self.num_pos_data = cnt_pos
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        if not self.need_train:
            Log.warning("Contains only one class")
        Log.info("Number of positive: %d, number of negative: %d", cnt_pos,
                 cnt_neg)
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        pos_t = torch.as_tensor(pos, device=self.device)
        one = torch.ones((), dtype=torch.float32, device=self.device)
        self._yval = torch.where(pos_t, one, -one)
        self._label_weight = torch.where(
            pos_t, torch.tensor(w_pos, dtype=torch.float32, device=self.device),
            torch.tensor(w_neg, dtype=torch.float32, device=self.device))

    def get_gradients(self, score):
        if not self.need_train:
            return torch.zeros_like(score), torch.zeros_like(score)
        y = self._yval
        response = -y * self.sigmoid / (1.0 + torch.exp(y * self.sigmoid * score))
        abs_resp = torch.abs(response)
        grad = response * self._label_weight
        hess = abs_resp * (self.sigmoid - abs_resp) * self._label_weight
        return self._apply_weights(grad, hess)

    def carry_aux(self):
        """y * label weight: its sign carries the class, its magnitude the
        class re-weighting (binary.py:65-69); None with sample weights."""
        if not self.need_train or self.weights is not None:
            return None
        return self._yval * self._label_weight

    def pointwise_gradients(self, score, aux):
        """:meth:`get_gradients` of rows carrying ``aux`` (binary.py:71-76):
        the same f32 operations, ``|aux|`` the label weight."""
        y = torch.sign(aux)
        lw = torch.abs(aux)
        response = -y * self.sigmoid / (1.0 + torch.exp(y * self.sigmoid
                                                         * score))
        abs_resp = torch.abs(response)
        return response * lw, abs_resp * (self.sigmoid - abs_resp) * lw

    def boost_from_score(self, class_id: int = 0) -> float:
        pos = self._is_pos(self.label_np).astype(np.float64)
        if self.weights_np is not None:
            pavg = float(np.average(pos, weights=self.weights_np))
        else:
            pavg = float(pos.mean())
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        initscore = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        Log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f", self.name,
                 pavg, initscore)
        return initscore

    def class_need_train(self, class_id: int = 0) -> bool:
        return self.need_train

    def convert_output(self, scores):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * scores))

    def to_string(self):
        return "%s sigmoid:%g" % (self.name, self.sigmoid)
