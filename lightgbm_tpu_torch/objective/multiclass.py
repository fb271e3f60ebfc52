"""Multiclass objectives (src/objective/multiclass_objective.hpp).

Counterpart of ``lightgbm_tpu/objective/multiclass.py``.  Scores are
[num_class, N] on the objective's device (the reference stores class-major
flat arrays, multiclass_objective.hpp:88); one-vs-all builds its K binaries
on :class:`BinaryLogloss`'s ``is_pos`` hook.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike
from ..utils.log import Log
from .base import ObjectiveFunction
from .binary import BinaryLogloss


class MulticlassSoftmax(ObjectiveFunction):
    """softmax CE: grad_k = p_k - 1{y=k}, hess_k = 2 p_k (1-p_k) (:81-115)."""
    name = "multiclass"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        labels = self.label_np.astype(np.int32)
        if labels.min() < 0 or labels.max() >= self.num_class:
            Log.fatal("Label must be in [0, %d), but found %s in label",
                      self.num_class,
                      labels.min() if labels.min() < 0 else labels.max())
        self._onehot = torch.as_tensor(
            np.eye(self.num_class, dtype=np.float32)[labels].T.copy(),
            device=self.device)                     # [K, N]

    def get_gradients(self, score):
        # jax.nn.softmax's operations: exp(x - max) / sum
        e = torch.exp(score - score.max(dim=0, keepdim=True).values)
        p = e / e.sum(dim=0, keepdim=True)          # [K, N]
        grad = p - self._onehot
        hess = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            grad = grad * self.weights[None, :]
            hess = hess * self.weights[None, :]
        return grad, hess

    def convert_output(self, scores):
        e = np.exp(scores - scores.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: num_class independent sigmoid binaries (:180-247)."""
    name = "multiclassova"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.num_class = int(config.num_class)
        self.num_model_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)
        self._binaries = [BinaryLogloss(config, device, is_pos=_IsClass(k))
                          for k in range(self.num_class)]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        for b in self._binaries:
            b.init(metadata, num_data)

    def get_gradients(self, score):
        grads, hesses = [], []
        for k, b in enumerate(self._binaries):
            g, h = b.get_gradients(score[k])
            grads.append(g)
            hesses.append(h)
        return torch.stack(grads), torch.stack(hesses)

    def boost_from_score(self, class_id: int = 0) -> float:
        return self._binaries[class_id].boost_from_score()

    def class_need_train(self, class_id: int) -> bool:
        return self._binaries[class_id].need_train

    def convert_output(self, scores):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * scores))


class _IsClass:
    def __init__(self, k: int) -> None:
        self.k = k

    def __call__(self, label):
        return np.abs(np.asarray(label) - self.k) < 1e-6
