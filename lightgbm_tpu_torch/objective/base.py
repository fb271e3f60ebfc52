"""Objective function interface.

Counterpart of ``lightgbm_tpu/objective/base.py`` (the reference
``ObjectiveFunction``, include/LightGBM/objective_function.h): gradients and
hessians from scores, boost-from-score, raw-score -> output conversion.
Gradients are computed on the objective's device with torch; the per-leaf
output renewal of the percentile objectives (l1, quantile, mape) runs on host
numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..io.metadata import Metadata


class ObjectiveFunction:
    name: str = "custom"
    num_model_per_iteration: int = 1
    is_renew_tree_output: bool = False
    # prediction early stop is refused for objectives whose outputs need
    # every tree (predictor.hpp:38-47); the classifiers set False
    need_accurate_prediction: bool = True

    def __init__(self, config, device: DeviceLike = None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.num_data = 0
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None
        self.label_np: Optional[np.ndarray] = None
        self.weights_np: Optional[np.ndarray] = None

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label_np = np.asarray(metadata.label, dtype=np.float32)
        self.label = torch.as_tensor(self.label_np, device=self.device)
        if metadata.weights is not None:
            self.weights_np = np.asarray(metadata.weights, dtype=np.float32)
            self.weights = torch.as_tensor(self.weights_np, device=self.device)
        else:
            self.weights_np = None
            self.weights = None
        self.metadata = metadata

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """score: [num_model_per_iteration, N] (or [N]) raw scores ->
        (grad, hess) f32 of the same shape."""
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, scores: np.ndarray) -> np.ndarray:
        """Raw score -> prediction output (identity by default)."""
        return scores

    def renew_tree_output(self, leaf_rows_residual: np.ndarray,
                          leaf_rows_weight: Optional[np.ndarray]) -> float:
        """New output for one leaf given its rows' residuals (+weights)."""
        raise NotImplementedError

    def _apply_weights(self, grad, hess):
        if self.weights is not None:
            return grad * self.weights, hess * self.weights
        return grad, hess

    def to_string(self) -> str:
        return self.name
