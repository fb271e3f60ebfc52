"""Objective factory (src/objective/objective_function.cpp:16-52): the JAX
package's whole table (``lightgbm_tpu/objective/__init__.py``)."""
from __future__ import annotations

from ..device import DeviceLike
from ..utils.log import Log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG, RankXENDCG
from .regression import (RegressionFairLoss, RegressionGammaLoss,
                         RegressionHuberLoss, RegressionL1Loss,
                         RegressionL2Loss, RegressionMAPELoss,
                         RegressionPoissonLoss, RegressionQuantileLoss,
                         RegressionTweedieLoss)
from .xentropy import CrossEntropy, CrossEntropyLambda

_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "quantile": RegressionQuantileLoss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "binary": BinaryLogloss,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "mape": RegressionMAPELoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
}


def create_objective(name: str, config,
                     device: DeviceLike = None) -> ObjectiveFunction | None:
    if name == "custom":
        return None
    cls = _OBJECTIVES.get(name)
    if cls is None:
        Log.fatal("Unknown objective type name: %s", name)
    return cls(config, device)


__all__ = ["ObjectiveFunction", "create_objective"] + [
    c.__name__ for c in _OBJECTIVES.values()]
