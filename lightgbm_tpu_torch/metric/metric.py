"""Copied from ``lightgbm_tpu/metric/metric.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports differ.

Metric interface + factory (src/metric/metric.cpp:18-62).

Metrics evaluate on host NumPy — evaluation is periodic (metric_freq) and cheap
relative to training; raw scores are converted through the objective's
ConvertOutput exactly like the reference (regression_metric.hpp:74-92).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.log import Log


class Metric:
    names: List[str]
    factor_to_bigger_better: float = -1.0  # losses by default

    def __init__(self, config) -> None:
        self.config = config
        self.names = []

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, dtype=np.float64))
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(self.weights.sum()))
        self.metadata = metadata

    def eval(self, score: np.ndarray, objective=None) -> List[float]:
        raise NotImplementedError

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weights is not None:
            return float((pointwise * self.weights).sum() / self.sum_weights)
        return float(pointwise.sum() / self.sum_weights)


def create_metric(name: str, config) -> Optional[Metric]:
    from .binary import AUCMetric, BinaryErrorMetric, BinaryLoglossMetric
    from .multiclass import AucMuMetric, MultiErrorMetric, MultiSoftmaxLoglossMetric
    from .rank import MapMetric, NDCGMetric
    from .regression import (FairLossMetric, GammaDevianceMetric, GammaMetric,
                             HuberLossMetric, L1Metric, L2Metric, MAPEMetric,
                             PoissonMetric, QuantileMetric, RMSEMetric,
                             TweedieMetric)
    from .xentropy import (CrossEntropyLambdaMetric, CrossEntropyMetric,
                           KullbackLeiblerDivergence)
    table = {
        "l2": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
        "quantile": QuantileMetric, "huber": HuberLossMetric,
        "fair": FairLossMetric, "poisson": PoissonMetric,
        "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
        "auc": AUCMetric, "auc_mu": AucMuMetric,
        "ndcg": NDCGMetric, "map": MapMetric,
        "multi_logloss": MultiSoftmaxLoglossMetric, "multi_error": MultiErrorMetric,
        "cross_entropy": CrossEntropyMetric,
        "cross_entropy_lambda": CrossEntropyLambdaMetric,
        "kullback_leibler": KullbackLeiblerDivergence,
        "mape": MAPEMetric, "gamma": GammaMetric,
        "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    }
    if name in ("custom", ""):
        return None
    cls = table.get(name)
    if cls is None:
        Log.warning("Unknown metric type name: %s", name)
        return None
    return cls(config)


def create_metrics(names: Sequence[str], config) -> List[Metric]:
    out = []
    for n in names:
        m = create_metric(n, config)
        if m is not None:
            out.append(m)
    return out
