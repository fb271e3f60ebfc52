"""PyTorch/CUDA port of lightgbm_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference ``lightgbm_tpu``; it imports torch
and numpy and nothing of JAX or of ``lightgbm_tpu``.  The public surface is
the JAX package's (python-package/lightgbm/__init__.py): ``Dataset`` (numpy,
pandas, sparse or a text file) and ``Booster``, ``train`` and ``cv``, the
sklearn estimators, callbacks and plotting, and the CLI ``python -m
lightgbm_tpu_torch config=train.conf``.  Underneath: ``BinnedDataset`` ->
``Config`` -> ``GBDT(cfg, ds, create_objective("binary", cfg))`` ->
``train_one_iter`` -> ``predict``, with hand-written CUDA kernels for the
row-store histograms and the fused split passes (``csrc/``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"`` (see
:mod:`lightgbm_tpu_torch.device`).  ``c_api`` carries the ``LGBM_*`` C
ABI, which ``python -m lightgbm_tpu_torch.capi_build`` compiles into
``lib_lightgbm_tpu_torch.so``; ``resilience`` the preemption flag and the
watchdog; ``serve`` (and ``Booster.serve``) the serving tier
(``serving``: continuous batching, multi-model residency, hot swap, the
single-row fast path); ``obs`` the telemetry plane (``telemetry_out``,
``metrics_port``, ``alert_rules``, ``flight_recorder``);
``serve_and_train`` the train-while-serve loop (``online``); ``plan`` the
kernel planner and its autotuner (``plan_cache``); ``core.compact`` the
ensemble compaction.  The sklearn estimators and plotting are
imported on first use (they import sklearn and pandas when installed).
"""
import importlib

from . import obs
from .basic import Booster, Dataset
from .boosting.gbdt import GBDT
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, serve, serve_and_train, train
from .io.dataset import BinnedDataset
from .objective import create_objective
from .utils.log import LightGBMError

__version__ = "2.3.2"

__all__ = ["Dataset", "Booster", "CVBooster", "LightGBMError",
           "train", "cv", "serve", "serve_and_train", "obs",
           "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "EarlyStopException",
           "plot_importance", "plot_split_value_histogram", "plot_metric",
           "plot_tree", "create_tree_digraph",
           "GBDT", "Config", "BinnedDataset", "create_objective"]

_LAZY = {name: "sklearn" for name in ("LGBMModel", "LGBMRegressor",
                                      "LGBMClassifier", "LGBMRanker")}
_LAZY.update({name: "plotting" for name in (
    "plot_importance", "plot_split_value_histogram", "plot_metric",
    "plot_tree", "create_tree_digraph")})


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module("." + _LAZY[name], __name__),
                       name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
