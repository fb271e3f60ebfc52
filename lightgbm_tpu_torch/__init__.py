"""PyTorch/CUDA port of lightgbm_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference ``lightgbm_tpu``; it imports torch
and numpy and nothing of JAX or of ``lightgbm_tpu``.  Entry points:
``train(params, Dataset(X, y), valid_sets=[...])`` -> ``Booster`` (with
validation sets, metrics and early stopping), and underneath it
``BinnedDataset.from_matrix`` -> ``Config`` -> ``GBDT(cfg, ds,
create_objective("binary", cfg))`` -> ``train_one_iter`` -> ``predict``, with
hand-written CUDA kernels for the row-store histogram and the fused split
pass (``csrc/``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`lightgbm_tpu_torch.device`).
"""
from .basic import Booster, Dataset
from .boosting.gbdt import GBDT
from .config import Config
from .engine import train
from .io.dataset import BinnedDataset
from .objective import create_objective

__all__ = ["Booster", "Dataset", "GBDT", "Config", "BinnedDataset",
           "create_objective", "train"]
