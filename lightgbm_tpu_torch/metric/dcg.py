"""Copied from ``lightgbm_tpu/metric/dcg.py`` for the PyTorch port (which
imports nothing of the JAX package); unchanged but for this note.

DCG/NDCG computation (src/metric/dcg_calculator.cpp DCGCalculator):
label gains default to 2^label - 1, position discount 1/log2(2 + i)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.log import Log

_MAX_POSITION = 10000


class DCGCalculator:
    label_gain_: np.ndarray = np.array([(1 << i) - 1 for i in range(31)],
                                       dtype=np.float64)
    discount_: np.ndarray = 1.0 / np.log2(2.0 + np.arange(_MAX_POSITION))

    @classmethod
    def default_label_gain(cls) -> List[float]:
        return [(1 << i) - 1 for i in range(31)]

    @classmethod
    def init(cls, label_gain: Optional[Sequence[float]] = None) -> None:
        if label_gain:
            cls.label_gain_ = np.asarray(label_gain, dtype=np.float64)

    @classmethod
    def check_label(cls, label: np.ndarray) -> None:
        li = label.astype(np.int64)
        if (np.abs(label - li) > 1e-6).any():
            Log.fatal("NDCG labels must be integer")
        if li.min() < 0 or li.max() >= len(cls.label_gain_):
            Log.fatal("Label %s is not less than the number of label mappings (%d)",
                      li.max(), len(cls.label_gain_))

    @classmethod
    def discount(cls, position: np.ndarray) -> np.ndarray:
        return cls.discount_[position]

    @classmethod
    def cal_max_dcg_at_k(cls, k: int, label: np.ndarray) -> float:
        gains = np.sort(cls.label_gain_[label.astype(np.int64)])[::-1]
        k = min(k, len(gains))
        return float((gains[:k] * cls.discount_[:k]).sum())

    @classmethod
    def cal_dcg_at_k(cls, k: int, label: np.ndarray,
                     score: np.ndarray) -> float:
        order = np.argsort(-score, kind="stable")
        gains = cls.label_gain_[label.astype(np.int64)[order]]
        k = min(k, len(gains))
        return float((gains[:k] * cls.discount_[:k]).sum())
