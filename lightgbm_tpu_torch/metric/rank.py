"""Copied from ``lightgbm_tpu/metric/rank.py`` for the PyTorch port (which imports
nothing of the JAX package); unchanged but for this note.

Ranking metrics: NDCG@k (src/metric/rank_metric.hpp) and MAP@k
(src/metric/map_metric.hpp)."""
from __future__ import annotations

import numpy as np

from .dcg import DCGCalculator
from .metric import Metric
from ..utils.log import Log


def default_eval_at(eval_at):
    return list(eval_at) if eval_at else [1, 2, 3, 4, 5]


class NDCGMetric(Metric):
    factor_to_bigger_better = 1.0

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = default_eval_at(config.eval_at)
        DCGCalculator.init(list(config.label_gain) or None)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = ["ndcg@%d" % k for k in self.eval_at]
        if metadata.query_boundaries is None:
            Log.fatal("The NDCG metric requires query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.num_queries = len(self.query_boundaries) - 1
        Log.info("Total groups: %d, total data: %d", self.num_queries, num_data)
        self.query_weights = metadata.query_weights
        self.sum_query_weights = (float(self.num_queries)
                                  if self.query_weights is None
                                  else float(self.query_weights.sum()))
        # cache per-query max DCG at each k (rank_metric.hpp inverse_max_dcgs_)
        self.inverse_max_dcgs = np.zeros((self.num_queries, len(self.eval_at)))
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            for ki, k in enumerate(self.eval_at):
                m = DCGCalculator.cal_max_dcg_at_k(k, self.label[lo:hi])
                self.inverse_max_dcgs[q, ki] = 1.0 / m if m > 0 else -1.0

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            w = 1.0 if self.query_weights is None else self.query_weights[q]
            for ki, k in enumerate(self.eval_at):
                inv = self.inverse_max_dcgs[q, ki]
                if inv <= 0:
                    # all-zero-gain query counts as perfect (rank_metric.hpp)
                    result[ki] += w
                else:
                    dcg = DCGCalculator.cal_dcg_at_k(k, self.label[lo:hi], s[lo:hi])
                    result[ki] += dcg * inv * w
        return [float(r / self.sum_query_weights) for r in result]


class MapMetric(Metric):
    factor_to_bigger_better = 1.0

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = default_eval_at(config.eval_at)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = ["map@%d" % k for k in self.eval_at]
        if metadata.query_boundaries is None:
            Log.fatal("For MAP metric, there should be query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.num_queries = len(self.query_boundaries) - 1
        Log.info("Total groups: %d, total data: %d", self.num_queries, num_data)
        self.query_weights = metadata.query_weights
        self.sum_query_weights = (float(self.num_queries)
                                  if self.query_weights is None
                                  else float(self.query_weights.sum()))

    def _map_at_ks(self, label, score):
        """Cumulative AP at each k (map_metric.hpp:CalMapAtK)."""
        order = np.argsort(-score, kind="stable")
        is_pos = label[order] > 0.5
        npos = int(is_pos.sum())
        hits = np.cumsum(is_pos)
        prec = np.where(is_pos, hits / (np.arange(len(label)) + 1.0), 0.0)
        sum_ap = np.cumsum(prec)
        out = []
        for k in self.eval_at:
            kk = min(k, len(label))
            if npos > 0:
                out.append(sum_ap[kk - 1] / min(npos, kk))
            else:
                out.append(1.0)
        return out

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(-1)
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            w = 1.0 if self.query_weights is None else self.query_weights[q]
            result += w * np.asarray(self._map_at_ks(self.label[lo:hi], s[lo:hi]))
        return [float(r / self.sum_query_weights) for r in result]
