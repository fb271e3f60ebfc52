"""DART: dropouts meet multiple additive regression trees
(src/boosting/dart.hpp:23-211).

Counterpart of ``lightgbm_tpu/boosting/dart.py``.  Before each iteration's
gradients, a random set of earlier iterations is dropped: their trees are
negated and added to the train score, and the learning rate of the new tree
becomes ``learning_rate / (1 + k)`` (``learning_rate / (learning_rate + k)``
in ``xgboost_dart_mode``) for k dropped iterations.  After the new tree, the
dropped trees are scaled back to ``k / (k + 1)`` of their weight and re-added
to the train and validation scores (``_normalize``).  The drop draws come
from ``RandomState(drop_seed)`` in the JAX package's order, with
``uniform_drop``, ``max_drop`` and ``skip_drop``; without ``uniform_drop``
each iteration's weight is kept (``tree_weight``) and makes its drop
probability.  Host trees shrink in f64 (``lazy_trees = False``).  A
checkpoint carries the drop stream and the weight history
(``_extra_train_state``, dart.py:31-47).  With a telemetry run active,
every drop observes ``dart_dropped_trees`` and every ``telemetry_freq``-th
iteration emits a ``dart_drop`` event (dart.py:99-107).
"""
from __future__ import annotations

import numpy as np

from .gbdt import GBDT
from ..checkpoint import decode_rng_state, encode_rng_state
from ..obs import active as _telemetry_active


class DART(GBDT):
    """Dropout boosting on top of :class:`GBDT`."""

    lazy_trees = False
    keep_rollback_scores = False

    def __init__(self, config, train_data=None, objective=None,
                 device=None, group=None) -> None:
        self._drop_rng = np.random.RandomState(int(config.drop_seed))
        self.tree_weight = []
        self.sum_weight = 0.0
        self.drop_index = []
        self._score_is_dropped = False
        super().__init__(config, train_data, objective, device=device,
                         group=group)

    def _extra_train_state(self):
        """The drop stream and the weight history that set later drops
        (dart.py:31-40)."""
        return {"drop_rng": encode_rng_state(self._drop_rng),
                "tree_weight": [float(w) for w in self.tree_weight],
                "sum_weight": float(self.sum_weight)}

    def _restore_extra_train_state(self, extra):
        self._drop_rng.set_state(decode_rng_state(extra["drop_rng"]))
        self.tree_weight = [float(w) for w in extra.get("tree_weight", [])]
        self.sum_weight = float(extra.get("sum_weight", 0.0))
        self.drop_index = []
        self._score_is_dropped = False

    def _get_gradients(self):
        """Drop trees once an iteration, then the gradients of the dropped
        score (dart.hpp:76-86)."""
        if not self._score_is_dropped:
            self._dropping_trees()
            self._score_is_dropped = True
        return super()._get_gradients()

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._score_is_dropped = False
        if super().train_one_iter(gradients, hessians):
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def _dropping_trees(self) -> None:
        """Choose ``drop_index`` (dart.hpp:95-137) and take the dropped
        trees out of the train score; set this iteration's
        ``shrinkage_rate``."""
        self.drop_index = []
        cfg = self.config
        if self._drop_rng.uniform() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate, cfg.max_drop * inv_avg
                                        / self.sum_weight)
                    for i in range(self.iter_):
                        if (self._drop_rng.uniform()
                                < drop_rate * self.tree_weight[i] * inv_avg):
                            self.drop_index.append(self.num_init_iteration
                                                   + i)
                            if len(self.drop_index) >= cfg.max_drop > 0:
                                break
            else:
                if cfg.max_drop > 0 and self.iter_ > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
                for i in range(self.iter_):
                    if self._drop_rng.uniform() < drop_rate:
                        self.drop_index.append(self.num_init_iteration + i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
        K = self.num_tree_per_iteration
        for i in self.drop_index:
            for c in range(K):
                tree = self.models[i * K + c]
                tree.shrink(-1.0)
                self._add_tree_score_train(tree, c)
        kdrop = len(self.drop_index)
        tele = _telemetry_active()
        if tele is not None:
            tele.histogram("dart_dropped_trees").observe(kdrop)
            if self.iter_ % tele.freq == 0:
                tele.event("dart_drop", iteration=int(self.iter_),
                           dropped=int(kdrop))
        lr = self.config.learning_rate
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + kdrop)
        else:
            self.shrinkage_rate = lr if kdrop == 0 else lr / (lr + kdrop)

    def _normalize(self) -> None:
        """Re-add the dropped trees at ``k / (k + 1)`` of their weight
        (dart.hpp:139-183), in the JAX package's order of ``shrink`` calls,
        and update the weight history."""
        k = float(len(self.drop_index))
        cfg = self.config
        K = self.num_tree_per_iteration
        for i in self.drop_index:
            for c in range(K):
                tree = self.models[i * K + c]
                if not cfg.xgboost_dart_mode:
                    tree.shrink(1.0 / (k + 1.0))     # -w/(k+1)
                    for vs in self.valid_sets:
                        self._add_tree_score_valid(tree, c, vs)
                    tree.shrink(-k)                  # w*k/(k+1)
                    self._add_tree_score_train(tree, c)
                else:
                    tree.shrink(self.shrinkage_rate)
                    for vs in self.valid_sets:
                        self._add_tree_score_valid(tree, c, vs)
                    tree.shrink(-k / cfg.learning_rate)
                    self._add_tree_score_train(tree, c)
            if not cfg.uniform_drop:
                j = i - self.num_init_iteration
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[j] / (k + 1.0)
                    self.tree_weight[j] *= k / (k + 1.0)
                else:
                    self.sum_weight -= (self.tree_weight[j]
                                        / (k + cfg.learning_rate))
                    self.tree_weight[j] *= k / (k + cfg.learning_rate)
        self._invalidate_predict_cache()
