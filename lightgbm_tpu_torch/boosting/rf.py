"""Random forest mode (src/boosting/rf.hpp:25-218).

Counterpart of ``lightgbm_tpu/boosting/rf.py``: bagging and feature
subsampling are required (checked by the config), the learning rate is 1,
the gradients are computed once, at the constant init scores, every tree
takes the init score as a bias, and the scores hold the running average of
the trees' outputs (``average_output``: ``predict`` divides by the number of
iterations).  The running average keeps the JAX package's f32 order: the
score times ``it``, plus the tree, times ``1 / (it + 1)``.  Custom
objectives are refused.  A checkpoint carries the constant init scores the
gradients are taken at (``_extra_train_state``, rf.py:36-50): after a resume
the model is not empty, and ``_boost_from_average`` would give 0.
"""
from __future__ import annotations

import numpy as np
import torch

from .gbdt import GBDT
from ..core.tree import Tree
from ..core.tree_learner import tree_from_arrays
from ..utils.log import LightGBMError, Log

K_EPSILON = 1e-15


class RF(GBDT):
    """Random forest on top of :class:`GBDT`."""

    average_output = True

    def __init__(self, config, train_data=None, objective=None,
                 device=None, group=None) -> None:
        super().__init__(config, train_data, objective, device=device,
                         group=group)
        self.shrinkage_rate = 1.0
        self._init_scores = [0.0] * self.num_tree_per_iteration
        self._init_scores_ready = False
        if objective is None:
            Log.fatal("RF mode do not support custom objective function, "
                      "please use built-in objectives.")
        self._rf_grad = None
        self._rf_skip = False

    def _extra_train_state(self):
        return {"init_scores": [float(s) for s in self._init_scores],
                "init_scores_ready": bool(self._init_scores_ready)}

    def _restore_extra_train_state(self, extra):
        if "init_scores" in extra:
            self._init_scores = [float(s) for s in extra["init_scores"]]
            self._init_scores_ready = bool(extra.get("init_scores_ready"))
            self._rf_grad = None

    def _get_gradients(self):
        """[K, N] gradients at the constant init scores, computed once
        (rf.hpp:83-101); the init scores are not added to the scores."""
        if self._rf_grad is None:
            K = self.num_tree_per_iteration
            if not self._init_scores_ready:
                for k in range(K):
                    self._init_scores[k] = self._boost_from_average(k, False)
                self._init_scores_ready = True
            init = torch.as_tensor(np.asarray(self._init_scores, np.float32),
                                   device=self.device)
            scores = init[:, None].expand(K, self.num_data).contiguous()
            if K == 1:
                g, h = self.objective.get_gradients(scores[0])
                grad, hess = g[None, :], h[None, :]
            else:
                grad, hess = self.objective.get_gradients(scores)
            # the gradients never change: guarded once, and the sanitised
            # pair and the skip verdict kept (rf.py:77-86)
            grad, hess, self._rf_skip = self._guard_gradients(grad, hess)
            self._rf_grad = (grad, hess)
        return self._rf_grad

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One tree per class on the constant gradients, averaged into the
        scores (rf.py:77-133)."""
        if gradients is not None or hessians is not None:
            raise LightGBMError("RF does not accept custom gradients")
        self.shrinkage_rate = 1.0
        self._keep_pre_iter_scores()
        it = self.iter_ + self.num_init_iteration
        grad, hess = self._get_gradients()
        if self._rf_skip:
            return self._skip_iteration(self._init_scores)
        self._bagging(self.iter_)
        feature_mask = self._feature_mask()
        should_continue = False
        for k in range(self.num_tree_per_iteration):
            new_tree = Tree(1)
            self.last_arrays = None
            if self.class_need_train[k]:
                gk, hk = grad[k], hess[k]
                if self.bag_mask is not None:
                    gk = gk * self.bag_mask
                    hk = hk * self.bag_mask
                arrays = self.learner.train(gk, hk, self.bag_data_cnt,
                                            feature_mask)
                if arrays.num_leaves > 1:
                    should_continue = True
                    new_tree = self._average_in(arrays, k, it)
            self.models.append(new_tree)
            self._last_iter_arrays.append(self.last_arrays)
        self._invalidate_predict_cache()
        if not should_continue:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > self.num_tree_per_iteration:
                del self.models[-self.num_tree_per_iteration:]
            return True
        self.iter_ += 1
        return False

    def _average_in(self, arrays, k: int, it: int) -> Tree:
        """The host tree of ``arrays`` (renewed, plus the init score as a
        bias) averaged into the train and validation scores of class
        ``k`` as the ``it``-th tree."""
        tree = tree_from_arrays(arrays, self.train_data, 1.0)
        renewed = self._renew_tree_output(arrays, k)
        if renewed is not None:
            tree.leaf_value[:tree.num_leaves] = renewed
            arrays = arrays._replace(leaf_value=renewed.astype(np.float32))
        init = self._init_scores[k]
        if abs(init) > K_EPSILON:
            tree.add_bias(init)
            arrays = arrays._replace(
                leaf_value=arrays.leaf_value + np.float32(init))
        lv = torch.as_tensor(arrays.leaf_value, device=self.device)
        score = self.train_score[k]
        score.mul_(float(it)).add_(lv[arrays.row_leaf]).mul_(1.0 / (it + 1))
        for vs in self.valid_sets:
            vscore = vs["score"][k]
            vscore.mul_(float(it))
            self._add_tree_score_valid(tree, k, vs)
            vscore.mul_(1.0 / (it + 1))
        self.last_arrays = arrays
        return tree
