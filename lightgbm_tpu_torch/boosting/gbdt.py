"""GBDT training loop (the main path of the port).

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` (the reference ``GBDT``,
src/boosting/gbdt.cpp, gbdt.h): ``__init__``, ``_boost_from_average``,
bagging (``_bagging``: the JAX package's stateless per-row hash, plain and
pos/neg balanced; ``_bag_rng``, the sequential stream GOSS samples from) and
``feature_fraction`` (``_feature_mask``), ``train_one_iter`` (synchronous:
one host tree per class and iteration; with ``gradients``/``hessians`` for a
custom objective; the hooks ``_get_gradients`` and
``_adjust_gradients_for_bagging`` that DART and GOSS override), the leaf
renewal of the percentile objectives (``_renew_tree_output``),
``train_score``, validation sets (``add_valid_data``), the score add of a
host tree (``_add_tree_score_train`` / ``_add_tree_score_valid``, which
DART's drops use), metrics and early stopping (``eval_train``,
``eval_valid``, ``eval_and_check_early_stopping``), the host loop ``train``,
the replay of a loaded model (``replay_train_score``), ``predict`` (averaged
over the iterations for ``average_output``, as RF's), ``feature_importance``
and the reference-compatible text model (``save_model_to_string`` /
``load_model_from_string``, gbdt_model_text.cpp:271,375).

Scores live on the device: ``train_score`` [K, N] f32 and one [K, N_v] f32
score per validation set, K = ``num_tree_per_iteration`` (the number of
classes for multiclass objectives, else 1).  Each iteration:
boost-from-average (first iteration, added to every score), objective
gradients on the device, the bag mask and feature mask, then per class one
tree from :class:`SerialTreeLearner` on the masked gradients, the tree's leaf
values scaled by the learning rate in f32, the class's train score updated
through the tree's ``row_leaf`` and each validation score by routing the
set's bins on the device (``route_binned``).  DART, GOSS and RF subclass
this class (``boosting/dart.py``, ``goss.py``, ``rf.py``; built by
``boosting.create_boosting``).  The fused multi-iteration scan, snapshots and
checkpoints are not ported yet (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.predict import StackedTrees
from ..core.quant import _M32, _mul32
from ..core.tree import Tree
from ..core.tree_learner import (SerialTreeLearner, TreeArrays,
                                 arrays_from_tree, route_binned,
                                 tree_from_arrays)
from ..device import DeviceLike, resolve_device
from ..io.dataset import BinnedDataset
from ..metric.metric import Metric, create_metrics
from ..objective import ObjectiveFunction, create_objective
from ..utils.file_io import atomic_write
from ..utils.log import LightGBMError, Log

K_EPSILON = 1e-15
MODEL_VERSION = "v3"


def _bag_uniforms(row_ids: torch.Tensor, seed: int,
                  it_window: int) -> torch.Tensor:
    """Per-row uniforms in [0, 1) as f32 for bagging, keyed by (original row
    id, bagging window): the JAX package's stateless integer hash
    (``_bag_uniforms``, gbdt.py:88-108), bit for bit.  torch has little
    ``uint32`` support, so the hash runs in ``int64`` masked to 32 bits after
    each step (``_mul32`` keeps every product below 2**49); the final
    int -> f32 conversion rounds to nearest even, as XLA's ``uint32 ->
    float32`` does, and the scale is a power of two."""
    x = _mul32(row_ids.to(torch.int64) & _M32, 2654435761)
    x = x ^ (((int(seed) & _M32) + int(it_window) * 0x9E3779B9) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def bag_mask_for(row_ids: torch.Tensor, seed: int, it: int, freq: int,
                 frac) -> Tuple[torch.Tensor, int]:
    """(mask f32 0/1, realised count) for iteration ``it``
    (``_bag_mask_for``, gbdt.py:111-122): rows whose uniform of the window
    ``it - it % freq`` is below ``frac`` (a float, or a per-row f32 tensor
    for pos/neg balanced bagging); the count is at least 1."""
    u = _bag_uniforms(row_ids, seed, it - it % freq)
    if not isinstance(frac, torch.Tensor):
        frac = torch.tensor(frac, dtype=torch.float32, device=u.device)
    mask = (u < frac).to(torch.float32)
    return mask, max(int(mask.sum(dtype=torch.float32)), 1)


class GBDT:
    """Gradient Boosting Decision Tree (sub-model name "tree", gbdt.h:362).

    ``device`` follows the port's device rule (``lightgbm_tpu_torch.device``):
    ``cuda`` unless the caller passes ``"cpu"``; no silent CPU fallback."""

    average_output = False
    # the host tree takes the f32-scaled leaf values (the JAX package's lazy
    # path); DART sets False: its host trees shrink in f64 and its scores
    # take the f32 products (the JAX package's synchronous path)
    lazy_trees = True

    def __init__(self, config: Config,
                 train_data: Optional[BinnedDataset] = None,
                 objective: Optional[ObjectiveFunction] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.models: List[Tree] = []
        self.iter_ = 0
        self.num_init_iteration = 0
        self.train_data: Optional[BinnedDataset] = None
        self.objective = objective
        self.num_tree_per_iteration = 1
        self.num_class = int(config.num_class)
        self.shrinkage_rate = float(config.learning_rate)
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.label_idx = 0
        self.last_arrays: Optional[TreeArrays] = None
        self._predictor = None
        self.valid_sets: List[dict] = []
        self.train_metrics: List[Metric] = []
        # iteration of the best validation score when early stopping ended
        # training (0: it did not)
        self.best_iteration = 0
        self._es_state: Dict = {}
        if train_data is not None:
            self.reset_training_data(train_data, objective)

    # ---- setup ----

    def reset_training_data(self, train_data: BinnedDataset,
                            objective: Optional[ObjectiveFunction]) -> None:
        if objective is not None and objective.device != self.device:
            raise ValueError("objective is on %s, booster on %s"
                             % (objective.device, self.device))
        cfg = self.config
        self.train_data = train_data
        self.objective = objective
        self.num_data = train_data.num_data
        self.num_tree_per_iteration = (objective.num_model_per_iteration
                                       if objective else max(1, self.num_class))
        K = self.num_tree_per_iteration
        self.learner = SerialTreeLearner(train_data, cfg, self.device)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        self.train_score = torch.zeros((K, self.num_data), dtype=torch.float32,
                                       device=self.device)
        self._has_init_score = train_data.metadata.init_score is not None
        if self._has_init_score:
            init = np.asarray(train_data.metadata.init_score, dtype=np.float32)
            self.train_score[:] = torch.as_tensor(
                init.reshape(K, self.num_data), device=self.device)
        self.class_need_train = [True] * K
        if self.objective is not None:
            self.objective.init(train_data.metadata, self.num_data)
            if hasattr(self.objective, "class_need_train"):
                self.class_need_train = [self.objective.class_need_train(k)
                                         for k in range(K)]
        self.train_metrics = []
        self._es_state = {}
        # bagging: the stateless hash of the rows' ids (_bag_uniforms);
        # feature_fraction: one draw an iteration from this stream
        self._balanced_frac: Optional[torch.Tensor] = None
        self._row_ids = torch.arange(self.num_data, dtype=torch.int64,
                                     device=self.device)
        self._feat_rng = np.random.RandomState(int(cfg.feature_fraction_seed))
        # the sequential stream GOSS draws its "other" rows from (gbdt.py:
        # 419-422); plain bagging stays on the stateless hash
        self._bag_rng = np.random.RandomState(int(cfg.bagging_seed))
        self.bag_mask: Optional[torch.Tensor] = None
        self.bag_data_cnt = self.num_data
        self._train_bins: Optional[torch.Tensor] = None

    def add_train_metrics(self, metrics: Sequence[Metric]) -> None:
        self.train_metrics = list(metrics)
        for m in self.train_metrics:
            m.init(self.train_data.metadata, self.num_data)

    def add_valid_data(self, valid_data: BinnedDataset, name: str,
                       metrics: Optional[Sequence[Metric]] = None) -> None:
        """Attach a validation set (binned with the training set's mappers):
        its bins go to the device, its score starts at its init_score (or 0)
        plus the trees already in the model, replayed in f32 one tree at a
        time as training would have added them."""
        if metrics is None:
            metrics = create_metrics(self.config.metric, self.config)
        for m in metrics:
            m.init(valid_data.metadata, valid_data.num_data)
        K = self.num_tree_per_iteration
        score = torch.zeros((K, valid_data.num_data), dtype=torch.float32,
                            device=self.device)
        if valid_data.metadata.init_score is not None:
            init = np.asarray(valid_data.metadata.init_score, np.float32)
            score[:] = torch.as_tensor(init.reshape(K, valid_data.num_data),
                                       device=self.device)
        vs = {"name": name, "data": valid_data,
              "bins": self.learner.valid_bins(valid_data),
              "metrics": list(metrics), "score": score}
        for i, tree in enumerate(self.models):
            self._add_tree_score_valid(tree, i % K, vs)
        self.valid_sets.append(vs)

    def _add_tree_score(self, tree: Tree, bins: torch.Tensor,
                        score: torch.Tensor) -> None:
        """score [N] += the tree's leaf values (f32) over the binned rows."""
        if tree.num_leaves <= 1:
            score += np.float32(tree.leaf_value[0])
            return
        arrays = arrays_from_tree(tree, self.train_data)
        lv = torch.as_tensor(arrays.leaf_value, device=self.device)
        score += lv[route_binned(bins, arrays, self.learner.feat_host)]

    def train_bins(self) -> torch.Tensor:
        """The training set's binned matrix [N, C] on the device, made once
        (``route_bins_matrix``, tree_learner.py:1950-1960): what a host
        tree is routed over when it is added to the train score."""
        if self._train_bins is None:
            self._train_bins = self.learner.valid_bins(self.train_data)
        return self._train_bins

    def _add_tree_score_train(self, tree: Tree, class_id: int) -> None:
        """train_score[class_id] += the host tree's f32 leaf values over the
        training rows (gbdt.py:537-552)."""
        self._add_tree_score(tree, self.train_bins(),
                             self.train_score[class_id])

    def _add_tree_score_valid(self, tree: Tree, class_id: int,
                              vs: dict) -> None:
        """The same for the validation set ``vs`` (gbdt.py:554-563)."""
        self._add_tree_score(tree, vs["bins"], vs["score"][class_id])

    def replay_train_score(self) -> None:
        """train_score += every tree of a loaded model, in f32, one tree at a
        time into its class (the loaded-model replay of
        ``engine.train(init_model=...)``)."""
        if not self.models or self.train_data is None:
            return
        K = self.num_tree_per_iteration
        for i, tree in enumerate(self.models):
            self._add_tree_score_train(tree, i % K)

    # ---- bagging and feature sampling (gbdt.cpp:160-276) ----

    def _balanced_bagging(self) -> bool:
        """pos/neg_bagging_fraction balanced bagging is active (needs
        bagging_freq > 0 and either class fraction below 1; label > 0 marks
        the positive class)."""
        cfg = self.config
        return (cfg.bagging_freq > 0
                and (float(cfg.pos_bagging_fraction) < 1.0
                     or float(cfg.neg_bagging_fraction) < 1.0))

    def _bagging(self, it: int) -> None:
        """A new bag mask every ``bagging_freq`` iterations (gbdt.py:
        583-610): each row an independent Bernoulli draw of the stateless
        hash, at ``bagging_fraction`` or at the row's class fraction."""
        cfg = self.config
        balanced = self._balanced_bagging()
        plain = cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
        if (balanced or plain) and it % cfg.bagging_freq == 0:
            if balanced:
                if self._balanced_frac is None:
                    label = torch.as_tensor(
                        np.asarray(self.train_data.metadata.label)
                        [:self.num_data] > 0, device=self.device)
                    f32 = dict(dtype=torch.float32, device=self.device)
                    self._balanced_frac = torch.where(
                        label, torch.tensor(cfg.pos_bagging_fraction, **f32),
                        torch.tensor(cfg.neg_bagging_fraction, **f32))
                frac = self._balanced_frac
            else:
                frac = float(cfg.bagging_fraction)
            self.bag_mask, self.bag_data_cnt = bag_mask_for(
                self._row_ids, int(cfg.bagging_seed), int(it),
                int(cfg.bagging_freq), frac)
        elif self.bag_mask is None:
            self.bag_data_cnt = self.num_data

    def _feature_mask(self) -> Optional[torch.Tensor]:
        """The features one iteration's trees may split on: a draw without
        replacement of round(F * feature_fraction) of them from the
        booster's ``feature_fraction_seed`` stream (gbdt.py:612-621)."""
        ff = float(self.config.feature_fraction)
        nf = self.train_data.num_features
        if ff >= 1.0 or nf <= 1:
            return None
        used = max(1, int(round(nf * ff)))
        chosen = self._feat_rng.choice(nf, size=used, replace=False)
        mask = np.zeros(nf, dtype=bool)
        mask[chosen] = True
        return torch.as_tensor(mask, device=self.device)

    # ---- boosting (gbdt.cpp:143-158, 322-368) ----

    def _boost_from_average(self, class_id: int,
                            update_scorer: bool = True) -> float:
        """The first iteration's constant score of ``class_id``, added to
        the scores when ``update_scorer`` (RF takes it without adding it)."""
        if (not self.models and not self._has_init_score
                and self.objective is not None):
            if self.config.boost_from_average \
                    or self.train_data.num_features == 0:
                init_score = self.objective.boost_from_score(class_id)
                if abs(init_score) > K_EPSILON:
                    if update_scorer:
                        self._add_constant_score(init_score, class_id)
                    Log.info("Start training from score %f", init_score)
                    return init_score
            elif self.objective.name in ("regression_l1", "quantile", "mape"):
                Log.warning("Disabling boost_from_average in %s may cause the "
                            "slow convergence", self.objective.name)
        return 0.0

    def _add_constant_score(self, value: float, class_id: int) -> None:
        self.train_score[class_id] += value
        for vs in self.valid_sets:
            vs["score"][class_id] += value

    def _get_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, N] gradients and hessians of the current train scores."""
        if self.num_tree_per_iteration == 1:
            g, h = self.objective.get_gradients(self.train_score[0])
            return g[None, :], h[None, :]
        return self.objective.get_gradients(self.train_score)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration: one tree per class.  ``gradients`` and
        ``hessians`` ([K * N], class-major) replace the objective's, as a
        custom objective's (``Booster.update(fobj=...)``).  Returns True
        when training cannot continue (no splittable leaves)."""
        K = self.num_tree_per_iteration
        init_scores = [0.0] * K
        if gradients is None or hessians is None:
            for k in range(K):
                init_scores[k] = self._boost_from_average(k)
            grad, hess = self._get_gradients()
        else:
            grad, hess = (torch.as_tensor(
                np.asarray(a, dtype=np.float32).reshape(K, self.num_data),
                device=self.device) for a in (gradients, hessians))
        if not (bool(torch.isfinite(grad).all())
                and bool(torch.isfinite(hess).all())):
            raise LightGBMError("non-finite gradients/hessians at iteration "
                                "%d" % self.iter_)
        self._bagging(self.iter_)
        grad, hess = self._adjust_gradients_for_bagging(grad, hess)
        feature_mask = self._feature_mask()
        should_continue = False
        for k in range(K):
            new_tree = Tree(1)
            if self.class_need_train[k] and self.train_data.num_features > 0:
                gk, hk = grad[k], hess[k]
                if self.bag_mask is not None:
                    gk = gk * self.bag_mask
                    hk = hk * self.bag_mask
                arrays = self.learner.train(gk, hk, self.bag_data_cnt,
                                            feature_mask,
                                            iteration=self.iter_)
                if arrays.num_leaves > 1:
                    should_continue = True
                    new_tree = self._grow_scores(arrays, k, init_scores[k])
                else:
                    new_tree.leaf_value[0] = init_scores[k]
            elif len(self.models) < K:
                # only once: a class that trains no tree keeps a constant
                output = (self.objective.boost_from_score(k)
                          if (not self.class_need_train[k]
                              and self.objective is not None)
                          else init_scores[k])
                new_tree.leaf_value[0] = output
                if abs(output) > K_EPSILON:
                    self._add_constant_score(output, k)
            self.models.append(new_tree)
        self._predictor = None
        if not should_continue:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter_ += 1
        return False

    def _adjust_gradients_for_bagging(self, grad: torch.Tensor,
                                      hess: torch.Tensor):
        """[K, N] gradients after the iteration's bagging; GOSS folds its
        row weights in here (gbdt.py:1256)."""
        return grad, hess

    def _grow_scores(self, arrays: TreeArrays, k: int,
                     init_score: float) -> Tree:
        """Add a trained tree of class ``k`` to the train and validation
        scores and return its host tree (leaf values renewed for the
        percentile objectives, then scaled by the learning rate)."""
        rate = np.float32(self.shrinkage_rate)
        renewed = self._renew_tree_output(arrays, k)
        if renewed is None and self.lazy_trees:
            # leaf values scaled by the learning rate in f32, as the
            # reference's binary path does before its score update
            scaled = arrays._replace(
                leaf_value=arrays.leaf_value * rate,
                internal_value=arrays.internal_value * rate)
            tree = tree_from_arrays(scaled, self.train_data, 1.0)
            valid_lv = scaled.leaf_value
        else:
            # the JAX package's synchronous path (gbdt.py:1174-1254): the
            # host tree's (renewed) values shrink in f64, the train score
            # takes the f32 products and the validation scores the host
            # tree's values in f32
            tree = tree_from_arrays(arrays, self.train_data, 1.0)
            if renewed is not None:
                tree.leaf_value[:tree.num_leaves] = renewed
                arrays = arrays._replace(leaf_value=renewed.astype(np.float32))
            tree.shrink(self.shrinkage_rate)
            scaled = arrays._replace(leaf_value=arrays.leaf_value * rate)
            valid_lv = tree.leaf_value[:tree.num_leaves].astype(np.float32)
        lv = torch.as_tensor(scaled.leaf_value, device=self.device)
        self.train_score[k] += lv[arrays.row_leaf]
        vlv = torch.as_tensor(valid_lv, device=self.device)
        for vs in self.valid_sets:
            vs["score"][k] += vlv[route_binned(vs["bins"], scaled,
                                               self.learner.feat_host)]
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        self.last_arrays = scaled
        return tree

    def _renew_tree_output(self, arrays: TreeArrays,
                           class_id: int) -> Optional[np.ndarray]:
        """Per-leaf output renewal of the percentile objectives
        (serial_tree_learner.cpp:706-744 RenewTreeOutput; gbdt.py:1674-1703
        of the JAX package): each leaf's value becomes the objective's
        percentile of its in-bag rows' residuals (label - score), weighted
        by the MAPE label weights for mape.  Host numpy, so that the values
        equal the JAX package's; None for the other objectives."""
        obj = self.objective
        if obj is None or not obj.is_renew_tree_output:
            return None
        nl = int(arrays.num_leaves)
        row_leaf = arrays.row_leaf.cpu().numpy()
        residual = obj.label_np - self.train_score[class_id].cpu().numpy()
        weights = (obj.label_weight_np if obj.name == "mape"
                   else obj.weights_np)
        rows = np.arange(self.num_data)
        if self.bag_mask is not None:
            rows = rows[self.bag_mask.cpu().numpy() > 0]
        # each leaf's rows in their original order (a stable sort by leaf)
        rows = rows[np.argsort(row_leaf[rows], kind="stable")]
        ends = np.searchsorted(row_leaf[rows], np.arange(nl + 1))
        new_vals = np.asarray(arrays.leaf_value[:nl], np.float64).copy()
        for leaf in range(nl):
            r = rows[ends[leaf]:ends[leaf + 1]]
            if r.size:
                new_vals[leaf] = obj.renew_tree_output(
                    residual[r], None if weights is None else weights[r])
        return new_vals

    # ---- the training loop (gbdt.py:1843, without fused chunks) ----

    def train(self) -> None:
        """Train ``num_iterations`` iterations (counting from this booster's
        first), evaluating every ``metric_freq`` iterations and stopping
        early when ``eval_and_check_early_stopping`` says so."""
        t_start = time.perf_counter()
        total = int(self.config.num_iterations)
        has_eval = bool(self.train_metrics) or bool(self.valid_sets)
        mf = int(self.config.metric_freq)
        while self.iter_ < total:
            finished = self.train_one_iter()
            Log.info("%f seconds elapsed, finished iteration %d",
                     time.perf_counter() - t_start, self.iter_)
            if not finished and has_eval and mf > 0 and self.iter_ % mf == 0:
                finished = self.eval_and_check_early_stopping()
            if finished:
                break

    @property
    def num_trees(self) -> int:
        return len(self.models)

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    # ---- evaluation (gbdt.py:1952-1994) ----

    def _eval(self, name: str, score: torch.Tensor, metrics):
        """[(data name, metric name, value, bigger is better)] of one set."""
        host = score.cpu().numpy()
        return [(name, mname, val, m.factor_to_bigger_better > 0)
                for m in metrics
                for mname, val in zip(m.names, m.eval(host, self.objective))]

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval("training", self.train_score, self.train_metrics)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        return [r for vs in self.valid_sets
                for r in self._eval(vs["name"], vs["score"], vs["metrics"])]

    def eval_and_check_early_stopping(self) -> bool:
        """Log the metrics; True when a validation metric has not improved
        for ``early_stopping_round`` evaluations' worth of iterations (with
        ``first_metric_only``, only the first metric of each set counts,
        gbdt.cpp OutputMetric).  Records ``best_iteration`` when it stops."""
        for ds, name, val, _ in self.eval_train():
            Log.info("Iteration:%d, %s %s : %g", self.iter_, ds, name, val)
        rounds = int(self.config.early_stopping_round)
        first_only = bool(self.config.first_metric_only)
        stop = False
        for vs in self.valid_sets:
            first = None
            for ds, name, val, bigger_better in self._eval(
                    vs["name"], vs["score"], vs["metrics"]):
                Log.info("Iteration:%d, %s %s : %g", self.iter_, ds, name, val)
                first = name if first is None else first
                if rounds <= 0 or (first_only and name != first):
                    continue
                cur = val if bigger_better else -val
                best = self._es_state.get((ds, name))
                if best is None or cur > best[0]:
                    self._es_state[(ds, name)] = (cur, self.iter_)
                elif self.iter_ - best[1] >= rounds:
                    Log.info("Early stopping at iteration %d, the best "
                             "iteration round is %d", self.iter_, best[1])
                    self.best_iteration = best[1]
                    stop = True
        return stop

    # ---- prediction ----

    def _raw_predict(self, X, num_iteration: int = -1,
                     start_iteration: int = 0) -> torch.Tensor:
        """[K, n] f64 raw scores of the iterations [start_iteration,
        start_iteration + num_iteration) (all when ``num_iteration <= 0``)."""
        K = self.num_tree_per_iteration
        total = len(self.models) // K
        end = total if num_iteration <= 0 else min(
            total, start_iteration + num_iteration)
        key = (start_iteration, end, len(self.models))
        if self._predictor is None or self._predictor[0] != key:
            sel = self.models[start_iteration * K:end * K]
            self._predictor = (key, [StackedTrees(sel[k::K], self.device)
                                     for k in range(K)])
        X = torch.as_tensor(np.asarray(X, dtype=np.float64)
                            if not isinstance(X, torch.Tensor) else X)
        return torch.stack([p.raw_predict(X) for p in self._predictor[1]])

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                start_iteration: int = 0) -> np.ndarray:
        """[n, D] raw features -> [n] scores, or [n, K] for K classes
        (converted by the objective unless ``raw_score``), computed on the
        booster's device."""
        raw = self._raw_predict(X, num_iteration, start_iteration)
        raw = raw.cpu().numpy()
        if self.average_output:
            # the mean of the trees' outputs, over every iteration of the
            # model (gbdt.py:2119-2121)
            raw = raw / max(len(self.models) // self.num_tree_per_iteration,
                            1)
        if not raw_score and self.objective is not None:
            raw = np.asarray(self.objective.convert_output(raw))
        return raw[0] if self.num_tree_per_iteration == 1 else raw.T

    # ---- model serialization (gbdt_model_text.cpp:271,375) ----

    def sub_model_name(self) -> str:
        return "tree"

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Splits (or summed gains) per original feature over the first
        ``num_iteration`` iterations (c_api.cpp:1573 semantics)."""
        K = self.num_tree_per_iteration
        total = len(self.models) // K
        end = total if num_iteration <= 0 else min(total, num_iteration)
        out = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for t in self.models[:end * K]:
            if importance_type == "split":
                for f in t.splits_by_feature():
                    out[f] += 1
            else:
                feats, gains = t.gains_by_feature()
                for f, g in zip(feats, gains):
                    out[f] += g
        return out

    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1) -> str:
        lines = [self.sub_model_name(), "version=%s" % MODEL_VERSION,
                 "num_class=%d" % self.num_class,
                 "num_tree_per_iteration=%d" % self.num_tree_per_iteration,
                 "label_index=%d" % self.label_idx,
                 "max_feature_idx=%d" % self.max_feature_idx]
        if self.objective is not None:
            lines.append("objective=%s" % self.objective.to_string())
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self.feature_infos))
        K = self.num_tree_per_iteration
        total_iter = len(self.models) // K
        start_iteration = min(max(start_iteration, 0), total_iter)
        num_used = total_iter * K
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration) * K, num_used)
        start_model = start_iteration * K
        tree_strs = ["Tree=%d\n" % (i - start_model)
                     + self.models[i].to_string() + "\n"
                     for i in range(start_model, num_used)]
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs) + "end of trees\n"
        imps = self.feature_importance("split", num_iteration)
        pairs = sorted([(int(v), self.feature_names[i])
                        for i, v in enumerate(imps) if v > 0],
                       key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        body += "".join("%s=%d\n" % (nm, v) for v, nm in pairs)
        body += "\nparameters:\n"
        for k, v in sorted(self.config.raw_params.items()):
            body += "[%s: %s]\n" % (k, v)
        body += "end of parameters\n"
        return body

    def save_model(self, filename: str, start_iteration: int = 0,
                   num_iteration: int = -1) -> None:
        atomic_write(filename,
                     self.save_model_to_string(start_iteration, num_iteration))
        Log.info("Finished writing model to file %s", filename)

    def load_model_from_string(self, text: str) -> None:
        """Parse the text model format; malformed or truncated input raises a
        ``LightGBMError`` naming the failing section."""
        if not text or not text.strip():
            raise LightGBMError("Model file is empty")
        split_at = text.find("\nTree=")
        header = text[:split_at] if split_at >= 0 else text
        rest = text[split_at + 1:] if split_at >= 0 else ""
        kv: Dict[str, str] = {}
        for line in header.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        if split_at >= 0 and "end of trees" not in rest:
            raise LightGBMError("Model format error: missing 'end of trees' "
                                "sentinel — the tree section is truncated")
        try:
            self.num_class = int(kv.get("num_class", 1))
            self.num_tree_per_iteration = int(
                kv.get("num_tree_per_iteration", 1))
            self.label_idx = int(kv.get("label_index", 0))
            self.max_feature_idx = int(kv.get("max_feature_idx", 0))
        except ValueError as exc:
            raise LightGBMError("Model format error: unparseable header "
                                "field (%s)" % exc)
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        self.average_output = "average_output" in header.splitlines()
        if "objective" in kv and self.objective is None:
            if self.num_class > 1:
                self.config.num_class = self.num_class
            self.objective = create_objective(kv["objective"].split()[0],
                                              self.config, self.device)
        models = []
        if rest:
            for block in rest.split("end of trees")[0].split("Tree="):
                block = block.strip()
                if not block:
                    continue
                block = block.split("\n", 1)[1] if "\n" in block else ""
                if block.strip():
                    try:
                        models.append(Tree.from_string(block))
                    except (LightGBMError, ValueError, IndexError,
                            KeyError) as exc:
                        raise LightGBMError(
                            "Model format error: Tree=%d is malformed (%s)"
                            % (len(models), exc))
        declared = kv.get("tree_sizes", "").split()
        if declared and len(declared) != len(models):
            raise LightGBMError(
                "Model format error: tree_sizes declares %d trees but %d "
                "were parsed — the tree section is truncated"
                % (len(declared), len(models)))
        K = max(self.num_tree_per_iteration, 1)
        if len(models) % K != 0:
            raise LightGBMError(
                "Model format error: %d trees is not a multiple of "
                "num_tree_per_iteration=%d — the tree section is truncated"
                % (len(models), K))
        self.models = models
        self._predictor = None
        self.num_init_iteration = len(models) // K
        self.iter_ = 0
