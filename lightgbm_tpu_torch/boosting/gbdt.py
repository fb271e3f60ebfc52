"""GBDT training loop (the main path of the port).

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` (the reference ``GBDT``,
src/boosting/gbdt.cpp, gbdt.h), as much as the binary main path needs:
``__init__``, ``_boost_from_average``, ``train_one_iter`` (synchronous: one
host tree per iteration), ``train_score``, validation sets
(``add_valid_data``, ``_add_tree_score_valid``), metrics and early stopping
(``eval_train``, ``eval_valid``, ``eval_and_check_early_stopping``), the host
loop ``train``, the replay of a loaded model (``replay_train_score``),
``predict``, ``feature_importance`` and the reference-compatible text model
(``save_model_to_string`` / ``load_model_from_string``,
gbdt_model_text.cpp:271,375).

Scores live on the device: ``train_score`` [1, N] f32 and one [1, N_v] f32
score per validation set.  Each iteration: boost-from-average (first
iteration, added to every score), objective gradients on the device, one
tree from :class:`SerialTreeLearner`, the tree's leaf values scaled by the
learning rate in f32, the train score updated through the tree's
``row_leaf`` and each validation score by routing the set's bins on the
device (``route_binned``).  The fused multi-iteration scan, snapshots,
bagging, feature sampling, checkpoints, DART/GOSS/RF and multiclass are not
ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.predict import StackedTrees
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


class GBDT:
    """Gradient Boosting Decision Tree (sub-model name "tree", gbdt.h:362).

    ``device`` follows the port's device rule (``lightgbm_tpu_torch.device``):
    ``cuda`` unless the caller passes ``"cpu"``; no silent CPU fallback."""

    average_output = False

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
        if objective is not None and objective.num_model_per_iteration != 1:
            raise NotImplementedError("multiclass boosting is not ported to "
                                      "lightgbm_tpu_torch yet (ROADMAP queue "
                                      "1 item 9)")
        if objective is not None and objective.device != self.device:
            raise ValueError("objective is on %s, booster on %s"
                             % (objective.device, self.device))
        cfg = self.config
        if cfg.bagging_freq > 0 and (float(cfg.bagging_fraction) < 1.0
                                     or float(cfg.pos_bagging_fraction) < 1.0
                                     or float(cfg.neg_bagging_fraction) < 1.0):
            raise NotImplementedError("bagging is not ported to "
                                      "lightgbm_tpu_torch yet (ROADMAP queue "
                                      "1 item 5)")
        if float(cfg.feature_fraction) < 1.0:
            raise NotImplementedError("feature_fraction is not ported to "
                                      "lightgbm_tpu_torch yet (ROADMAP queue "
                                      "1 item 5)")
        self.train_data = train_data
        self.objective = objective
        self.num_data = train_data.num_data
        self.learner = SerialTreeLearner(train_data, cfg, self.device)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        self.train_score = torch.zeros((1, self.num_data), dtype=torch.float32,
                                       device=self.device)
        self._has_init_score = train_data.metadata.init_score is not None
        if self._has_init_score:
            init = np.asarray(train_data.metadata.init_score, dtype=np.float32)
            self.train_score[0] = torch.as_tensor(init.reshape(self.num_data),
                                                  device=self.device)
        self.class_need_train = True
        if self.objective is not None:
            self.objective.init(train_data.metadata, self.num_data)
            self.class_need_train = self.objective.class_need_train(0)
        self.train_metrics = []
        self._es_state = {}

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
        score = torch.zeros((1, valid_data.num_data), dtype=torch.float32,
                            device=self.device)
        if valid_data.metadata.init_score is not None:
            init = np.asarray(valid_data.metadata.init_score, np.float32)
            score[0] = torch.as_tensor(init.reshape(valid_data.num_data),
                                       device=self.device)
        vs = {"name": name, "data": valid_data,
              "bins": self.learner.valid_bins(valid_data),
              "metrics": list(metrics), "score": score}
        for tree in self.models:
            self._add_tree_score_valid(tree, vs)
        self.valid_sets.append(vs)

    def _add_tree_score_valid(self, tree: Tree, vs: dict) -> None:
        """score += the tree's leaf values (f32) over the set's binned rows."""
        self._add_tree_score(tree, vs["bins"], vs["score"])

    def _add_tree_score(self, tree: Tree, bins: torch.Tensor,
                        score: torch.Tensor) -> None:
        if tree.num_leaves <= 1:
            score[0] += np.float32(tree.leaf_value[0])
            return
        arrays = arrays_from_tree(tree, self.train_data)
        lv = torch.as_tensor(arrays.leaf_value, device=self.device)
        score[0] += lv[route_binned(bins, arrays, self.learner.feat_host)]

    def replay_train_score(self) -> None:
        """train_score += every tree of a loaded model, in f32, one tree at a
        time (the loaded-model replay of ``engine.train(init_model=...)``)."""
        if not self.models or self.train_data is None:
            return
        bins = self.learner.valid_bins(self.train_data)
        for tree in self.models:
            self._add_tree_score(tree, bins, self.train_score)

    # ---- boosting (gbdt.cpp:143-158, 322-368) ----

    def _boost_from_average(self, class_id: int) -> float:
        if (not self.models and not self._has_init_score
                and self.objective is not None):
            if self.config.boost_from_average \
                    or self.train_data.num_features == 0:
                init_score = self.objective.boost_from_score(class_id)
                if abs(init_score) > K_EPSILON:
                    self.train_score[class_id] += init_score
                    for vs in self.valid_sets:
                        vs["score"][class_id] += init_score
                    Log.info("Start training from score %f", init_score)
                    return init_score
        return 0.0

    def train_one_iter(self) -> bool:
        """One boosting iteration; returns True when training cannot
        continue (no splittable leaves)."""
        init_score = self._boost_from_average(0)
        grad, hess = self.objective.get_gradients(self.train_score[0])
        if not (bool(torch.isfinite(grad).all())
                and bool(torch.isfinite(hess).all())):
            raise LightGBMError("non-finite gradients/hessians at iteration "
                                "%d" % self.iter_)
        new_tree = Tree(1)
        trained = False
        if self.class_need_train and self.train_data.num_features > 0:
            arrays = self.learner.train(grad, hess, self.num_data,
                                        iteration=self.iter_)
            if arrays.num_leaves > 1:
                trained = True
                # leaf values scaled by the learning rate in f32, as the
                # reference's binary path does before its score update
                rate = np.float32(self.shrinkage_rate)
                scaled = arrays._replace(
                    leaf_value=arrays.leaf_value * rate,
                    internal_value=arrays.internal_value * rate)
                lv = torch.as_tensor(scaled.leaf_value, device=self.device)
                self.train_score[0] += lv[arrays.row_leaf]
                for vs in self.valid_sets:
                    vs["score"][0] += lv[route_binned(
                        vs["bins"], scaled, self.learner.feat_host)]
                new_tree = tree_from_arrays(scaled, self.train_data, 1.0)
                if abs(init_score) > K_EPSILON:
                    new_tree.add_bias(init_score)
                self.last_arrays = scaled
        if not trained:
            if not self.models:
                output = (self.objective.boost_from_score(0)
                          if (not self.class_need_train
                              and self.objective is not None)
                          else init_score)
                new_tree.leaf_value[0] = output
                self.models.append(new_tree)
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            self._predictor = None
            return True
        self.models.append(new_tree)
        self._predictor = None
        self.iter_ += 1
        return False

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
        total = len(self.models)
        end = total if num_iteration <= 0 else min(
            total, start_iteration + num_iteration)
        key = (start_iteration, end, total)
        if self._predictor is None or self._predictor[0] != key:
            self._predictor = (key, StackedTrees(
                self.models[start_iteration:end], self.device))
        X = torch.as_tensor(np.asarray(X, dtype=np.float64)
                            if not isinstance(X, torch.Tensor) else X)
        return self._predictor[1].raw_predict(X)

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                start_iteration: int = 0) -> np.ndarray:
        """[n, D] raw features -> [n] scores (probabilities unless
        ``raw_score``), computed on the booster's device."""
        raw = self._raw_predict(X, num_iteration, start_iteration)
        raw = raw.cpu().numpy()
        if not raw_score and self.objective is not None:
            raw = np.asarray(self.objective.convert_output(raw))
        return raw

    # ---- model serialization (gbdt_model_text.cpp:271,375) ----

    def sub_model_name(self) -> str:
        return "tree"

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Splits (or summed gains) per original feature over the first
        ``num_iteration`` iterations (c_api.cpp:1573 semantics)."""
        end = len(self.models) if num_iteration <= 0 else min(
            len(self.models), num_iteration)
        out = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for t in self.models[:end]:
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
        total_iter = len(self.models)
        start_iteration = min(max(start_iteration, 0), total_iter)
        num_used = total_iter
        if num_iteration > 0:
            num_used = min(start_iteration + num_iteration, num_used)
        tree_strs = ["Tree=%d\n" % (i - start_iteration)
                     + self.models[i].to_string() + "\n"
                     for i in range(start_iteration, num_used)]
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
        if self.num_tree_per_iteration != 1:
            raise NotImplementedError("multiclass models are not ported to "
                                      "lightgbm_tpu_torch yet (ROADMAP queue "
                                      "1 item 9)")
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        self.average_output = "average_output" in header.splitlines()
        if "objective" in kv and self.objective is None:
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
        self.models = models
        self._predictor = None
        self.num_init_iteration = len(models)
        self.iter_ = 0
