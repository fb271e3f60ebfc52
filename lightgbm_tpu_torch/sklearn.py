"""Scikit-learn estimator API (python-package/lightgbm/sklearn.py).

``lightgbm_tpu/sklearn.py`` for the PyTorch port (which imports nothing of
the JAX package): ``LGBMModel`` (sklearn.py:169) plus
``LGBMRegressor/LGBMClassifier/LGBMRanker`` (:744,771,913) and the
objective/eval wrappers translating sklearn signatures into grad/hess and
(name, value, is_higher_better) tuples (:18,97).  The port adds the
constructor argument ``device``: ``None`` (the default) trains on ``cuda``
and raises without it, ``"cpu"`` on the CPU.  sklearn itself is optional:
without it the estimators stand on ``compat.py``'s minimal base classes.
An estimator built without an objective trains its own default (binary,
regression or lambdarank), where the JAX package's trains regression
(ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .compat import (_LGBMCheckClassificationTargets, _LGBMClassifierBase,
                     _LGBMModelBase, _LGBMRegressorBase, LGBMLabelEncoder)
from .engine import train

__all__ = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]


class _ObjectiveFunctionWrapper:
    """Wrap sklearn-style fobj(y_true, y_pred[, weight[, group]]) -> grad, hess
    (sklearn.py:18-95)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_weight())
        elif argc == 4:
            grad, hess = self.func(labels, preds, dataset.get_weight(),
                                   dataset.get_group())
        else:
            raise TypeError("Self-defined objective function should have 2, 3 "
                            "or 4 arguments, got %d" % argc)
        return grad, hess


class _EvalFunctionWrapper:
    """Wrap sklearn-style feval(y_true, y_pred[, weight[, group]]) ->
    (name, value, is_higher_better) (sklearn.py:97-167)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError("Self-defined eval function should have 2, 3 or 4 "
                        "arguments, got %d" % argc)


class LGBMModel(_LGBMModelBase):
    """Base sklearn estimator (sklearn.py:169)."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100, subsample_for_bin=200000,
                 objective=None, class_weight=None, min_split_gain=0.0,
                 min_child_weight=1e-3, min_child_samples=20, subsample=1.0,
                 subsample_freq=0, colsample_bytree=1.0, reg_alpha=0.0,
                 reg_lambda=0.0, random_state=None, n_jobs=-1, silent=True,
                 importance_type="split", device=None, **kwargs):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.class_weight = class_weight
        self.device = device
        self._Booster: Optional[Booster] = None
        self._evals_result = None
        self._best_score = None
        self._best_iteration = None
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self._objective = objective
        self._other_params: Dict[str, Any] = dict(kwargs)
        self.set_params(**kwargs)

    def get_params(self, deep=True):
        params = super().get_params(deep=deep) if hasattr(
            super(), "get_params") else {}
        if not params:
            import inspect
            sig = inspect.signature(LGBMModel.__init__)
            params = {k: getattr(self, k) for k in sig.parameters
                      if k not in ("self", "kwargs") and hasattr(self, k)}
        params.update(self._other_params)
        return params

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, "_other_params") and key not in self.get_params():
                self._other_params[key] = value
        return self

    def _process_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        # the port's device, never LightGBM's device_type key
        params.pop("device", None)
        # set below from _objective: a None left here would beat fit's
        # default objective (the JAX package trains objective=regression
        # for every estimator built without one)
        params.pop("objective", None)
        if isinstance(params.get("random_state"), np.random.RandomState):
            params["random_state"] = params["random_state"].randint(2 ** 31 - 1)
        for alias, real in (("subsample_for_bin", "bin_construct_sample_cnt"),
                            ("min_split_gain", "min_gain_to_split"),
                            ("min_child_weight", "min_sum_hessian_in_leaf"),
                            ("min_child_samples", "min_data_in_leaf"),
                            ("subsample", "bagging_fraction"),
                            ("subsample_freq", "bagging_freq"),
                            ("colsample_bytree", "feature_fraction"),
                            ("reg_alpha", "lambda_l1"),
                            ("reg_lambda", "lambda_l2"),
                            ("random_state", "seed"),
                            ("boosting_type", "boosting")):
            if alias in params:
                v = params.pop(alias)
                if v is not None:
                    params[real] = v
        params.pop("n_jobs", None)
        if callable(self._objective):
            self._fobj = _ObjectiveFunctionWrapper(self._objective)
            params["objective"] = "none"
        else:
            self._fobj = None
            if self._objective is not None:
                params["objective"] = self._objective
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto", callbacks=None):
        params = self._process_params()
        if self._objective is None:
            params.setdefault("objective", self._default_objective())
        self._objective = params.get("objective", self._objective)
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        feval = (_EvalFunctionWrapper(eval_metric) if callable(eval_metric)
                 else None)

        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_sample_weight(y)

        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            free_raw_data=False)
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                    continue
                vw = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                vg = eval_group[i] if eval_group is not None else None
                vi = (eval_init_score[i]
                      if eval_init_score is not None else None)
                valid_sets.append(Dataset(vx, label=vy, weight=vw, group=vg,
                                          init_score=vi, reference=train_set,
                                          params=params, free_raw_data=False))
        evals_result: Dict = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=eval_names,
            fobj=self._fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks, device=self.device)
        self._n_features = train_set.num_feature()
        self._evals_result = evals_result or None
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _class_sample_weight(self, y):
        y = np.asarray(y)
        classes, counts = np.unique(y, return_counts=True)
        if self.class_weight == "balanced":
            weights = {c: len(y) / (len(classes) * cnt)
                       for c, cnt in zip(classes, counts)}
        else:
            weights = dict(self.class_weight)
        return np.asarray([weights.get(v, 1.0) for v in y], dtype=np.float64)

    def predict(self, X, raw_score=False, start_iteration=0, num_iteration=None,
                pred_leaf=False, pred_contrib=False, precision="exact",
                **kwargs):
        """Predict scores (or, with ``pred_contrib=True``, per-feature
        SHAP contributions [N, F+1] per class through the device
        path-decomposition kernel — round 19).  ``precision="bf16"``
        selects the budget-gated lossy serving tier (leaf routing stays
        bit-exact; only the weighted leaf sum is bf16)."""
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before predict")
        return self._Booster.predict(X, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib,
                                     precision=precision)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit beforehand.")
        return self._Booster

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def objective_(self):
        return self._objective

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit beforehand.")
        return self._Booster.feature_importance(self.importance_type)


class LGBMRegressor(LGBMModel, _LGBMRegressorBase):
    """LightGBM regressor (sklearn.py:744)."""

    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(LGBMModel, _LGBMClassifierBase):
    """LightGBM classifier (sklearn.py:771)."""

    def _default_objective(self) -> str:
        return "binary"

    def fit(self, X, y, **kwargs):
        _LGBMCheckClassificationTargets(y)
        self._le = LGBMLabelEncoder().fit(y)
        encoded = self._le.transform(y)
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if self.objective in (None, "binary"):
                self._objective = "multiclass"
                self.objective = "multiclass"
            self._other_params["num_class"] = self._n_classes
        ev = kwargs.get("eval_set")
        if ev is not None:
            if isinstance(ev, tuple):
                ev = [ev]
            kwargs["eval_set"] = [(vx, self._le.transform(vy))
                                  for vx, vy in ev]
        return super().fit(X, encoded, **kwargs)

    def predict(self, X, raw_score=False, start_iteration=0, num_iteration=None,
                pred_leaf=False, pred_contrib=False, precision="exact",
                **kwargs):
        result = self.predict_proba(X, raw_score, start_iteration,
                                    num_iteration, pred_leaf, pred_contrib,
                                    precision=precision, **kwargs)
        if callable(self._objective) or raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            idx = (result > 0.5).astype(int)
        else:
            idx = np.argmax(result, axis=1)
        return self._le.inverse_transform(idx)

    def predict_proba(self, X, raw_score=False, start_iteration=0,
                      num_iteration=None, pred_leaf=False, pred_contrib=False,
                      precision="exact", **kwargs):
        result = super().predict(X, raw_score, start_iteration, num_iteration,
                                 pred_leaf, pred_contrib, precision=precision,
                                 **kwargs)
        if callable(self._objective) or raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes and self._n_classes > 2:
            return result
        return np.vstack((1.0 - result, result)).transpose()

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    """LightGBM ranker (sklearn.py:913)."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, eval_set=None, eval_group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not "
                             "None")
        return super().fit(X, y, group=group, eval_set=eval_set,
                           eval_group=eval_group, **kwargs)
