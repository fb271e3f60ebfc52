"""The training entry point ``train``: the counterpart of
``lightgbm_tpu/engine.py`` ``train`` (python-package/lightgbm/engine.py
:18-270), for the PyTorch port (which imports nothing of the JAX package).

Parameter aliases for the round count and early stopping, callback ordering
(before/after an iteration), early stopping through ``EarlyStopException``,
``evals_result`` recording and continued training from ``init_model`` follow
the JAX package.  ``params["boosting"]`` picks GBDT, DART, GOSS or random
forest (``boosting.create_boosting``, through ``Booster``).  The port adds
``device=``: ``cuda`` unless the caller passes ``"cpu"``.  Not carried over
yet, and refused with ``NotImplementedError``: ``cv``, ``serve``,
``serve_and_train``, checkpoints and preemption (ROADMAP queue 1 items 11
and 15).
"""
from __future__ import annotations

import collections
import copy
import os
from typing import Any, Dict, List, Optional

from . import callback
from .basic import Booster, Dataset, _refuse
from .device import DeviceLike

__all__ = ["train", "cv", "serve", "serve_and_train"]

_NUM_BOOST_ROUND_ALIASES = ("num_boost_round", "num_iterations",
                            "num_iteration", "n_iter", "num_tree", "num_trees",
                            "num_round", "num_rounds", "n_estimators")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping", "n_iter_no_change")


def _model_text(init_model) -> str:
    """A model string from ``init_model``: a Booster, a model file or the
    model text itself."""
    if isinstance(init_model, Booster):
        return init_model.model_to_string()
    if not isinstance(init_model, str):
        raise TypeError("init_model should be a model string, a path or a "
                        "Booster")
    if os.path.exists(init_model):
        with open(init_model) as fh:
            return fh.read()
    return init_model


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None, verbose_eval=True,
          learning_rates=None, keep_training_booster: bool = False,
          callbacks=None, checkpoint_prefix: Optional[str] = None,
          preemption_checkpoint: bool = False,
          device: DeviceLike = None) -> Booster:
    """Train with ``params`` on ``train_set``; returns the trained Booster.

    ``valid_sets`` are scored every iteration on the device (their metrics
    come from ``params["metric"]``, the objective's own by default);
    ``early_stopping_rounds`` stops when no validation metric improved for
    that many iterations and sets ``best_iteration``.  ``fobj(raw_scores,
    train_set) -> (grad, hess)`` is a custom objective."""
    if checkpoint_prefix is not None or preemption_checkpoint:
        _refuse("checkpoints and preemption", "queue 1 item 11")
    params = copy.deepcopy(params) if params else {}
    for alias in _NUM_BOOST_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _EARLY_STOP_ALIASES:
        if alias in params:
            early_stopping_rounds = int(params.pop(alias))
    first_metric_only = bool(params.pop("first_metric_only", False))
    if fobj is not None:
        params["objective"] = "none"
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    params["num_iterations"] = num_boost_round

    booster = Booster(params=params, train_set=train_set, device=device)
    gbdt = booster._booster
    if init_model is not None:
        gbdt.load_model_from_string(_model_text(init_model))
        gbdt.reset_training_data(train_set.handle, gbdt.objective)
        gbdt.replay_train_score()
    init_iteration = gbdt.num_init_iteration

    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    valid_names = valid_names or []
    train_data_name = "training"
    for i, vs in enumerate(valid_sets or []):
        if vs is train_set:
            if i < len(valid_names):
                train_data_name = valid_names[i]
            continue
        if vs.reference is None:
            vs.set_reference(train_set)
        booster.add_valid(vs, valid_names[i] if i < len(valid_names)
                          else "valid_%d" % i)
    contains_train = any(vs is train_set for vs in (valid_sets or []))

    callbacks = set() if callbacks is None else set(callbacks)
    if verbose_eval is True:
        callbacks.add(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        callbacks.add(callback.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(callback.early_stopping(
            early_stopping_rounds, first_metric_only,
            verbose=bool(verbose_eval)))
    if learning_rates is not None:
        callbacks.add(callback.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        callbacks.add(callback.record_evaluation(evals_result))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    end = init_iteration + num_boost_round
    results = []
    for i in range(init_iteration, end):
        for cb in before:
            cb(callback.CallbackEnv(model=booster, params=params, iteration=i,
                                    begin_iteration=init_iteration,
                                    end_iteration=end,
                                    evaluation_result_list=None))
        finished = booster.update(fobj=fobj)
        results = []
        if valid_sets is not None or gbdt.train_metrics:
            if contains_train:
                results += [(train_data_name, m, v, h)
                            for (_, m, v, h) in booster.eval_train(feval)]
            results += booster.eval_valid(feval)
        try:
            for cb in after:
                cb(callback.CallbackEnv(model=booster, params=params,
                                        iteration=i,
                                        begin_iteration=init_iteration,
                                        end_iteration=end,
                                        evaluation_result_list=results))
        except callback.EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            results = stop.best_score
            break
        if finished:
            break
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for data_name, eval_name, value, _ in results or []:
        booster.best_score[data_name][eval_name] = value
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


def cv(*args, **kwargs):
    """Cross-validation: not ported yet."""
    _refuse("cv", "queue 1 item 15")


def serve(*args, **kwargs):
    """The serving tier: not ported yet."""
    _refuse("serve", "queue 1 item 15")


def serve_and_train(*args, **kwargs):
    """The online train-and-serve loop: not ported yet."""
    _refuse("serve_and_train", "queue 1 item 15")
