"""The training entry point ``train``: the counterpart of
``lightgbm_tpu/engine.py`` ``train`` (python-package/lightgbm/engine.py
:18-270), for the PyTorch port (which imports nothing of the JAX package).

Parameter aliases for the round count and early stopping, callback ordering
(before/after an iteration), early stopping through ``EarlyStopException``,
``evals_result`` recording and continued training from ``init_model`` follow
the JAX package.  ``params["boosting"]`` picks GBDT, DART, GOSS or random
forest (``boosting.create_boosting``, through ``Booster``).
``checkpoint_prefix`` writes the train state every ``snapshot_freq``
iterations and resumes an interrupted call from it (engine.py:147-151,
:218-292 of the JAX package).  The port adds ``device=``: ``cuda`` unless
the caller passes ``"cpu"``.  ``preemption_checkpoint`` routes SIGTERM and
SIGINT to the preemption flag, polled at every iteration end: the call then
writes an emergency checkpoint to ``checkpoint_prefix`` and raises
``resilience.TrainingPreempted``, and the same call again resumes from it;
``watchdog_timeout_s`` in the params arms the dispatch watchdog for the
call (engine.py:205-320 of the JAX package, ``resilience.py``).  ``cv``
(engine.py:472-656) builds one booster per fold through ``Dataset.subset``,
with group-aware, stratified or shuffled folds, and aggregates the folds'
metrics as mean and standard deviation.

Telemetry (``obs``, engine.py:175-325 of the JAX package): ``telemetry_out``
and/or ``metrics_port`` in the params make ``train`` record its own run
(an ``iteration`` span each iteration, its rate in ``chunk_rows_per_s``
every ``telemetry_freq`` iterations, the run gauges) and finalize it into
``<telemetry_out>.summary.json``, closing it; a run the caller
configured (``obs.configure``) is recorded into and left open.
:func:`serve` (engine.py:355-400) starts the serving tier over one
or many models on ``device``; a run it opens for ``telemetry_out`` is
finalized by ``Server.close``.  :func:`serve_and_train` (engine.py:405-463)
starts the train-while-serve loop (``online``).  Every entry point engages
the kernel planner's tuned-plan cache first (``plan_cache``, or the
default path; ``plan/state.py``), before a tree learner resolves its plan.
"""
from __future__ import annotations

import collections
import copy
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback, obs, resilience
from .basic import Booster, Dataset
from .checkpoint import cleanup_checkpoints, save_checkpoint_best_effort
from .device import DeviceLike
from .utils.log import Log

__all__ = ["train", "cv", "serve", "serve_and_train", "CVBooster"]

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
    train_set) -> (grad, hess)`` is a custom objective.

    ``checkpoint_prefix``: the full train state (checkpoint.py) is written
    atomically to ``<prefix>.ckpt_iter_<n>`` every ``snapshot_freq``
    iterations (``snapshot_keep`` bounds the files kept), and a call with
    the same prefix after an interruption resumes from the newest valid
    one.  A call that completes removes its checkpoints.  The
    ``early_stopping_rounds`` callback keeps its counters where no
    checkpoint reaches them, so they restart on a resume (the JAX
    package's known limit, engine.py:53-57).

    ``preemption_checkpoint`` (or the parameter of that name): SIGTERM and
    SIGINT set a flag that the loop polls at every iteration end; a set
    flag writes an emergency checkpoint to ``checkpoint_prefix`` and
    raises :class:`resilience.TrainingPreempted`.  ``watchdog_timeout_s``
    in the params aborts the process (exit 79) when an iteration makes no
    progress for that long."""
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

    _engage_plan_cache(params)
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
    resumed_iter = 0
    ckpt_freq = int(booster.config.snapshot_freq)
    # every rank of a parallel learner runs this loop; rank 0 alone writes
    # and removes the checkpoints (engine.py:184, :222)
    from .parallel.learners import is_write_leader
    write_ckpt = is_write_leader(gbdt.group)
    if checkpoint_prefix is not None:
        # after the validation sets: their scores are restored by position
        resumed_iter = gbdt.resume_from_checkpoint(checkpoint_prefix)
        if ckpt_freq <= 0:
            Log.warning("checkpoint_prefix is set but snapshot_freq is not "
                        "(<= 0): no checkpoints will be written; pass "
                        "snapshot_freq in params to choose the cadence")

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

    preempt = bool(preemption_checkpoint) or bool(
        booster.config.preemption_checkpoint)
    if preempt and checkpoint_prefix is None:
        Log.warning("preemption_checkpoint is set without a "
                    "checkpoint_prefix: a preempted run stops cleanly but "
                    "has nothing to resume from")
    # telemetry: a run the params ask for is owned (finalized and closed
    # here); a run the caller configured is recorded into and left open
    tele = obs.configure_from_config(booster.config, "engine.train")
    own_tele = tele is not None
    if not own_tele:
        tele = obs.active()
    t_start = time.perf_counter()
    owned_signals, owned_wd = resilience.arm_supervision(
        preempt, float(booster.config.watchdog_timeout_s),
        artifact_base=str(booster.config.telemetry_out or "")
        or checkpoint_prefix)
    end = init_iteration + num_boost_round
    results = []
    try:
        for i in range(init_iteration + resumed_iter, end):
            for cb in before:
                cb(callback.CallbackEnv(model=booster, params=params,
                                        iteration=i,
                                        begin_iteration=init_iteration,
                                        end_iteration=end,
                                        evaluation_result_list=None))
            it_t0 = time.perf_counter() if tele is not None else 0.0
            finished = booster.update(fobj=fobj)
            if tele is not None and (i + 1 - init_iteration) % tele.freq == 0:
                # the iteration's own timing is its ``iteration`` span
                dt_it = time.perf_counter() - it_t0
                tele.histogram("chunk_rows_per_s").observe(
                    int(gbdt.num_data) / dt_it if dt_it > 0 else 0.0)
            results = []
            if valid_sets is not None or gbdt.train_metrics:
                if contains_train:
                    results += [(train_data_name, m, v, h) for (_, m, v, h)
                                in booster.eval_train(feval)]
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
            if (checkpoint_prefix is not None and ckpt_freq > 0
                    and write_ckpt and gbdt.iter_ % ckpt_freq == 0):
                save_checkpoint_best_effort(gbdt, checkpoint_prefix)
            if preempt and resilience.preemption_requested():
                # the one preempt-exit sequence of every entry point: drain
                # the device, emergency checkpoint, consume the flag, raise
                gbdt._preempt_exit(checkpoint_prefix)
            if finished:
                break
        # the isfinite verdicts (nan_policy=raise) of the iterations since
        # the last stall poll: a bad batch near the end still raises
        # (engine.py:282-285)
        gbdt._drain_nonfinite_checks()
        if checkpoint_prefix is not None and write_ckpt:
            # the call completed: a rerun with the same prefix trains afresh
            cleanup_checkpoints(checkpoint_prefix)
        booster.best_score = collections.defaultdict(
            collections.OrderedDict)
        for data_name, eval_name, value, _ in results or []:
            booster.best_score[data_name][eval_name] = value
        if booster.best_iteration <= 0:
            booster.best_iteration = booster.current_iteration()
        if tele is not None:
            wall = time.perf_counter() - t_start
            # the iterations this call trained (a resume restored
            # resumed_iter of them before the loop)
            iters_run = int(gbdt.iter_) - int(resumed_iter)
            tele.gauge("train_rows").set(int(gbdt.num_data))
            tele.gauge("train_iterations").set(iters_run)
            tele.gauge("train_wall_s").set(wall)
            if own_tele:
                from .obs.report import finalize_run
                finalize_run(tele, gbdt=gbdt, wall_s=wall, iters=iters_run)
                obs.disable()
        return booster
    finally:
        resilience.disarm_supervision(owned_signals, owned_wd)
        # an exception (nan_policy=raise, a callback's error) must not
        # leave the owned run process-active
        if own_tele and obs.active() is tele:
            obs.disable()


def _engage_plan_cache(params: Dict[str, Any]) -> None:
    """Engage the tuned-plan cache of ``params`` (``plan_cache``, else the
    default path) before a learner resolves its plan (engine.py:95-104 of
    the JAX package); no cache means the analytic plans."""
    from .config import alias_transform
    from .plan import state as _plan_state
    _plan_state.configure(
        str(alias_transform(dict(params)).get("plan_cache", "") or "")
        or None)


def serve(models, params: Optional[Dict[str, Any]] = None,
          device: DeviceLike = None, **server_kwargs):
    """Start the serving tier (``serving``) over one or many models on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    ``models`` is a Booster, a GBDT or a model-file path, or a dict of
    ``name -> one of those`` for multi-model residency (a single model is
    served as ``"model"``).  ``params`` feeds the serving knobs
    (``max_batch_wait_us``, ``serve_residency_budget_mb``,
    ``serve_single_row_fast``) and ``telemetry_out``/``metrics_port``,
    which open a run the server owns when none is active (finalized into
    ``<telemetry_out>.summary.json`` by ``server.close()``).  Extra keyword
    arguments go to :class:`~lightgbm_tpu_torch.serving.Server` (e.g.
    ``max_queue_depth``).  Returns the running server: ``submit``/
    ``predict``, ``register``, ``swap``, ``close`` (also a context
    manager)."""
    from .boosting.gbdt import GBDT
    from .config import Config, alias_transform
    from .serving import Server

    cfg = Config(alias_transform(dict(params or {})))
    own_tele = (obs.configure_from_config(cfg, "engine.serve")
                if obs.active() is None else None)
    from .plan import state as _plan_state
    _plan_state.configure_from_config(cfg)
    server = None
    try:
        server = Server(config=cfg, owned_telemetry=own_tele, device=device,
                        **server_kwargs)
        if not isinstance(models, dict):
            models = {"model": models}
        for name, model in models.items():
            if isinstance(model, str):
                model = GBDT.load_model(model, cfg, device=server.device)
            server.register(name, model)
    except BaseException:
        # a failed construction, load or register must not leak the
        # dispatcher thread or keep the owned run process-active
        if server is not None:
            server.disown_telemetry()
            server.close(drain=False)
        if own_tele is not None and obs.active() is own_tele:
            obs.disable()
        raise
    return server


def serve_and_train(booster, train_set=None,
                    params: Optional[Dict[str, Any]] = None,
                    name: str = "model",
                    checkpoint_prefix: Optional[str] = None,
                    publish_out: Optional[str] = None,
                    warm=True, device: DeviceLike = None, **server_kwargs):
    """Start the train-while-serve loop (``online``, engine.py:405-463 of
    the JAX package): one process that serves ``booster`` through the
    serving tier while a trainer thread ingests fresh labeled rows
    (``controller.ingest(X, y)``) and republishes each continued
    generation through ``ModelRegistry.swap``.

    ``booster`` is a Booster, a GBDT or a model-file path; ``train_set``
    the base ``BinnedDataset`` (or a ``Dataset``) whose bin layout every
    window is binned against (the booster's training data by default).
    ``params`` feeds the serving knobs and the ``online_*`` policy;
    ``checkpoint_prefix`` arms the cycle windows and checkpoints (a rerun
    resumes a preempted cycle); ``publish_out`` keeps each published
    generation's model text (a restarted process warm-starts from it).
    ``device`` is the server's (``cuda`` unless the caller passes
    ``"cpu"``); a loaded model goes there too.  Extra keyword arguments go
    to :class:`~lightgbm_tpu_torch.serving.Server`.  Returns the running
    :class:`~lightgbm_tpu_torch.online.OnlineController`: ``submit``,
    ``ingest``, ``close`` (also a context manager)."""
    from .boosting.gbdt import GBDT
    from .config import Config, alias_transform
    from .online import OnlineController
    from .plan import state as _plan_state
    from .serving import Server

    cfg = Config(alias_transform(dict(params or {})))
    own_tele = (obs.configure_from_config(cfg, "engine.serve_and_train")
                if obs.active() is None else None)
    _plan_state.configure_from_config(cfg)
    server = None
    try:
        server = Server(config=cfg, owned_telemetry=own_tele, device=device,
                        **server_kwargs)
        if isinstance(booster, str):
            booster = GBDT.load_model(booster, cfg, device=server.device)
        if train_set is not None:
            construct = getattr(train_set, "construct", None)
            if construct is not None:
                train_set = construct()
            train_set = getattr(train_set, "handle", train_set)
        controller = OnlineController(
            server=server, name=name, booster=booster, base_ds=train_set,
            config=cfg, checkpoint_prefix=checkpoint_prefix,
            publish_out=publish_out, warm=warm)
        controller.start()
    except BaseException:
        # a failed construction must not leak the dispatcher thread or
        # keep the owned run process-active
        if server is not None:
            server.disown_telemetry()
            server.close(drain=False)
        if own_tele is not None and obs.active() is own_tele:
            obs.disable()
        raise
    return controller


class CVBooster:
    """Ensemble of per-fold boosters (engine.py:277 _CVBooster)."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold, params, seed,
                  fpreproc=None, stratified=True, shuffle=True,
                  eval_train_metric=False, device: DeviceLike = None):
    full_data = full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError("folds should be a generator or iterator of "
                                 "(train_idx, test_idx) tuples or scikit-learn "
                                 "splitter object with split method")
        if hasattr(folds, "split"):
            group_info = full_data.get_group()
            if group_info is not None:
                group_info = np.asarray(group_info, dtype=np.int32)
                flatted_group = np.repeat(range(len(group_info)),
                                          repeats=group_info)
            else:
                flatted_group = np.zeros(num_data, dtype=np.int32)
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(),
                                groups=flatted_group)
    else:
        if any(params.get(name) in {"lambdarank", "rank_xendcg"}
               for name in ("objective", "application")):
            # group-aware fold split (engine.py:313)
            group_info = np.asarray(full_data.get_group(), dtype=np.int32)
            num_group = len(group_info)
            group_kfold = _LGBMGroupKFold(n_splits=nfold)
            flatted_group = np.repeat(range(num_group), repeats=group_info)
            folds = group_kfold.split(np.empty(num_data), groups=flatted_group)
        elif stratified:
            labels = np.asarray(full_data.get_label())
            order = np.argsort(labels, kind="stable")
            folds_idx = [order[i::nfold] for i in range(nfold)]
            folds = [(np.setdiff1d(np.arange(num_data), fi), np.sort(fi))
                     for fi in folds_idx]
        else:
            if shuffle:
                randidx = np.random.RandomState(seed).permutation(num_data)
            else:
                randidx = np.arange(num_data)
            kstep = int(num_data / nfold)
            test_id = [randidx[i:i + kstep] for i in range(0, num_data, kstep)
                       ][:nfold]
            folds = [(np.setdiff1d(randidx, ti), np.sort(ti)) for ti in test_id]

    ret = CVBooster()
    for train_idx, test_idx in folds:
        train_subset = full_data.subset(sorted(train_idx))
        valid_subset = full_data.subset(sorted(test_idx))
        if fpreproc is not None:
            train_subset, valid_subset, tparam = fpreproc(
                train_subset, valid_subset, params.copy())
        else:
            tparam = params
        cvbooster = Booster(tparam, train_subset, device=device)
        if eval_train_metric:
            cvbooster.add_valid(train_subset, "train")
        cvbooster.add_valid(valid_subset, "valid")
        ret._append(cvbooster)
    return ret


class _LGBMGroupKFold:
    """Minimal GroupKFold (sklearn-compatible subset) for ranking cv."""

    def __init__(self, n_splits=5):
        self.n_splits = n_splits

    def split(self, X, y=None, groups=None):
        groups = np.asarray(groups)
        unique = np.unique(groups)
        for i in range(self.n_splits):
            test_groups = unique[i::self.n_splits]
            test_mask = np.isin(groups, test_groups)
            yield np.where(~test_mask)[0], np.where(test_mask)[0]


def _agg_cv_result(raw_results, eval_train_metric=False):
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            if eval_train_metric:
                key = "%s %s" % (one_line[0], one_line[1])
            else:
                key = one_line[1]
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, [])
            cvmap[key].append(one_line[2])
    return [("cv_agg", k, np.mean(v), metric_type[k], np.std(v))
            for k, v in cvmap.items()]


def cv(params, train_set, num_boost_round=100, folds=None, nfold=5,
       stratified=True, shuffle=True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv=True, seed=0, callbacks=None, eval_train_metric=False,
       return_cvbooster=False, device: DeviceLike = None):
    """Cross-validation (engine.py:572-656 of the JAX package): one booster
    per fold on ``device`` (``cuda`` unless the caller passes ``"cpu"``);
    returns a dict of 'metric-mean'/'metric-stdv' lists."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
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
    if metrics is not None:
        params["metric"] = metrics
    params["num_iterations"] = num_boost_round
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    _engage_plan_cache(params)
    results = collections.defaultdict(list)
    cvfolds = _make_n_folds(train_set, folds=folds, nfold=nfold,
                            params=params, seed=seed, fpreproc=fpreproc,
                            stratified=stratified, shuffle=shuffle,
                            eval_train_metric=eval_train_metric,
                            device=device)

    callbacks = set() if callbacks is None else set(callbacks)
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(callback.early_stopping(early_stopping_rounds,
                                              first_metric_only, verbose=False))
    if verbose_eval is True:
        callbacks.add(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        callbacks.add(callback.print_evaluation(verbose_eval, show_stdv))
    callbacks_before_iter = sorted(
        (cb for cb in callbacks if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after_iter = sorted(
        (cb for cb in callbacks if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    for i in range(num_boost_round):
        for cb in callbacks_before_iter:
            cb(callback.CallbackEnv(model=cvfolds, params=params, iteration=i,
                                    begin_iteration=0,
                                    end_iteration=num_boost_round,
                                    evaluation_result_list=None))
        for b in cvfolds.boosters:
            b.update(fobj=fobj)
        res = _agg_cv_result([b.eval_valid(feval) for b in cvfolds.boosters],
                             eval_train_metric)
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in callbacks_after_iter:
                cb(callback.CallbackEnv(model=cvfolds, params=params,
                                        iteration=i, begin_iteration=0,
                                        end_iteration=num_boost_round,
                                        evaluation_result_list=res))
        except callback.EarlyStopException as earlyStopException:
            cvfolds.best_iteration = earlyStopException.best_iteration + 1
            for k in results:
                results[k] = results[k][:cvfolds.best_iteration]
            break
    for b in cvfolds.boosters:
        b._booster._drain_nonfinite_checks()
    if return_cvbooster:
        results["cvbooster"] = cvfolds
    return dict(results)
