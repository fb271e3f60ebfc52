"""Copied from ``lightgbm_tpu/callback.py`` for the PyTorch port (which imports nothing of
the JAX package); the code is unchanged.

Training callbacks.

The callback PROTOCOL is the reference's public contract
(python-package/lightgbm/callback.py): ``train``/``cv`` call each callback
with a ``CallbackEnv``, callbacks are ordered by an ``order`` attribute and
may set ``before_iteration``, and early stopping ends training by raising
``EarlyStopException``.  The implementations here are class-based: each
callback is a small object whose ``__call__`` takes the env, which keeps
per-callback state on the instance instead of in closures.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

from .utils.log import Log


class EarlyStopException(Exception):
    """Raised by the early-stopping callback to end training."""

    def __init__(self, best_iteration, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv=True):
    """(data_name, eval_name, value, bigger_better[, stdv]) -> log text."""
    if len(value) == 4:
        return "%s's %s: %g" % (value[0], value[1], value[2])
    if len(value) == 5:
        if show_stdv:
            return "%s's %s: %g + %g" % (value[0], value[1], value[2], value[4])
        return "%s's %s: %g" % (value[0], value[1], value[2])
    raise ValueError("Wrong metric value")


class _PrintEvaluation:
    order = 10
    before_iteration = False

    def __init__(self, period: int, show_stdv: bool) -> None:
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        if (env.iteration + 1) % self.period:
            return
        line = "\t".join(_format_eval_result(v, self.show_stdv)
                         for v in env.evaluation_result_list)
        Log.info("[%d]\t%s", env.iteration + 1, line)


def print_evaluation(period=1, show_stdv=True):
    """Log evaluation results every ``period`` iterations."""
    return _PrintEvaluation(period, show_stdv)


class _RecordEvaluation:
    order = 20
    before_iteration = False

    def __init__(self, eval_result: dict) -> None:
        if not isinstance(eval_result, dict):
            raise TypeError("eval_result should be a dictionary")
        eval_result.clear()
        self.eval_result = eval_result

    def __call__(self, env: CallbackEnv) -> None:
        for entry in env.evaluation_result_list:
            data_name, eval_name, value = entry[0], entry[1], entry[2]
            per_data = self.eval_result.setdefault(
                data_name, collections.OrderedDict())
            per_data.setdefault(eval_name, []).append(value)


def record_evaluation(eval_result: dict):
    """Record evaluation history into ``eval_result``."""
    return _RecordEvaluation(eval_result)


class _ResetParameter:
    order = 10
    before_iteration = True

    def __init__(self, schedules: dict) -> None:
        self.schedules = schedules

    def _value_at(self, key, schedule, env: CallbackEnv):
        step = env.iteration - env.begin_iteration
        if isinstance(schedule, list):
            if len(schedule) != env.end_iteration - env.begin_iteration:
                raise ValueError(
                    "Length of list %r has to equal to 'num_boost_round'."
                    % key)
            return schedule[step]
        return schedule(step)

    def __call__(self, env: CallbackEnv) -> None:
        changed = {k: v for k, v in
                   ((key, self._value_at(key, sched, env))
                    for key, sched in self.schedules.items())
                   if env.params.get(k) != v}
        if changed:
            env.model.reset_parameter(changed)
            env.params.update(changed)


def reset_parameter(**kwargs):
    """Reset parameters on a schedule: a per-iteration value list or a
    ``callable(iteration) -> value`` per parameter name."""
    return _ResetParameter(kwargs)


class _MetricTracker:
    """Best-so-far state for one (dataset, metric) column."""

    def __init__(self, bigger_better: bool) -> None:
        self.sign = 1.0 if bigger_better else -1.0
        self.best = float("-inf")
        self.best_iteration = 0
        self.best_entries: Optional[List] = None

    def update(self, score: float, iteration: int, entries) -> None:
        if self.best_entries is None or self.sign * score > self.sign * self.best:
            self.best = score
            self.best_iteration = iteration
            self.best_entries = entries


class _EarlyStopping:
    order = 30
    before_iteration = False

    def __init__(self, stopping_rounds: int, first_metric_only: bool,
                 verbose: bool) -> None:
        self.rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.trackers: Dict[int, _MetricTracker] = {}
        self.enabled = True
        self.first_metric = ""
        self._started = False

    # -- setup --

    def _start(self, env: CallbackEnv) -> None:
        self._started = True
        boosting = next((env.params[a] for a in
                         ("boosting", "boosting_type", "boost")
                         if env.params.get(a)), "")
        if boosting == "dart":
            self.enabled = False
            Log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if self.verbose:
            Log.info("Training until validation scores don't improve for %d "
                     "rounds", self.rounds)
        self.first_metric = self._metric_name(env.evaluation_result_list[0])
        for i, entry in enumerate(env.evaluation_result_list):
            self.trackers[i] = _MetricTracker(bigger_better=bool(entry[3]))

    @staticmethod
    def _metric_name(entry) -> str:
        return entry[1].split(" ")[-1]

    def _siblings(self, env: CallbackEnv, i: int):
        """This entry first, then the other entries of the same dataset."""
        mine = env.evaluation_result_list[i]
        rest = [e for j, e in enumerate(env.evaluation_result_list)
                if j != i and e[0] == mine[0]]
        return [mine] + rest

    def _stop(self, tracker: _MetricTracker, metric_name: str, met: bool):
        if self.verbose:
            verb = "Early stopping" if met else "Did not meet early stopping"
            Log.info("%s, best iteration is:\n[%d]\t%s", verb,
                     tracker.best_iteration + 1,
                     "\t".join(_format_eval_result(x)
                               for x in tracker.best_entries))
            if self.first_metric_only:
                Log.info("Evaluated only: %s", metric_name)
        raise EarlyStopException(tracker.best_iteration, tracker.best_entries)

    # -- per-iteration --

    def __call__(self, env: CallbackEnv) -> None:
        if not self._started:
            self._start(env)
        if not self.enabled:
            return
        last = env.iteration == env.end_iteration - 1
        for i, entry in enumerate(env.evaluation_result_list):
            tracker = self.trackers[i]
            tracker.update(entry[2], env.iteration, self._siblings(env, i))
            name = self._metric_name(entry)
            if self.first_metric_only and name != self.first_metric:
                continue
            # training metrics never trigger stopping
            if entry[0] == "training" or (
                    entry[0] == "cv_agg" and entry[1].split(" ")[0] == "train"):
                continue
            if env.iteration - tracker.best_iteration >= self.rounds:
                self._stop(tracker, name, met=True)
            if last:
                self._stop(tracker, name, met=False)


def early_stopping(stopping_rounds, first_metric_only=False, verbose=True):
    """Stop training when no validation metric improved for
    ``stopping_rounds`` consecutive iterations."""
    return _EarlyStopping(stopping_rounds, first_metric_only, verbose)
