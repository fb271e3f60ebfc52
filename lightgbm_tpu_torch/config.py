"""Copied from ``lightgbm_tpu/config.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports differ.

Typed configuration with alias resolution and validation.

TPU-native counterpart of the reference config system (include/LightGBM/config.h:26-972,
src/io/config.cpp, generated src/io/config_auto.cpp).  Parameter names, aliases, defaults
and range checks are extracted from the reference's doc comments into
``_params_meta.PARAMS`` by ``tools/gen_params.py`` — the same single-source-of-truth
pattern the reference uses (helpers/parameter_generator.py).

Key behaviors mirrored:
- alias canonicalization with a warning when both alias and canonical key are given
  (config.h:972 ``ParameterAlias::KeyAliasTransform``, config.cpp:15-40);
- objective/metric/boosting/task name normalization
  (config.h:1013 ``ParseObjectiveAlias``, :1040 ``ParseMetricAlias``,
  config.cpp:51-127 ``GetBoostingType/GetTaskType/GetDeviceType``);
- metric defaults to the objective's metric when unset (config.cpp:90-103);
- range checks from ``// check =`` doc comments (config_auto.cpp CHECK calls).

Device types: ``cpu`` (XLA:CPU), ``tpu`` (Pallas/XLA:TPU).  ``gpu`` is accepted as an
alias for the accelerator path so reference configs run unmodified (config.h:887-895
GPU knobs are accepted and ignored with a debug note).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from ._params_meta import PARAMS
from .utils.log import Log

_PARAM_BY_NAME: Dict[str, dict] = {p["name"]: p for p in PARAMS}

# alias -> canonical parameter name
ALIAS_TABLE: Dict[str, str] = {}
for _p in PARAMS:
    for _a in _p["aliases"]:
        ALIAS_TABLE[_a] = _p["name"]
# The reference treats these as first-class keys handled outside the struct.
ALIAS_TABLE.setdefault("metrics", "metric")
ALIAS_TABLE.setdefault("metric_types", "metric")

_OBJECTIVE_ALIASES = {
    **{k: "regression" for k in (
        "regression", "regression_l2", "mean_squared_error", "mse", "l2",
        "l2_root", "root_mean_squared_error", "rmse")},
    **{k: "regression_l1" for k in (
        "regression_l1", "mean_absolute_error", "l1", "mae")},
    **{k: "multiclass" for k in ("multiclass", "softmax")},
    **{k: "multiclassova" for k in ("multiclassova", "multiclass_ova", "ova", "ovr")},
    **{k: "cross_entropy" for k in ("xentropy", "cross_entropy")},
    **{k: "cross_entropy_lambda" for k in ("xentlambda", "cross_entropy_lambda")},
    **{k: "mape" for k in ("mean_absolute_percentage_error", "mape")},
    **{k: "rank_xendcg" for k in (
        "rank_xendcg", "xendcg", "xe_ndcg", "xe_ndcg_mart", "xendcg_mart")},
    **{k: "custom" for k in ("none", "null", "custom", "na")},
}

_METRIC_ALIASES = {
    **{k: "l2" for k in ("regression", "regression_l2", "l2", "mean_squared_error", "mse")},
    **{k: "rmse" for k in ("l2_root", "root_mean_squared_error", "rmse")},
    **{k: "l1" for k in ("regression_l1", "l1", "mean_absolute_error", "mae")},
    **{k: "binary_logloss" for k in ("binary_logloss", "binary")},
    **{k: "ndcg" for k in ("ndcg", "lambdarank", "rank_xendcg", "xendcg", "xe_ndcg",
                           "xe_ndcg_mart", "xendcg_mart")},
    **{k: "map" for k in ("map", "mean_average_precision")},
    **{k: "multi_logloss" for k in ("multi_logloss", "multiclass", "softmax",
                                    "multiclassova", "multiclass_ova", "ova", "ovr")},
    **{k: "cross_entropy" for k in ("xentropy", "cross_entropy")},
    **{k: "cross_entropy_lambda" for k in ("xentlambda", "cross_entropy_lambda")},
    **{k: "kullback_leibler" for k in ("kldiv", "kullback_leibler")},
    **{k: "mape" for k in ("mean_absolute_percentage_error", "mape")},
    "auc_mu": "auc_mu",
    **{k: "custom" for k in ("none", "null", "custom", "na")},
}

_BOOSTING_ALIASES = {"gbdt": "gbdt", "gbrt": "gbdt", "dart": "dart", "goss": "goss",
                     "rf": "rf", "random_forest": "rf"}

_TASK_ALIASES = {"train": "train", "training": "train",
                 "predict": "predict", "prediction": "predict", "test": "predict",
                 "convert_model": "convert_model",
                 "refit": "refit", "refit_tree": "refit",
                 "serve": "serve", "serving": "serve",
                 "online": "online", "serve_and_train": "online",
                 "train_while_serve": "online"}

_TREE_LEARNER_ALIASES = {"serial": "serial",
                         "feature": "feature", "feature_parallel": "feature",
                         "data": "data", "data_parallel": "data",
                         "voting": "voting", "voting_parallel": "voting"}

# gpu-specific knobs accepted for config compatibility but inert on TPU
_INERT_ON_TPU = ("gpu_platform_id", "gpu_device_id", "gpu_use_dp")


def parse_objective_alias(name: str) -> str:
    return _OBJECTIVE_ALIASES.get(name.lower(), name.lower())


def parse_metric_alias(name: str) -> str:
    return _METRIC_ALIASES.get(name.lower(), name.lower())


def _coerce(pytype: str, value: Any, name: str) -> Any:
    if pytype == "bool":
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("true", "+", "1"):
                return True
            if v in ("false", "-", "0"):
                return False
            Log.fatal("Parameter %s should be of type bool, got \"%s\"", name, value)
        return bool(value)
    if pytype == "int":
        if isinstance(value, str):
            value = float(value)
        if isinstance(value, float) and value != int(value):
            Log.fatal("Parameter %s should be of type int, got \"%s\"", name, value)
        return int(value)
    if pytype == "float":
        return float(value)
    if pytype == "str":
        return str(value)
    # list types
    if isinstance(value, str):
        items = [s for s in value.split(",") if s != ""]
    elif isinstance(value, (list, tuple)):
        items = list(value)
    else:
        items = [value]
    if pytype == "list_int":
        return [int(float(i)) for i in items]
    if pytype == "list_float":
        return [float(i) for i in items]
    if pytype == "list_str":
        return [str(i) for i in items]
    return items


def _check(name: str, value: Any, checks: List[str]) -> None:
    for c in checks:
        for op, fn in (
                (">=", lambda a, b: a >= b), ("<=", lambda a, b: a <= b),
                (">", lambda a, b: a > b), ("<", lambda a, b: a < b)):
            if c.startswith(op):
                bound = float(c[len(op):])
                if not fn(float(value), bound):
                    Log.fatal("Parameter %s should be %s, got %s", name, c, value)
                break


def alias_transform(params: Dict[str, Any]) -> Dict[str, Any]:
    """Canonicalize keys via the alias table (config.h:972, config.cpp:15-40)."""
    out: Dict[str, Any] = {}
    for key in params:
        canon = ALIAS_TABLE.get(key, key)
        if canon in out or (canon != key and canon in params):
            prev = params.get(canon, out.get(canon))
            Log.warning("%s is set=%s, %s=%s will be ignored. Current value: %s=%s",
                        canon, prev, key, params[key], canon, prev)
            continue
        out[canon] = params[key]
    return out


class Config:
    """Full typed parameter set; unknown keys warn (config.cpp:37 \"Unknown parameter\")."""

    def __init__(self, params: Optional[Dict[str, Any]] = None, **kwargs: Any) -> None:
        for p in PARAMS:
            setattr(self, p["name"], copy.copy(p["default"]))
        self.task = "train"
        self.eval_at = [1, 2, 3, 4, 5]
        merged = dict(params or {})
        merged.update(kwargs)
        self.raw_params: Dict[str, Any] = {}
        self.set(merged)

    def set(self, params: Dict[str, Any]) -> None:
        params = alias_transform({k: v for k, v in params.items() if v is not None})
        self.raw_params.update(params)

        # special, order-sensitive keys (config.cpp:196-203)
        if "task" in params:
            v = str(params.pop("task")).lower()
            if v not in _TASK_ALIASES:
                Log.fatal("Unknown task type %s", v)
            self.task = _TASK_ALIASES[v]
        if "boosting" in params:
            v = str(params.pop("boosting")).lower()
            if v not in _BOOSTING_ALIASES:
                Log.fatal("Unknown boosting type %s", v)
            self.boosting = _BOOSTING_ALIASES[v]
        if "tree_learner" in params:
            v = str(params.pop("tree_learner")).lower()
            if v not in _TREE_LEARNER_ALIASES:
                Log.fatal("Unknown tree learner type %s", v)
            self.tree_learner = _TREE_LEARNER_ALIASES[v]
        if "device_type" in params:
            v = str(params.pop("device_type")).lower()
            if v == "gpu":
                Log.debug("device_type=gpu maps to the TPU accelerator path")
                v = "tpu"
            if v not in ("cpu", "tpu"):
                Log.fatal("Unknown device type %s", v)
            self.device_type = v
        metric_explicit = "metric" in params
        if metric_explicit:
            raw = params.pop("metric")
            if isinstance(raw, (list, tuple)):
                names = [str(m) for m in raw]
            else:
                names = [m for m in str(raw).split(",")]
            seen, metrics = set(), []
            for m in names:
                t = parse_metric_alias(m.strip()) if m.strip() else ""
                if t and t not in seen:
                    seen.add(t)
                    metrics.append(t)
            self.metric = metrics
        if "objective" in params:
            self.objective = parse_objective_alias(str(params.pop("objective")))
        # metric defaults to objective's metric when not given (config.cpp:96-103)
        if not self.metric and not metric_explicit and self.objective != "custom":
            self.metric = [parse_metric_alias(self.objective)]

        for name, value in params.items():
            meta = _PARAM_BY_NAME.get(name)
            if meta is None:
                Log.warning("Unknown parameter: %s", name)
                continue
            coerced = _coerce(meta["type"], value, name)
            if meta["type"] in ("int", "float"):
                _check(name, coerced, meta["checks"])
            setattr(self, name, coerced)

        self._post_process()

    def _post_process(self) -> None:
        """Cross-parameter fixups (config.cpp:129-193 CheckParamConflict et al.)."""
        if self.objective in ("multiclass", "multiclassova"):
            if self.num_class <= 1:
                Log.fatal("Number of classes should be specified and greater than 1 "
                          "for multiclass training")
        elif self.task == "train" and self.num_class != 1 and self.objective not in ("custom",):
            Log.fatal("Number of classes must be 1 for non-multiclass training")
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            Log.fatal("Cannot set both is_unbalance and scale_pos_weight, "
                      "choose only one of them")
        if self.boosting == "rf":
            if not (self.bagging_freq > 0 and 0.0 < self.bagging_fraction < 1.0):
                Log.fatal("Random forest mode requires bagging "
                          "(bagging_freq > 0 and 0 < bagging_fraction < 1)")
            if self.feature_fraction >= 1.0 and self.feature_fraction_bynode >= 1.0:
                Log.fatal("Random forest mode requires feature subsampling "
                          "(feature_fraction < 1 or feature_fraction_bynode < 1)")
        elif self.boosting == "goss":
            if self.bagging_freq > 0 and self.bagging_fraction < 1.0:
                Log.warning("Found bagging_fraction with goss; bagging is disabled in goss")
        # TPU-runtime extension params (robustness subsystem)
        self.nan_policy = str(self.nan_policy).lower()
        if self.nan_policy not in ("raise", "skip_iter", "clip"):
            Log.fatal("Unknown nan_policy %s (expected raise, skip_iter or "
                      "clip)", self.nan_policy)
        # round-12 dispatch params
        self.tree_grow_mode = str(self.tree_grow_mode).lower()
        if self.tree_grow_mode not in ("leaf", "level"):
            Log.fatal("Unknown tree_grow_mode %s (expected leaf or level)",
                      self.tree_grow_mode)
        # round-22 quantized-gradient training axis
        self.hist_precision = str(self.hist_precision).lower()
        if self.hist_precision not in ("exact", "quantized"):
            Log.fatal("Unknown hist_precision %s (expected exact or "
                      "quantized)", self.hist_precision)
        # round-13 serving params: the coalescing window is a LATENCY the
        # operator adds to every request — a window past one second is
        # almost certainly a unit mistake (us, not ms/s)
        if int(self.max_batch_wait_us) > 1_000_000:
            Log.warning("max_batch_wait_us=%d is over one second; the "
                        "coalescing window is in MICROseconds",
                        int(self.max_batch_wait_us))
        import math
        if not math.isfinite(float(self.serve_residency_budget_mb)):
            Log.fatal("serve_residency_budget_mb must be finite (use <= 0 "
                      "for unlimited residency)")
        # round-14 live-plane params: a non-loopback bind is an explicit
        # operator decision (the endpoint has no auth), warn so it never
        # happens by accident
        self.metrics_addr = str(self.metrics_addr).strip() or "127.0.0.1"
        if int(self.metrics_port) > 0 \
                and self.metrics_addr not in ("127.0.0.1", "localhost",
                                              "::1"):
            Log.warning("metrics_port=%d binds %s: the observability "
                        "endpoint is unauthenticated — make sure the "
                        "network perimeter covers it",
                        int(self.metrics_port), self.metrics_addr)
        # round-16 forensics params: both ride the telemetry run — without
        # one (telemetry_out or metrics_port) the drivers never configure
        # obs and the arm silently does nothing, which is worth a warning
        has_run = bool(str(self.telemetry_out or "")) \
            or int(self.metrics_port) > 0
        if str(self.alert_rules or ""):
            import os as _os
            if not _os.path.exists(str(self.alert_rules)):
                Log.warning("alert_rules=%s does not exist; live alerting "
                            "will be disabled", self.alert_rules)
            if not has_run:
                Log.warning("alert_rules is set but no telemetry run is "
                            "configured (telemetry_out/metrics_port); the "
                            "alert engine only runs on a telemetry run")
        if bool(self.flight_recorder) and not has_run:
            Log.warning("flight_recorder=true without a telemetry run "
                        "(telemetry_out/metrics_port); no capture can be "
                        "armed")
        # round-18 kernel-planner param: validation of the plan_cache path
        # lives at engagement (plan/state.configure) — an unusable or
        # missing explicit cache warns once there and bumps the always-on
        # plan_cache_fallbacks counter; warning here too would double up
        # round-17 online-learning params
        self.online_update = str(self.online_update).lower()
        if self.online_update not in ("extend", "refit"):
            Log.fatal("Unknown online_update %s (expected extend or refit)",
                      self.online_update)
        if self.task == "online":
            if not (int(self.online_min_rows) or float(self.online_interval_s)
                    or bool(self.online_drift_trigger)
                    or int(self.online_max_rows_behind)
                    or float(self.online_max_seconds_behind)):
                Log.warning("task=online with every retrain trigger off "
                            "(online_min_rows/online_interval_s/"
                            "online_drift_trigger/freshness SLOs): the "
                            "trainer will never fire")
            if bool(self.online_drift_trigger) \
                    and not bool(self.quality_monitor):
                Log.warning("online_drift_trigger=true needs the quality "
                            "monitor (quality_monitor=true) and a telemetry "
                            "run; the drift trigger will never fire "
                            "without them")
        if int(self.online_window_rows) \
                and int(self.online_window_rows) > int(self.online_buffer_rows):
            Log.warning("online_window_rows=%d exceeds online_buffer_rows=%d;"
                        " windows are capped by the buffer",
                        int(self.online_window_rows),
                        int(self.online_buffer_rows))
        # round-21 streaming-ingest params: chunked construction re-stripes
        # the file per rank internally; combining it with an input that is
        # ALREADY sharded per machine (pre_partition) would silently shard
        # twice and train each rank on a stripe of a stripe — hard error,
        # the two knobs are different answers to the same question
        if int(self.data_chunk_rows) > 0 and bool(self.pre_partition):
            Log.fatal("data_chunk_rows is incompatible with "
                      "pre_partition=true: pre-partitioned inputs are "
                      "already one shard per machine, the streaming loader "
                      "would shard them again (drop one of the two)")
        if 0 < int(self.data_chunk_rows) < 1024:
            Log.warning("data_chunk_rows=%d is very small; per-chunk parse "
                        "overhead will dominate (typical: 65536-1048576)",
                        int(self.data_chunk_rows))
        if ("io_retry_attempts" in self.raw_params
                or "io_retry_backoff_s" in self.raw_params):
            # the retry policy is process-wide (file_io.atomic_write), so an
            # explicit parameter configures it
            from .utils.file_io import configure_retries
            configure_retries(attempts=int(self.io_retry_attempts),
                              base_delay=float(self.io_retry_backoff_s))
        # seed cascade (config.cpp:205-230): explicit `seed` derives the sub-seeds
        if "seed" in self.raw_params:
            base = int(self.seed)
            for name, off in (("data_random_seed", 1), ("bagging_seed", 3),
                              ("drop_seed", 4), ("feature_fraction_seed", 2),
                              ("objective_seed", 5), ("extra_seed", 6)):
                if name in _PARAM_BY_NAME and name not in self.raw_params:
                    setattr(self, name, base + off)

    def to_dict(self) -> Dict[str, Any]:
        return {p["name"]: getattr(self, p["name"]) for p in PARAMS}

    def __repr__(self) -> str:  # pragma: no cover
        return "Config(%s)" % (", ".join(
            "%s=%r" % (k, v) for k, v in sorted(self.raw_params.items())))


def parse_config_file(path: str) -> Dict[str, str]:
    """``key = value`` config-file parsing, ``#`` comments (config.cpp KV2Map usage;
    application.cpp:49-82 gives CLI args precedence over file lines)."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out
