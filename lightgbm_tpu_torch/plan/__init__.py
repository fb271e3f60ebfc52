"""The kernel planner of the port, with a persisted autotuner.

The counterpart of ``lightgbm_tpu/plan/__init__.py`` (:1-53): one planner,
(shape class, card) -> a typed :class:`~.planner.Plan` of the port's four
dispatch choices (the split pass's block bytes, the integer histogram's
target blocks, the predict walk's budget, the serving ladder).  See
``plan/planner.py`` for the contract, ``plan/state.py`` for resolution,
``plan/cache.py`` for the persisted cache and its fallback,
``plan/autotune.py`` for the tuner and ``plan/device_specs.py`` for the
card tables.

``core/histogram.py`` imports ``plan.device_specs`` at load, which runs
this ``__init__`` first, so everything here is lazy (PEP 562): importing
``lightgbm_tpu_torch.plan`` imports nothing else.
"""
from __future__ import annotations

_SUBMODULES = ("autotune", "cache", "device_specs", "planner", "state")

_LAZY = {
    "Plan": ("planner", "Plan"),
    "ShapeClass": ("planner", "ShapeClass"),
    "analytic_plan": ("planner", "analytic_plan"),
    "plan_key": ("planner", "plan_key"),
    "shape_class": ("planner", "shape_class"),
    "validate_plan": ("planner", "validate_plan"),
    "resolve": ("state", "resolve"),
    "configure": ("state", "configure"),
    "configure_from_config": ("state", "configure_from_config"),
    "pinned": ("state", "pinned"),
    "stamp": ("state", "stamp"),
    "fallback_count": ("cache", "fallback_count"),
    "default_cache_path": ("cache", "default_cache_path"),
}

__all__ = sorted(set(_SUBMODULES) | set(_LAZY))


def __getattr__(name):
    import importlib
    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    if name in _LAZY:
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module("." + mod, __name__), attr)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def __dir__():
    return __all__
