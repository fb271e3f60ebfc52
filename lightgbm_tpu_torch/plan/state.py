"""Process-global plan engagement: the one entry point the sites read.

The counterpart of ``lightgbm_tpu/plan/state.py`` (:1-237).  Resolution
precedence, as there: a **pinned** plan (:func:`pin`, :func:`pinned`: tests
and the autotuner's candidates), then a **tuned** entry of the engaged cache
(:func:`configure`, from the ``plan_cache`` parameter or the default path),
then the **analytic** plan.

The tree learner resolves its plan once, at construction, and runs every
tree inside :func:`dispatching`, which makes that plan the calling thread's
dispatch plan: the split pass's block bytes (``core/partition.py``) and the
integer histogram's target blocks (``core/histogram.py``) read it through
:func:`part_block_bytes` and :func:`int_fill_blocks`.  A thread that is not
inside a learner's tree (a kernel check, a second learner's thread) reads a
pinned plan, else the analytic constants.  The predict walk's budget
(:func:`walk_temp_bytes`) and the serving ladder (:func:`predict_buckets`)
belong to a model, not a dataset's shape class, so they take a pinned plan,
else the engaged cache's value when every entry agrees on it
(state.py:190-215 of the JAX package), else the analytic constant.

:func:`stamp` records which plan a site dispatched under into the active
telemetry run: a ``kind="plan"`` event per (site, key, provenance) and the
``plan_stamps`` the summary's ``plan`` block folds.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Optional

from . import cache as _cache
from . import planner

_lock = threading.Lock()
_state: Dict[str, Any] = {"cache": None, "path": None, "pinned": None,
                          "explicit": False}
_local = threading.local()


def configure(path: Optional[str] = None, *,
              discover: bool = True) -> Optional[_cache.PlanCache]:
    """Engage a persisted plan cache for the process.

    An explicit ``path`` is authoritative: a missing file there is a
    counted fallback, and the engagement survives later default-discovery
    probes from entry points.  ``path=None`` with ``discover`` probes the
    default location (a missing file is the silent analytic default) and
    never disengages a cache an explicit call installed.  Returns the
    engaged cache or None."""
    if path is None:
        if not discover:
            return None
        with _lock:
            if _state["explicit"] and _state["cache"] is not None:
                return _state["cache"]
        default = _cache.default_cache_path()
        loaded = _cache.load_cache(default)
        with _lock:
            if _state["explicit"] and _state["cache"] is not None:
                return _state["cache"]
            _state["cache"] = loaded
            _state["path"] = default if loaded is not None else None
            _state["explicit"] = False
        return loaded
    path = str(path)
    if not os.path.exists(path):
        _cache._note_fallback("explicitly requested cache is missing", path)
        loaded = None
    else:
        loaded = _cache.load_cache(path)
    with _lock:
        _state["cache"] = loaded
        _state["path"] = path if loaded is not None else None
        _state["explicit"] = loaded is not None
    return loaded


def configure_from_config(config) -> Optional[_cache.PlanCache]:
    """Parameter-driven engagement (``train``, ``cv``, ``serve``,
    ``serve_and_train``, the CLI): an explicit ``plan_cache`` path is
    loaded, else the default location is probed."""
    path = str(getattr(config, "plan_cache", "") or "")
    return configure(path or None, discover=True)


def configured_path() -> Optional[str]:
    with _lock:
        return _state["path"]


def reset() -> None:
    """Test hook: drop the engaged cache and any pin."""
    with _lock:
        _state["cache"] = None
        _state["path"] = None
        _state["pinned"] = None
        _state["explicit"] = False


def pin(plan: Optional[planner.Plan]) -> None:
    """Pin one plan for every later resolution (provenance ``pinned``);
    None unpins.  Validated on the way in."""
    if plan is not None:
        plan = plan._replace(provenance="pinned")
        planner.validate_plan(plan)
    with _lock:
        _state["pinned"] = plan


@contextlib.contextmanager
def pinned(plan: planner.Plan):
    """Scoped :func:`pin`."""
    with _lock:
        prev = _state["pinned"]
    pin(plan)
    try:
        yield
    finally:
        with _lock:
            _state["pinned"] = prev


def resolve(n_rows: int, num_features: int, num_bins: int, *,
            bpc: int = 1, packed: bool = False, num_class: int = 1,
            device_kind: Optional[str] = None,
            quantized: bool = False) -> planner.Plan:
    """Pinned > tuned (engaged cache, validated) > analytic.  Never raises,
    never returns None."""
    sc = planner.shape_class(n_rows, num_features, num_bins, bpc=bpc,
                             packed=packed, num_class=num_class,
                             device_kind=device_kind, quantized=quantized)
    with _lock:
        pinned_plan = _state["pinned"]
        cache = _state["cache"]
    if pinned_plan is not None:
        return pinned_plan
    if cache is not None:
        tuned = cache.lookup(sc)
        if tuned is not None:
            return tuned
    return planner.analytic_plan(sc)


def current_provenance() -> str:
    """What a resolution would report now (serving warm-up's stamp)."""
    with _lock:
        if _state["pinned"] is not None:
            return "pinned"
        if _state["cache"] is not None and _state["cache"].entries:
            return "tuned"
    return "analytic"


# ---- the dispatch sites ----

@contextlib.contextmanager
def dispatching(plan: Optional[planner.Plan]):
    """Make ``plan`` this thread's dispatch plan for the block (the tree
    learner wraps each tree in it)."""
    prev = getattr(_local, "plan", None)
    _local.plan = plan
    try:
        yield
    finally:
        _local.plan = prev


def dispatch_plan() -> Optional[planner.Plan]:
    """This thread's dispatch plan, else the pinned one, else None."""
    plan = getattr(_local, "plan", None)
    if plan is not None:
        return plan
    with _lock:
        return _state["pinned"]


def part_block_bytes() -> int:
    plan = dispatch_plan()
    return (int(plan.part_block_bytes) if plan is not None
            else planner.PART_BLOCK_BYTES)


def int_fill_blocks() -> int:
    plan = dispatch_plan()
    if plan is not None:
        return int(plan.int_fill_blocks)
    from .device_specs import INT_FILL_BLOCKS
    return INT_FILL_BLOCKS


def _model_site(field: str):
    """A model-level site's value: the dispatch plan, else the engaged
    cache's when every entry agrees on it, else None."""
    plan = dispatch_plan()
    if plan is not None:
        return getattr(plan, field)
    with _lock:
        cache = _state["cache"]
    if cache is None:
        return None
    vals = set()
    for ent in cache.entries.values():
        try:
            v = ent["plan"][field]
        except (KeyError, TypeError):
            continue
        vals.add(tuple(v) if isinstance(v, list) else v)
    return vals.pop() if len(vals) == 1 else None


def walk_temp_bytes() -> int:
    v = _model_site("walk_temp_bytes")
    return int(v) if v is not None else planner.WALK_TEMP_BYTES


def predict_buckets() -> tuple:
    v = _model_site("predict_buckets")
    return tuple(int(b) for b in v) if v is not None \
        else planner.PREDICT_BUCKETS


# ---- provenance stamping (telemetry) ----

def stamp(tele, site: str, provenance: str,
          key: Optional[str] = None, **fields: Any) -> None:
    """Record which plan a site dispatched under: one ``kind="plan"``
    event per (site, key, provenance) a run, and the ``plan_stamps`` the
    summary renders.  Callers gate on ``tele is not None``."""
    if tele is None:
        return
    provenance = (str(provenance) if provenance in planner.PROVENANCES
                  else "analytic")
    with _lock:
        stamps = getattr(tele, "plan_stamps", None)
        if stamps is None:
            stamps = tele.plan_stamps = {}
        tag = (str(site), str(key or ""), provenance)
        entry = stamps.get(site)
        if entry is not None and entry.get("_tag") == tag:
            return
        stamps[site] = {"_tag": tag, "provenance": provenance, "key": key,
                        **fields}
    tele.event("plan", site=str(site), provenance=provenance,
               key=str(key or ""), **fields)
