"""Persisted plan cache: tuned winners, versioned, atomic and fail-safe.

The counterpart of ``lightgbm_tpu/plan/cache.py`` (:1-187).  The autotuner
(``plan/autotune.py``) times candidate plans once per (shape class, card)
and persists the winners here: one JSON document written through
``utils.file_io.atomic_write``, by default in the port's own build
directory beside the kernel libraries (``build/plan/plan_cache.json`` at
the repository root; ``LIGHTGBM_TPU_TORCH_CACHE_DIR`` overrides the
directory).

Failure contract: a corrupt, foreign-version or foreign-card file never
degrades a run.  It falls back to the analytic plans with ONE warning a
process and the always-on ``plan_cache_fallbacks`` counter.  A JAX package
cache file is such a foreign file: its entries hold the TPU's fields, so
it fails the port's plan schema and is never half-applied.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

from . import planner

CACHE_VERSION = 1
# the document's package stamp: a file written by another package (the JAX
# package writes none) is foreign here
PACKAGE = "lightgbm_tpu_torch"
CACHE_DIR_ENV = "LIGHTGBM_TPU_TORCH_CACHE_DIR"

_lock = threading.Lock()
_fallbacks = 0
_warned = False


def _note_fallback(reason: str, path: str) -> None:
    """Count (always on), warn once a process, and leave a telemetry
    breadcrumb."""
    global _fallbacks, _warned
    with _lock:
        _fallbacks += 1
        first = not _warned
        _warned = True
    if first:
        from ..utils.log import Log
        Log.warning("plan cache %s unusable (%s); falling back to analytic "
                    "plans: fix the path, or regenerate the cache with "
                    "plan.autotune.run_sweep", path, reason)
    from ..obs import active as _active
    tele = _active()
    if tele is not None:
        tele.counter("plan_cache_fallbacks").inc()
        tele.event("plan_fallback", path=str(path), reason=str(reason))


def fallback_count() -> int:
    """Loads and lookups of this process that degraded to analytic plans
    (``plan_cache_fallbacks_total`` on /metrics)."""
    with _lock:
        return _fallbacks


def reset_fallbacks() -> None:
    """Test hook."""
    global _fallbacks, _warned
    with _lock:
        _fallbacks = 0
        _warned = False


def default_cache_path() -> str:
    """``build/plan/plan_cache.json`` at the repository root, or under
    ``$LIGHTGBM_TPU_TORCH_CACHE_DIR``."""
    base = os.environ.get(CACHE_DIR_ENV)
    if not base:
        base = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "build", "plan")
    return os.path.join(base, "plan_cache.json")


class PlanCache:
    """Tuned plans per shape-class key, with the autotuner's margins."""

    def __init__(self, device_kind: str = "",
                 path: Optional[str] = None) -> None:
        self.device_kind = str(device_kind)
        self.path = path
        # key -> {"plan": dict, "metrics": dict, "shape": list}
        self.entries: Dict[str, Dict[str, Any]] = {}

    def put(self, sc: planner.ShapeClass, plan: planner.Plan,
            metrics: Optional[Dict[str, Any]] = None) -> str:
        key = planner.plan_key(sc)
        self.entries[key] = {
            "plan": planner.plan_to_dict(plan._replace(provenance="tuned")),
            "metrics": dict(metrics or {}),
            "shape": list(sc),
        }
        return key

    def lookup(self, sc: planner.ShapeClass) -> Optional[planner.Plan]:
        """The tuned plan of ``sc``'s class, validated; an entry that does
        not parse as the port's plan counts as a fallback."""
        ent = self.entries.get(planner.plan_key(sc))
        if ent is None:
            return None
        try:
            plan = planner.plan_from_dict(ent["plan"])
            plan = plan._replace(provenance="tuned")
            planner.validate_plan(plan)
        except (KeyError, TypeError, ValueError) as exc:
            _note_fallback("invalid tuned entry %s: %s"
                           % (planner.plan_key(sc), exc),
                           self.path or "<memory>")
            return None
        return plan

    def to_doc(self) -> Dict[str, Any]:
        return {"version": CACHE_VERSION, "package": PACKAGE,
                "plan_schema": planner.PLAN_SCHEMA_VERSION,
                "device_kind": self.device_kind, "entries": self.entries}

    def save(self, path: Optional[str] = None) -> str:
        """Atomic write (tmp, fsync, rename)."""
        from ..utils.file_io import atomic_write
        path = path or self.path or default_cache_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        atomic_write(path, (json.dumps(self.to_doc(), indent=1,
                                       sort_keys=True) + "\n").encode())
        self.path = path
        return path


def load_cache(path: str,
               device_kind: Optional[str] = None) -> Optional[PlanCache]:
    """Load and check a persisted cache; None (analytic plans) on any
    defect: a missing file is silent (the no-cache default), a corrupt,
    foreign-version, foreign-package or foreign-card file is a counted,
    warned-once fallback.  Every entry is checked here, so a bad one
    rejects the whole file."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as exc:
        _note_fallback("unreadable: %s" % exc, path)
        return None
    if not isinstance(doc, dict):
        _note_fallback("not a JSON object", path)
        return None
    if doc.get("package") != PACKAGE:
        _note_fallback("written by %r, not %s (another package's cache)"
                       % (doc.get("package"), PACKAGE), path)
        return None
    if doc.get("version") != CACHE_VERSION:
        _note_fallback("version %r != %d" % (doc.get("version"),
                                             CACHE_VERSION), path)
        return None
    if doc.get("plan_schema") != planner.PLAN_SCHEMA_VERSION:
        _note_fallback("plan schema %r != %d"
                       % (doc.get("plan_schema"),
                          planner.PLAN_SCHEMA_VERSION), path)
        return None
    if device_kind is None:
        from . import device_specs
        device_kind = device_specs.current_device_kind()
    cached_kind = str(doc.get("device_kind", ""))
    if cached_kind and cached_kind != str(device_kind):
        # timings taken on another card do not transfer
        _note_fallback("tuned for %r, running on %r"
                       % (cached_kind, device_kind), path)
        return None
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        _note_fallback("entries block missing", path)
        return None
    for key, ent in entries.items():
        try:
            planner.validate_plan(planner.plan_from_dict(ent["plan"]))
        except (KeyError, TypeError, ValueError) as exc:
            _note_fallback("entry %s: %s" % (key, exc), path)
            return None
    cache = PlanCache(device_kind=cached_kind, path=path)
    cache.entries = entries
    return cache
