"""Always-on miss accounting per (function, bucket).

The counterpart of ``lightgbm_tpu/obs/recompile.py`` (:1-106).  The JAX
package counts jit cache misses: a dispatch that had to compile a device
program for a new shape bucket.  The port has no jit cache and compiles
nothing at a dispatch, so a count here means one thing, its counterpart of a
device-program miss: **a device artefact built for a key the process had not
built before**.  Two sites :func:`record`:

- ``predict_stack``: a stacked predictor (``core.predict_fused
  .FusedPredictor``: one class's trees as device tensors) built for a
  (kind, iteration range, class, layout, precision) key of a model, keyed
  as ``"<kind>:<start>-<end>:k<class>:<precision>"``.  A model evicted from
  the serving registry and admitted again restacks the same keys: that is
  not counted (the tensors are copied again, nothing new is built);
- ``kernels``: the hand-written CUDA libraries built (``nvcc``) or loaded by
  ``kernels/__init__.py``, once per process.

So the serving invariant of the JAX package holds with the same words:
steady-state serving adds 0 outside ``warm``/``swap`` (pinned by
``tests/test_torch_serving.py`` and the card's path (W)).  The JAX
module's ``note_dispatch`` (a jit cache's size watched after a dispatch)
has no cache to watch here and is left out.

Counting is always on (one dict update per build, never per row); with a
telemetry run active, a miss also bumps its ``recompiles`` counter and
emits a ``recompile`` event.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
_counts: Dict[Tuple[str, str], int] = {}


def record(fn_name: str, bucket, n: int = 1) -> None:
    """Record ``n`` known compiles directly (host-side program caches that
    are plain dicts, e.g. GBDT's fused-chunk cache)."""
    with _lock:
        key = (fn_name, str(bucket))
        _counts[key] = _counts.get(key, 0) + int(n)
    _mirror(fn_name, bucket, int(n))


def _mirror(fn_name: str, bucket, n: int) -> None:
    from . import active
    tele = active()
    if tele is not None:
        tele.counter("recompiles").inc(n)
        tele.event("recompile", fn=fn_name, bucket=str(bucket), n=n)


def counts() -> Dict[Tuple[str, str], int]:
    with _lock:
        return dict(_counts)


def total(fn_name: Optional[str] = None) -> int:
    with _lock:
        return sum(n for (f, _), n in _counts.items()
                   if fn_name is None or f == fn_name)


def reset() -> None:
    """Zero the counters: call after a warm-up to pin a steady-state loop
    at zero.  An active telemetry run's per-run baseline is re-zeroed so
    later misses still show in its summary."""
    with _lock:
        _counts.clear()
    from . import active
    tele = active()
    if tele is not None and hasattr(tele, "recompile_baseline"):
        tele.recompile_baseline = {}


def as_flat_dict() -> Dict[str, int]:
    """{"fn|bucket": n}, sorted: the summary JSON's form (recompile.py:
    103-106 of the JAX package), and the watchdog artifact's
    ``recompiles``."""
    with _lock:
        return {"%s|%s" % k: n for k, n in sorted(_counts.items())}
