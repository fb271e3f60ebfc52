"""Compile accounting: wall-seconds per (function, bucket) miss.

The counterpart of ``lightgbm_tpu/obs/compile.py`` (:1-206).  ``obs
.recompile`` counts the port's misses (a predictor stacked for a new key, the
kernel libraries built); this module prices them.  A miss-bearing dispatch
is held pending until its key sees a clean dispatch; the pending wall minus
the key's steady median is the miss's cost.  Keys that never go steady
resolve at snapshot time with the full wall as an upper bound
(``resolved: false``).

What a price means in the port (there is no XLA compile to time):

- ``predict_stack`` keys: the first call of a newly stacked predictor
  carries the stacking seconds (host arrays built and copied to the device)
  on top of its own call; later calls are the steady walls;
- ``kernels|nvcc``: the seconds ``kernels/__init__.py`` spent building and
  loading the CUDA libraries (``build_seconds``), noted once, never steady,
  so it stays unresolved at its full wall.

A miss whose excess is at or under ``warm_load_max_s`` counts as a warm
load (a copy, not a build), as the JAX module counts a persistent-cache
load.  Run-owned: the accountant lives on the active telemetry run
(``tele.compile_acct``) and every site gates on ``obs.active() is None``
first; each miss also emits a ``kind="compile"`` event.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

# a miss whose excess wall over the steady median is at or under this is a
# persistent-cache warm load (executable deserialization), not a compile
WARM_LOAD_MAX_S = 0.05
# steady-state dispatch walls kept per key for the median estimate
STEADY_SAMPLE_CAP = 128


def _median(vals) -> float:
    s = sorted(vals)
    n = len(s)
    if n % 2:
        return float(s[n // 2])
    return float(s[n // 2 - 1] + s[n // 2]) / 2.0


class _KeyState:
    __slots__ = ("steady", "pending", "compiles", "warm_loads",
                 "compile_s", "first_dispatch_s")

    def __init__(self) -> None:
        # recent clean dispatch walls (median = the steady estimate)
        self.steady: "deque" = deque(maxlen=STEADY_SAMPLE_CAP)
        # miss-bearing dispatch walls awaiting a steady baseline: (wall, n)
        self.pending: list = []
        self.compiles = 0
        self.warm_loads = 0
        self.compile_s = 0.0
        self.first_dispatch_s: Optional[float] = None


class CompileAccounting:
    """Per-(function, shape-bucket) compile wall-seconds for one run."""

    def __init__(self, warm_load_max_s: float = WARM_LOAD_MAX_S) -> None:
        self.warm_load_max_s = float(warm_load_max_s)
        self._keys: Dict[tuple, _KeyState] = {}
        self._lock = threading.Lock()

    def note(self, tele, fn: str, bucket, dispatch_s: float,
             misses: int) -> None:
        """Record one dispatch of ``(fn, bucket)``: its host wall and how
        many jit cache misses it carried (0 = clean/steady).  Called at
        dispatch granularity from sites that are already telemetry-gated,
        never per row."""
        key = (str(fn), str(bucket))
        dispatch_s = float(dispatch_s)
        resolved = []
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyState()
            if st.first_dispatch_s is None:
                st.first_dispatch_s = dispatch_s
            if misses > 0:
                st.pending.append((dispatch_s, int(misses)))
            else:
                st.steady.append(dispatch_s)
                if st.pending:
                    resolved = self._resolve_locked(st)
        if misses > 0 and tele is not None:
            # the JSONL breadcrumb a died run is recovered from: the raw
            # dispatch wall (recovery cannot subtract a steady state that
            # may never have existed)
            tele.counter("compiles_noted").inc(int(misses))
            tele.event("compile", fn=str(fn), bucket=str(bucket),
                       n=int(misses), dispatch_s=dispatch_s)
        for comp_s, _n, warm in resolved:
            if tele is not None and not warm:
                # true compiles only: a warm load's ~ms excess would drag
                # the compile-cost quantiles toward zero
                tele.histogram("compile_s").observe(comp_s)

    def _resolve_locked(self, st: _KeyState):
        """Price every pending miss of ``st`` against its steady median;
        returns [(compile_s, n, warm)] for the caller to surface outside
        the lock."""
        steady = _median(st.steady)
        out = []
        for wall, n in st.pending:
            comp_s = max(wall - steady, 0.0)
            warm = comp_s <= self.warm_load_max_s
            if warm:
                st.warm_loads += n
            else:
                st.compiles += n
                st.compile_s += comp_s
            out.append((comp_s, n, warm))
        st.pending = []
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The summary/exposition view.  Pending misses on keys that never
        went steady are priced at their FULL dispatch wall (an upper
        bound) and flagged unresolved — honest for died runs and
        single-dispatch shapes."""
        with self._lock:
            keys_out = {}
            total_s = 0.0
            total_compiles = 0
            total_warm = 0
            unresolved = 0
            for (fn, bucket), st in sorted(self._keys.items()):
                comp_s = st.compile_s
                compiles = st.compiles
                warm = st.warm_loads
                pend_s = sum(w for w, _ in st.pending)
                pend_n = sum(n for _, n in st.pending)
                if pend_n:
                    # no steady baseline yet: the whole wall is the bound
                    comp_s += pend_s
                    compiles += pend_n
                    unresolved += pend_n
                entry = {
                    "compiles": compiles,
                    "warm_loads": warm,
                    "compile_s": round(comp_s, 6),
                    "first_dispatch_s": (round(st.first_dispatch_s, 6)
                                         if st.first_dispatch_s is not None
                                         else None),
                    "steady_p50_s": (round(_median(st.steady), 6)
                                     if st.steady else None),
                    "steady_n": len(st.steady),
                }
                if pend_n:
                    entry["unresolved"] = pend_n
                keys_out["%s|%s" % (fn, bucket)] = entry
                total_s += comp_s
                total_compiles += compiles
                total_warm += warm
        if not keys_out:
            return {}
        return {"compile_seconds_total": round(total_s, 6),
                "compiles": total_compiles,
                "warm_loads": total_warm,
                "unresolved": unresolved,
                "keys": keys_out}


def accountant(tele, create: bool = False) -> Optional[CompileAccounting]:
    """The compile accountant of run ``tele`` (None when the run is None,
    or has none and ``create`` is False).  Lives on the run; dies with
    it."""
    if tele is None:
        return None
    acct = getattr(tele, "compile_acct", None)
    if acct is None and create:
        with _create_lock:
            acct = getattr(tele, "compile_acct", None)
            if acct is None:
                acct = tele.compile_acct = CompileAccounting()
    return acct


_create_lock = threading.Lock()


def note_dispatch(tele, fn: str, bucket, dispatch_s: float,
                  misses: int) -> None:
    """Site-facing helper: create-on-first-use + note.  Callers are
    REQUIRED to gate on ``tele is not None`` first (the zero-overhead-off
    contract lives at the site, like every obs hook)."""
    acct = accountant(tele, create=True)
    if acct is not None:
        acct.note(tele, fn, bucket, dispatch_s, misses)
