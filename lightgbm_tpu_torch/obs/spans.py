"""Request-scoped spans: per-request and per-tree causality of a run.

The counterpart of ``lightgbm_tpu/obs/spans.py`` (:1-137).  A span is one
timed operation inside a trace (one request, one training run): a
``kind="span"`` telemetry event whose fields are all scalars, so it rides
the ordinary JSONL schema::

    {"v": 1, "ts": ..., "kind": "span", "name": "queue_wait",
     "trace_id": "9f..", "span_id": "04..", "parent_id": "c1..",
     "t0": <unix s start>, "dur_s": <seconds>, ...extra scalars}

:func:`span` brackets its own work (tree builds; parents propagate through a
thread-local stack); :func:`record_span` emits a span whose timing is known
only afterwards (the serving scheduler's queue wait, a checkpoint write).
With no telemetry run active, :func:`span` returns a shared ``nullcontext``
(no Span object, no id), and the sites guard :func:`record_span` behind
their own ``obs.active() is None`` check.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Optional

_NULL = contextlib.nullcontext()
_tls = threading.local()

_active_fn = None


def _active():
    # late-bound to dodge the package-import cycle (obs/__init__ imports
    # this module); one global read + call once bound
    global _active_fn
    if _active_fn is None:
        from . import active as fn
        _active_fn = fn
    return _active_fn()


def new_id() -> str:
    """A fresh 64-bit hex id (trace or span)."""
    return os.urandom(8).hex()


def current() -> Optional["Span"]:
    """The innermost open span on THIS thread (None outside any span)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class Span:
    """One open span; use via :func:`span` (context manager)."""

    __slots__ = ("tele", "name", "trace_id", "span_id", "parent_id",
                 "fields", "t0", "_pc0")

    def __init__(self, tele, name: str, trace_id: Optional[str],
                 parent_id: Optional[str], fields) -> None:
        self.tele = tele
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_id()
        self.parent_id = parent_id
        self.fields = fields
        self.t0 = 0.0
        self._pc0 = 0.0

    def __enter__(self) -> "Span":
        parent = current()
        if self.trace_id is None:
            if parent is not None:
                self.trace_id = parent.trace_id
                if self.parent_id is None:
                    self.parent_id = parent.span_id
            else:
                self.trace_id = getattr(self.tele, "trace_id", None) \
                    or new_id()
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        self.t0 = time.time()
        self._pc0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self._pc0
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        self.tele.event("span", name=self.name, trace_id=self.trace_id,
                        span_id=self.span_id, parent_id=self.parent_id,
                        t0=self.t0, dur_s=dur, **self.fields)


def span(name: str, **fields: Any):
    """Bracket a timed operation as a span of the active run's trace; a
    shared no-op when telemetry is off (zero allocations)."""
    tele = _active()
    if tele is None:
        return _NULL
    return Span(tele, name, None, None, fields)


def record_span(tele, name: str, t0: float, dur_s: float,
                trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                span_id: Optional[str] = None, **fields: Any) -> str:
    """Emit one already-measured span on ``tele``; returns its span id so
    the caller can parent further spans under it.  ``t0`` is the unix-time
    start, ``dur_s`` the measured duration."""
    sid = span_id or new_id()
    tele.event("span", name=name,
               trace_id=trace_id or getattr(tele, "trace_id", None)
               or new_id(),
               span_id=sid, parent_id=parent_id, t0=float(t0),
               dur_s=float(dur_s), **fields)
    return sid
