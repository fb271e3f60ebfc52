"""Spans: the timed layers of a run, on the profiler's clock.

The counterpart of ``lightgbm_tpu/obs/spans.py`` (:1-137).  A span is one
timed operation: a tree build, the objective, a split scan, a stall poll.
It stamps its start and end with ``time.time_ns()``, the clock
``torch.profiler`` (kineto) stamps host events and CUPTI's device activity
with, so a span can be laid over a device trace as it is.  Spans nest per
thread (a thread-local stack).  A closed span goes to two sinks:

- the active telemetry run, as a ``kind="span"`` event whose fields are
  all scalars, so it rides the ordinary JSONL schema::

    {"v": 1, "ts": ..., "kind": "span", "name": "tree_build",
     "trace_id": "9f..", "span_id": "04..", "parent_id": "c1..",
     "t0": <unix s start>, "dur_s": <seconds>, ...extra scalars}

  ``t0`` and ``dur_s`` both come from the two ``time_ns`` stamps;
- an open :func:`collect`, as a :class:`SpanRecord`.  While a collector is
  open each span also opens a named profiler range
  (:func:`obs.trace.annotate`), so a profiler window names the layer the
  host was in.

:func:`span` brackets a site of tree granularity or coarser, and reaches
both sinks; :func:`step` brackets a site that runs once a split (the split
scan, the split pass: 254 of each in a leaf-wise tree of 255 leaves), and
reaches the collector alone, so a telemetry stream keeps its size.  With
neither sink, :func:`span` returns the shared ``nullcontext`` (one global
read and a ``None`` check; no Span object), or, for a site that feeds a
``global_timer`` scope (``timer=``, the LightGBM names ``GBDT::Boosting``,
``TreeLearner::Train``, ``GBDT::UpdateScore``), that scope: the span takes
the scope's place and feeds it always.  :func:`record_span` emits a span
whose timing is known only afterwards (the serving scheduler's queue wait,
a checkpoint write, a fused chunk).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Any, List, NamedTuple, Optional

from ..utils.timer import FunctionTimer, global_timer
from .trace import annotate

_NULL = contextlib.nullcontext()
_tls = threading.local()
_seq = itertools.count()

# the sinks: the active telemetry run (mirrored by obs.configure/disable),
# the open collector's list, and ``_sink``, True while either is set, the
# one global a span site reads
_tele = None
_collector: Optional[List["SpanRecord"]] = None
_sink: Optional[bool] = None


class SpanRecord(NamedTuple):
    """One span closed while a collector was open: its name, its start and
    end (``time.time_ns()``, the profiler's clock), the ``seq`` of the span
    it opened inside (None at the top), the native id of its thread (the
    id the profiler gives a host event) and its own ``seq`` (the order the
    spans opened in)."""
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    thread: int
    seq: int


def _refresh() -> None:
    global _sink
    _sink = True if (_tele is not None or _collector is not None) else None


def set_telemetry(tele) -> None:
    """The telemetry run spans report to (``obs.configure`` and
    ``obs.disable`` call this; None: no run)."""
    global _tele
    _tele = tele
    _refresh()


@contextlib.contextmanager
def collect():
    """Keep every span closed while open (on any thread), each also a
    named profiler range; yields the list of :class:`SpanRecord`, complete
    when the block ends.  Collectors do not nest."""
    global _collector
    if _collector is not None:
        raise RuntimeError("a span collector is already open")
    out: List[SpanRecord] = []
    _collector = out
    _refresh()
    try:
        yield out
    finally:
        _collector = None
        _refresh()


def new_id() -> str:
    """A fresh 64-bit hex id (trace or span)."""
    return os.urandom(8).hex()


def current() -> Optional["Span"]:
    """The innermost open span on THIS thread (None outside any span)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


_timed = {}


def _scope(timer: str) -> FunctionTimer:
    t = _timed.get(timer)
    if t is None:
        t = _timed[timer] = FunctionTimer(timer)
    return t


class Span:
    """One open span; use via :func:`span` or :func:`step`.  Entering
    returns it; ``fields`` may be added to until it closes."""

    __slots__ = ("name", "timer", "fields", "tele", "trace_id", "span_id",
                 "parent", "seq", "t0_ns", "epoch", "_range")

    def __init__(self, name: str, timer: Optional[str], fields,
                 tele) -> None:
        self.name = name
        self.timer = timer
        self.fields = fields
        self.tele = tele
        self.trace_id = self.span_id = None
        self.parent: Optional[Span] = None
        self.seq = 0
        self.t0_ns = 0
        self.epoch = 0
        self._range = None

    def _telemetry_parent(self) -> Optional["Span"]:
        p = self.parent
        while p is not None and p.span_id is None:
            p = p.parent
        return p

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.seq = next(_seq)
        if self.tele is not None:
            self.span_id = new_id()
            p = self._telemetry_parent()
            self.trace_id = (p.trace_id if p is not None else
                             getattr(self.tele, "trace_id", None) or new_id())
        if self.timer is not None:
            self.epoch = global_timer.epoch
        self.t0_ns = time.time_ns()
        if _collector is not None:
            self._range = annotate(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        t1 = time.time_ns()
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        dur = (t1 - self.t0_ns) * 1e-9
        if self.timer is not None:
            global_timer.add(self.timer, dur, self.epoch)
        out = _collector
        if out is not None:
            parent = self.parent
            out.append(SpanRecord(self.name, self.t0_ns, t1,
                                  None if parent is None else parent.seq,
                                  threading.get_native_id(), self.seq))
        if self.tele is not None:
            p = self._telemetry_parent()
            self.tele.event("span", name=self.name, trace_id=self.trace_id,
                            span_id=self.span_id,
                            parent_id=None if p is None else p.span_id,
                            t0=self.t0_ns * 1e-9, dur_s=dur, **self.fields)
        return False


def span(name: str, timer: Optional[str] = None, **fields: Any):
    """Bracket a timed operation as a span (``with span(...) as s``: a
    :class:`Span` while a sink is active).  ``timer`` names the
    ``global_timer`` scope the span feeds, with or without a sink."""
    if _sink is None:
        return _NULL if timer is None else _scope(timer)
    return Span(name, timer, fields, _tele)


def step(name: str):
    """Bracket a per-split operation: a span for the collector alone (the
    shared ``nullcontext`` while none is open)."""
    if _collector is None:
        return _NULL
    return Span(name, None, None, None)


def spanned(name: str):
    """Decorate a function whose every call is a :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


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
