"""Metrics registry and the JSONL event sink of a telemetry run.

The counterpart of ``lightgbm_tpu/obs/registry.py`` (:1-384) for the PyTorch
port (which imports nothing of the JAX package): counters, gauges and value
histograms (p50/p99 over a reservoir of at most ``HISTOGRAM_SAMPLE_CAP``
samples, Vitter's Algorithm R) live in a :class:`MetricsRegistry`;
structured events stream to a JSONL sink as they happen, and one
:class:`Telemetry` bundles both for a run.  Host Python only: nothing here
touches the device.

Zero calls when off: the instrumentation sites of the port gate on
``obs.active() is None`` first, so a run with no telemetry configured makes
no call into this module (pinned by ``tests/test_torch_telemetry.py``).

JSONL event schema (one JSON object per line), the JAX package's version 1::

    {"v": 1, "ts": <float unix seconds>, "kind": "<event kind>", ...fields}

``validate_event`` checks one decoded line; ``iter_events``/``read_events``
stream a file and drop a torn final line (a writer killed mid-event).
"""
from __future__ import annotations

import json
import math
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

EVENT_SCHEMA_VERSION = 1

# hard cap per histogram so a long run cannot grow host memory unboundedly;
# beyond it new observations fold into count/sum/min/max (plus a reservoir
# slot) only
HISTOGRAM_SAMPLE_CAP = 65536

# in-memory event mirror cap: the JSONL file is the durable record; the
# in-process buffer keeps only the newest events so a long-lived serving
# run cannot grow host memory unboundedly (event_count tracks the total)
EVENT_BUFFER_CAP = 65536


class Counter:
    """Monotonic counter; increments are lock-protected (embedding hosts
    drive prediction — and thus telemetry — from multiple threads)."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-value-wins scalar (a single attribute store: atomic under the
    GIL, no lock needed)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Value histogram with exact quantiles over a bounded sample buffer;
    observations are lock-protected (count/sum/samples must stay
    consistent under concurrent predict threads).

    Sample-buffer semantics past the cap: ``count``/``sum``/``min``/``max``
    stay exact for EVERY observation, while the quantile buffer holds a
    uniform reservoir (Vitter's Algorithm R) of ``HISTOGRAM_SAMPLE_CAP``
    samples — each of the run's N observations ends resident with equal
    probability cap/N, so ``p50``/``p99`` estimate the WHOLE run's
    distribution, not its first 65k observations (a long-lived serving
    process whose latency regime shifts after warmup keeps seeing the
    shift in its quantiles).  Pinned by
    tests/test_torch_obs_plane.py."""

    __slots__ = ("count", "sum", "min", "max", "_samples", "_lock")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: List[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._samples) < HISTOGRAM_SAMPLE_CAP:
                self._samples.append(v)
            else:
                # reservoir (Algorithm R): each observation keeps a
                # cap/count chance of residence, so long-run quantiles
                # describe the WHOLE run, not its first 65k samples
                j = random.randrange(self.count)
                if j < HISTOGRAM_SAMPLE_CAP:
                    self._samples[j] = v

    @staticmethod
    def _quantile_of(s: List[float], q: float) -> float:
        if not s:
            return float("nan")
        return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]

    def quantile(self, q: float) -> float:
        with self._lock:
            s = sorted(self._samples)
        return self._quantile_of(s, q)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            count, total = self.count, self.sum
            mn, mx = self.min, self.max
            s = sorted(self._samples)
        if count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "mean": total / count,
                "p50": self._quantile_of(s, 0.50),
                "p99": self._quantile_of(s, 0.99)}


class MetricsRegistry:
    """Name-keyed counters/gauges/histograms, created on first touch."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: {"counters": {...}, "gauges": {...},
        "histograms": {name: summary}}.  The lock covers the dict
        iteration (a concurrent first-touch of a new metric — e.g. a fresh
        predict bucket — must not break a mid-flight summary read)."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            histograms = sorted(self._histograms.items())
        return {
            "counters": {k: v.value for k, v in counters},
            "gauges": {k: v.value for k, v in gauges},
            "histograms": {k: v.summary() for k, v in histograms},
        }


def validate_event(obj: Dict[str, Any]) -> None:
    """Raise ``ValueError`` when ``obj`` is not a valid telemetry event."""
    if not isinstance(obj, dict):
        raise ValueError("event is not an object: %r" % (obj,))
    if obj.get("v") != EVENT_SCHEMA_VERSION:
        raise ValueError("event schema version %r (this build writes v%d)"
                         % (obj.get("v"), EVENT_SCHEMA_VERSION))
    if not isinstance(obj.get("ts"), (int, float)):
        raise ValueError("event missing numeric 'ts': %r" % (obj,))
    if not isinstance(obj.get("kind"), str) or not obj["kind"]:
        raise ValueError("event missing 'kind': %r" % (obj,))
    for k, v in obj.items():
        if not isinstance(v, (int, float, str, bool, type(None))):
            raise ValueError("event field %r is not a scalar: %r" % (k, v))


def iter_events(path: str):
    """Stream + schema-validate a telemetry JSONL file, one event at a
    time — O(1) memory, so a multi-GB died-run artifact never needs
    artifact-sized RAM.

    A torn FINAL line (the writer was killed mid-write — the artifact of a
    preempted run) is dropped with a warning instead of failing the read;
    corruption anywhere else still raises.  Streaming keeps that contract
    by holding each decode error back one line: if any later non-empty
    line exists the error was mid-file and raises, otherwise it was the
    torn tail and is dropped."""
    with open(path) as fh:
        pending: Optional[tuple] = None
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            if pending is not None:
                raise ValueError("%s line %d: %s"
                                 % (path, pending[0] + 1, pending[1]))
            try:
                obj = json.loads(line)
                validate_event(obj)
            except (json.JSONDecodeError, ValueError) as exc:
                pending = (i, exc)
                continue
            yield obj
        if pending is not None:
            from ..utils.log import Log
            Log.warning("%s: dropping torn final line (%s) — the "
                        "writer was likely killed mid-event",
                        path, pending[1])


def read_events(path: str) -> List[Dict[str, Any]]:
    """Load + schema-validate a telemetry JSONL file (the list form of
    :func:`iter_events`, same torn-final-line recovery)."""
    return list(iter_events(path))


def shard_path(out: str, rank: int) -> str:
    """Per-host JSONL sink path of pod rank ``rank`` for base path
    ``out`` — a merge of the shards globs these back together."""
    return "%s.rank%d.jsonl" % (out, int(rank))


class Telemetry:
    """One run's telemetry: a registry plus a JSONL event stream.

    ``out`` is the JSONL path (None buffers events in memory only — tests,
    embedding hosts); ``freq`` is the per-iteration event cadence consumers
    like engine.train honor (record every ``freq``-th iteration).

    ``rank`` is the pod process index (``obs.configure`` resolves it):
    when set, every event is stamped with it so shard sinks from several
    hosts can be merged into one causal pod view.  ``summary_base`` is the
    UNsharded output base the leader's ``<base>.summary.json`` is named
    from (equal to ``out`` outside pod mode).
    """

    def __init__(self, out: Optional[str] = None, freq: int = 1,
                 meta: Optional[Dict[str, Any]] = None,
                 rank: Optional[int] = None,
                 summary_base: Optional[str] = None) -> None:
        import collections
        import socket

        from ..utils.timer import global_timer
        self.registry = MetricsRegistry()
        self.out_path = out
        self.summary_base = summary_base if summary_base is not None else out
        self.rank = rank
        self.host = socket.gethostname()
        # run-level trace id: host-side spans (train_chunk, checkpoint
        # writes) parent under it; serving requests open their own traces
        self.trace_id = os.urandom(8).hex()
        # the live scrape listener (obs/exporter.py) owned by this run;
        # close() shuts it down with the run
        self.exporter = None
        # the model-quality monitor (obs/quality.py) owned by this run;
        # created lazily by quality.monitor(tele, create=True) — None on
        # runs that never serve/score traffic
        self.quality = None
        # run-owned state created on first use by its module: compile
        # accounting (obs/compile.py), device-memory tracking
        # (obs/devmem.py), profiler captures (obs/profiling.py) and the
        # live alert engine (obs/alerts.py, the one with a thread: close()
        # stops it with the run)
        self.compile_acct = None
        self.devmem = None
        self.profiling = None
        self.alerts = None
        self.freq = max(int(freq), 1)
        # newest-EVENT_BUFFER_CAP mirror of the JSONL stream (the file is
        # the durable record); event_count is the total ever recorded
        self.events: "collections.deque" = collections.deque(
            maxlen=EVENT_BUFFER_CAP)
        self.event_count = 0
        self._lock = threading.Lock()
        # line-buffered: events are chunk-granularity, and a killed or
        # preempted run must leave its tail events on disk for
        # the died-run recovery path
        self._fh = open(out, "w", buffering=1) if out else None
        self.started_at = time.time()
        # global_timer and the recompile counters accumulate for the whole
        # process; snapshotting both here lets report.summarize attribute
        # only THIS run's scope time and cache misses
        self.timer_baseline = global_timer.totals()
        from . import launches as _launches
        from . import recompile as _recompile
        self.recompile_baseline = _recompile.counts()
        self.launch_baseline = _launches.counts()
        self.launch_tree_baseline = _launches.trees()
        self.event("run_start", **(meta or {}))

    # ---- metrics passthrough ----

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    # ---- events ----

    def event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        obj = {"v": EVENT_SCHEMA_VERSION, "ts": time.time(), "kind": kind}
        if self.rank is not None:
            # pod runs stamp every event with the writing host's rank so a
            # merged view keeps per-host attribution
            obj["rank"] = self.rank
        obj.update(fields)
        # serialize OUTSIDE the lock (concurrent predict threads should
        # contend only on the append + ordered write, not on json.dumps)
        line = (json.dumps(obj, separators=(",", ":"), default=str) + "\n"
                if self._fh is not None else None)
        with self._lock:
            self.events.append(obj)
            self.event_count += 1
            if self._fh is not None and line is not None:
                self._fh.write(line)
        return obj

    @contextmanager
    def time_block(self, name: str, **fields: Any):
        """Time a host block: observes ``<name>_s`` and emits a ``<name>``
        event carrying ``dt_s`` (feeds the Chrome-trace renderer)."""
        t0 = time.perf_counter()
        ts0 = time.time()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.histogram(name + "_s").observe(dt)
            self.event(name, dt_s=dt, t0=ts0, **fields)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        # the exporter and alert-engine threads are stopped OUTSIDE the
        # event lock (an in-flight handler or tick may be reading a
        # snapshot, or emitting an event, that briefly takes it)
        exp, self.exporter = self.exporter, None
        if exp is not None:
            exp.stop()
        eng, self.alerts = self.alerts, None
        if eng is not None:
            eng.stop()
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
