"""Live SLO alerting: declarative rules and burn-rate windows over the run.

The counterpart of ``lightgbm_tpu/obs/alerts.py`` (:1-407), pure host
Python, the same rules, window math and transitions.  Rules live in a JSON
file (``alert_rules=<path>``: a bare list, or a dict carrying an
``"alerts"`` list, the ``PERF_BUDGETS.json`` shape) and are evaluated
against the live :class:`~.registry.MetricsRegistry` snapshot every
``alert_interval_s`` by a daemon thread:

- each rule is judged over a FAST and a SLOW window and fires only when
  both burn at or above ``burn_threshold``;
- ``quantile``/``gauge`` rules sample the watched value each tick and judge
  the breach fraction of each window against ``budget`` (the allowed bad
  fraction; 0 = any breach burns at the cap); ``rate`` rules judge a
  counter's windowed per-second rate against ``max_per_s``; burns are
  clamped to :data:`BURN_CAP`;
- surfacing: ``GET /alerts`` on the exporter, ``kind="alert"`` events on
  every transition, the ``alerts_fired`` counter, the
  ``alert_firing_<rule>`` gauges and ``lgbm_tpu_alert_state`` on
  /metrics, the summary's ``alerts`` block, and the flight recorder
  (:func:`~.profiling.on_incident`) on the first firing.

Rule kinds (windows and thresholds optional)::

    {"name": "serve_p99", "kind": "quantile",
     "metric": "serve_latency_s_model_*", "quantile": "p99", "max": 0.5,
     "budget": 0.1, "fast_window_s": 60, "slow_window_s": 300,
     "burn_threshold": 1.0, "severity": "page"}
    {"name": "reject_rate", "kind": "rate", "counter": "serve_rejected",
     "max_per_s": 0.0}
    {"name": "queue", "kind": "gauge", "gauge": "serve_queue_depth",
     "max": 512}

A quantile rule watches the run-cumulative reservoir of a histogram
(``obs/registry.py``): it asks "is the run's p99 breaching now", and a
series with no new observations since the last tick adds no sample, so an
idle series neither re-fires nor holds a stale alert open.

Run-owned: the engine thread exists only on a run that installed one
(``tele.alerts``); ``Telemetry.close()`` stops it.  The window math
(:func:`breach_fraction`, :func:`burn_rate`, :func:`window_rate`) is
exposed for the goldens of tests/test_torch_forensics.py.
"""
from __future__ import annotations

import fnmatch
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils.log import Log

DEFAULT_INTERVAL_S = 1.0
DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 300.0
DEFAULT_BURN_THRESHOLD = 1.0
# burns are clamped finite so /alerts JSON and telemetry events stay
# strictly valid (a zero budget would otherwise emit Infinity)
BURN_CAP = 1e6

_KINDS = ("quantile", "rate", "gauge")


# ---- pure window math (hand-computed goldens live on these) ----

def breach_fraction(samples, now: float, window_s: float) -> Optional[float]:
    """Fraction of ``(ts, bad)`` samples with ``ts > now - window_s`` that
    are bad; None when the window holds no samples."""
    n = bad = 0
    lo = now - float(window_s)
    for ts, is_bad in samples:
        if ts > lo:
            n += 1
            if is_bad:
                bad += 1
    return (bad / n) if n else None


def burn_rate(fraction: Optional[float], budget: float) -> Optional[float]:
    """Observed bad fraction over the allowed fraction, clamped to
    :data:`BURN_CAP`; a zero budget burns at the cap the moment anything
    is bad.  None passes through (no data = no verdict)."""
    if fraction is None:
        return None
    if budget > 0:
        return min(fraction / budget, BURN_CAP)
    return BURN_CAP if fraction > 0 else 0.0


def window_rate(points, now: float, window_s: float) -> float:
    """Per-second rate of a cumulative counter over the window: the
    latest point minus the window's baseline (the newest point at or
    before the window start, else the oldest in-window point) over their
    time span.  0.0 with fewer than two points."""
    lo = now - float(window_s)
    base = None
    last = None
    for ts, c in points:
        if ts <= lo:
            base = (ts, c)
        else:
            if base is None:
                base = (ts, c)
            last = (ts, c)
    if base is None or last is None or last[0] <= base[0]:
        return 0.0
    return max(float(last[1]) - float(base[1]), 0.0) / (last[0] - base[0])


# ---- rules ----

def load_rules(path: str) -> List[Dict[str, Any]]:
    """Rules from a JSON file: either a bare list or a dict carrying an
    ``"alerts"`` list (the PERF_BUDGETS.json shape).  Unknown kinds are
    dropped with a warning, never an error — a typo in one rule must not
    take live alerting down with it."""
    with open(path) as fh:
        doc = json.load(fh)
    raw = doc.get("alerts", []) if isinstance(doc, dict) else doc
    rules = []
    for r in raw or []:
        if not isinstance(r, dict) or not r.get("name"):
            Log.warning("alert rule without a name dropped: %r", r)
            continue
        if r.get("kind") not in _KINDS:
            Log.warning("alert rule %r has unknown kind %r (expected %s); "
                        "dropped", r.get("name"), r.get("kind"),
                        "/".join(_KINDS))
            continue
        rules.append(dict(r))
    return rules


class AlertEngine:
    """Periodic rule evaluation over one run's registry snapshot.

    ``clock`` is injectable (tests drive :meth:`tick` with hand times);
    the background thread only exists after :meth:`start`."""

    def __init__(self, tele, rules: List[Dict[str, Any]],
                 interval_s: float = DEFAULT_INTERVAL_S,
                 clock=time.monotonic) -> None:
        self.tele = tele
        self.rules = list(rules)
        self.interval_s = max(float(interval_s), 0.05)
        self.clock = clock
        self.fired_total = 0
        self.external: Dict[str, int] = {}
        self._series: Dict[tuple, deque] = {}
        self._state: Dict[tuple, Dict[str, Any]] = {}
        # per-quantile-series histogram count at the last tick: a series
        # with no NEW observations contributes no new window sample (the
        # cumulative quantile would otherwise re-assert stale state
        # forever — see the module docstring caveat)
        self._last_counts: Dict[tuple, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----

    def start(self) -> "AlertEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="lgbm-tpu-torch-alerts")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:  # the engine must never kill the run
                Log.warning("alert evaluation failed: %s: %s",
                            type(exc).__name__, exc)

    # ---- evaluation ----

    def _windows(self, rule) -> tuple:
        return (float(rule.get("fast_window_s", DEFAULT_FAST_WINDOW_S)),
                float(rule.get("slow_window_s", DEFAULT_SLOW_WINDOW_S)))

    def _match(self, pattern: str, names) -> List[str]:
        if any(ch in pattern for ch in "*?["):
            return sorted(fnmatch.filter(names, pattern))
        return [pattern] if pattern in names else []

    def tick(self, now: Optional[float] = None) -> None:
        """One evaluation pass (the thread calls this every interval;
        tests call it directly with a pinned ``now``)."""
        now = self.clock() if now is None else float(now)
        snap = self.tele.registry.snapshot()
        for i, rule in enumerate(self.rules):
            kind = rule["kind"]
            fast_w, slow_w = self._windows(rule)
            keep_s = max(fast_w, slow_w) * 1.25
            if kind == "quantile":
                hists = snap.get("histograms", {})
                for name in self._match(rule.get("metric", ""), hists):
                    h = hists[name]
                    if not h.get("count"):
                        continue
                    val = h.get(rule.get("quantile", "p99"))
                    if val is None:
                        continue
                    with self._lock:
                        last = self._last_counts.get((i, name))
                        self._last_counts[(i, name)] = h["count"]
                    self._judge_fraction(rule, i, name, float(val), now,
                                         fast_w, slow_w, keep_s,
                                         append=last != h["count"])
            elif kind == "gauge":
                gauges = snap.get("gauges", {})
                for name in self._match(rule.get("gauge", ""), gauges):
                    val = gauges[name]
                    if val is None:
                        continue
                    self._judge_fraction(rule, i, name, float(val), now,
                                         fast_w, slow_w, keep_s)
            elif kind == "rate":
                counters = snap.get("counters", {})
                for name in self._match(rule.get("counter", ""), counters):
                    self._judge_rate(rule, i, name, float(counters[name]),
                                     now, fast_w, slow_w, keep_s)

    def _samples(self, key, now: float, keep_s: float) -> deque:
        dq = self._series.get(key)
        if dq is None:
            dq = self._series[key] = deque()
        lo = now - keep_s
        while dq and dq[0][0] <= lo:
            dq.popleft()
        return dq

    def _judge_fraction(self, rule, i, series, value: float, now,
                        fast_w, slow_w, keep_s, append: bool = True) -> None:
        bad = value > float(rule.get("max", float("inf")))
        with self._lock:
            dq = self._samples((i, series), now, keep_s)
            if append:
                dq.append((now, bad))
            samples = list(dq)
        budget = float(rule.get("budget", 0.0))
        fast = burn_rate(breach_fraction(samples, now, fast_w), budget)
        slow = burn_rate(breach_fraction(samples, now, slow_w), budget)
        self._transition(rule, i, series, value, fast, slow, now)

    def _judge_rate(self, rule, i, series, cum: float, now,
                    fast_w, slow_w, keep_s) -> None:
        with self._lock:
            dq = self._samples((i, series), now, keep_s)
            dq.append((now, cum))
            points = list(dq)
        max_per_s = float(rule.get("max_per_s", 0.0))
        fast_r = window_rate(points, now, fast_w)
        slow_r = window_rate(points, now, slow_w)

        def burn(rate):
            if max_per_s > 0:
                return min(rate / max_per_s, BURN_CAP)
            return BURN_CAP if rate > 0 else 0.0
        self._transition(rule, i, series, fast_r, burn(fast_r),
                         burn(slow_r), now)

    def _transition(self, rule, i, series, value, fast, slow, now) -> None:
        threshold = float(rule.get("burn_threshold",
                                   DEFAULT_BURN_THRESHOLD))
        firing = (fast is not None and slow is not None
                  and fast >= threshold and slow >= threshold)
        key = (i, series)
        with self._lock:
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = {"rule": rule["name"],
                                         "series": series, "state": "ok",
                                         "since": now}
            was = st["state"]
            st.update(value=round(float(value), 6),
                      fast_burn=None if fast is None else round(fast, 4),
                      slow_burn=None if slow is None else round(slow, 4),
                      severity=rule.get("severity", "warn"), ts=now)
            if firing and was != "firing":
                st["state"] = "firing"
                st["since"] = now
                self.fired_total += 1
            elif not firing and was == "firing":
                st["state"] = "ok"
                st["since"] = now
            changed = st["state"] != was
            new_state = st["state"]
        if not changed:
            return
        tele = self.tele
        if new_state == "firing":
            tele.counter("alerts_fired").inc()
            tele.gauge("alert_firing_%s" % rule["name"]).set(1.0)
            tele.event("alert", rule=rule["name"], series=series,
                       state="firing", value=float(value),
                       fast_burn=fast, slow_burn=slow,
                       severity=rule.get("severity", "warn"))
            Log.warning("ALERT %s firing on %s (value=%.6g, burn "
                        "fast=%.3g slow=%.3g)", rule["name"], series,
                        value, fast, slow)
            if rule.get("capture", True):
                # the flight recorder decides whether anything happens
                # (armed, once per run, never recursive)
                from . import profiling
                profiling.on_incident("alert_%s" % rule["name"])
        else:
            tele.gauge("alert_firing_%s" % rule["name"]).set(0.0)
            tele.event("alert", rule=rule["name"], series=series,
                       state="resolved", value=float(value))
            Log.warning("ALERT %s resolved on %s", rule["name"], series)

    # ---- surfacing ----

    def note_external(self, name: str) -> None:
        """Fold an out-of-band incident (watchdog stall) into the fired
        tally so ``/alerts`` and the summary agree with the event
        stream."""
        with self._lock:
            self.fired_total += 1
            self.external[name] = self.external.get(name, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            states = [dict(st) for _, st in sorted(self._state.items())]
            external = dict(self.external)
            fired = self.fired_total
        firing = sum(1 for st in states if st["state"] == "firing")
        return {"enabled": True, "interval_s": self.interval_s,
                "rules": len(self.rules), "series": states,
                "firing": firing, "fired_total": fired,
                **({"external": external} if external else {})}


def engine(tele) -> Optional[AlertEngine]:
    """The alert engine of run ``tele`` (None when none installed)."""
    return getattr(tele, "alerts", None) if tele is not None else None


def install(tele, rules_path: Optional[str] = None,
            rules: Optional[List[Dict[str, Any]]] = None,
            interval_s: float = DEFAULT_INTERVAL_S,
            start: bool = True) -> Optional[AlertEngine]:
    """Install (and by default start) an alert engine on the run; returns
    it, or None when the rules file is unreadable/empty (warned, never
    fatal — a missing rules file must not take training down)."""
    if tele is None:
        return None
    if rules is None:
        try:
            rules = load_rules(rules_path)
        except (OSError, ValueError, TypeError) as exc:
            Log.warning("alert_rules %r unreadable (%s); live alerting "
                        "disabled for this run", rules_path, exc)
            return None
    if not rules:
        Log.warning("alert_rules %r carries no usable rules; live "
                    "alerting disabled for this run", rules_path)
        return None
    eng = AlertEngine(tele, rules, interval_s=interval_s)
    tele.alerts = eng
    if start:
        eng.start()
    Log.info("alert engine armed: %d rule(s), eval every %.2gs",
             len(rules), eng.interval_s)
    return eng


def note_incident(tele, name: str, severity: str = "page",
                  **fields: Any) -> None:
    """Emit a firing ``kind="alert"`` event for an out-of-band incident
    (the watchdog calls this on a stall) and fold it into the engine's
    tally when one is installed.  Callers gate on ``tele is not None``."""
    tele.counter("alerts_fired").inc()
    tele.event("alert", rule=str(name), state="firing",
               severity=str(severity), **fields)
    eng = engine(tele)
    if eng is not None:
        eng.note_external(str(name))
