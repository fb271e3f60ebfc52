"""Live metrics and health endpoints: the scrape surface of a telemetry run.

The counterpart of ``lightgbm_tpu/obs/exporter.py`` (:1-504): a stdlib
``http.server`` thread serves the active run live.  ``http.server`` itself
is imported only when a :class:`MetricsExporter` starts (``obs.configure``
with ``metrics_port``), so a process that never serves a port never
imports it (the serving ``Server`` imports this module for its health
provider registry alone).

- ``GET /metrics``: Prometheus text exposition of the run's registry plus
  the always-on process counters (misses per (function, bucket), split
  passes per growth mode, I/O retries, host RSS), the quality plane's
  per-model gauges, compile accounting, the card's memory and the serving
  registry's residency;
- ``GET /healthz``: liveness JSON from the port's ``resilience`` module
  (preemption flag: ``draining``; watchdog: ``stalled`` and HTTP 503 once
  it fired), the serving tier's queue depth and the age of the last
  checkpoint write;
- ``GET /summary.json``: what ``report.finalize_run`` would write now;
- ``GET /alerts``: the alert engine's live state (``obs/alerts.py``;
  ``{"enabled": false, ...}`` on a run without one);
- ``GET /debug/profile?seconds=N``: one bounded ``torch.profiler`` capture
  into the run's profile directory (``obs/profiling.py``): 200 with its
  metadata, 409 while another capture or profiler runs, 400 for a bad
  ``seconds``.

``/metrics`` also carries ``plan_cache_fallbacks_total`` (the kernel
planner's always-on counter, ``plan/cache.py``) and one
``alert_state{rule,series}`` gauge per series of the alert engine.
``port=0`` binds an ephemeral port (the bound one is on ``self.port``).
"""
from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils.log import Log

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "lgbm_tpu_"

# name -> zero-arg callable returning a small scalar dict folded into
# /healthz; the serving tier registers its queue/inflight counts here.
# Registration is a constructor-time dict write (never hot-path work).
_providers: Dict[str, Callable[[], Dict[str, Any]]] = {}
_plock = threading.Lock()


def register_health_provider(name: str,
                             fn: Callable[[], Dict[str, Any]]) -> str:
    """Register ``fn`` under ``name`` and return the key actually used:
    a second registrant of the same name gets ``name#2`` (two Servers in
    one process must both stay visible on /healthz, not evict each
    other).  Unregister with the RETURNED key."""
    with _plock:
        key, n = name, 1
        while key in _providers:
            n += 1
            key = "%s#%d" % (name, n)
        _providers[key] = fn
    return key


def unregister_health_provider(name: str, fn=None) -> None:
    """Remove ``name``'s provider; when ``fn`` is given, only if it is
    still the registered one (a newer registrant must not be torn down by
    a stale owner's close).  Equality, not identity: bound methods are
    fresh objects per attribute access."""
    with _plock:
        if fn is None or _providers.get(name) == fn:
            _providers.pop(name, None)


def _prom_name(name: str) -> str:
    return _PREFIX + _PROM_BAD.sub("_", str(name))


def _prom_val(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def _esc_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def render_prometheus(snapshot: Dict[str, Any],
                      run_recompiles: Optional[int] = None,
                      quality: Optional[Dict[str, Any]] = None,
                      compile_acct: Optional[Dict[str, Any]] = None,
                      devmem_stats=None,
                      residency: Optional[Dict[str, Any]] = None,
                      alerts: Optional[Dict[str, Any]] = None) -> str:
    """Registry snapshot -> Prometheus text exposition (0.0.4).

    Counters render as ``counter``, gauges as ``gauge``, histograms as
    ``summary`` (p50/p99 quantile samples + ``_sum``/``_count``).  The
    always-on process counters ride along with labels; ``run_recompiles``
    (jit cache misses SINCE the active run's baseline) is the live form of
    the steady-state no-recompile invariant — 0 on a healthy serving
    process.  ``quality`` is a ``QualityMonitor.snapshot()``: per-model
    drift PSI per feature (already top-K bounded by the monitor, so a
    wide-F model cannot blow up the exposition), score PSI, generation and
    freshness — the model-quality plane's labeled gauges.

    Blocks rendered only when their source exists: ``compile_acct`` (an
    ``obs.compile`` snapshot: miss seconds per (fn, bucket) plus warm-load
    counts), ``devmem_stats`` (a live ``obs.devmem.sample`` result: the
    card's memory per device) and ``residency``
    (``serving.registry.residency_snapshot()``: accounted-vs-actual
    resident bytes per model) and ``alerts`` (an alert engine's
    snapshot: one firing gauge per (rule, series))."""
    from .. import resilience
    from ..utils.file_io import io_retry_count
    from . import launches, recompile
    lines = []

    def metric(name, mtype, samples):
        lines.append("# TYPE %s %s" % (name, mtype))
        lines.extend(samples)

    # registry counters that MIRROR an always-on process counter rendered
    # below: emitting both would duplicate the metric name (invalid
    # exposition — Prometheus fails the whole scrape); the labeled
    # process-wide block is the richer one, so it wins
    mirrored = ("recompiles", "tree_kernel_launches", "predict_fallbacks",
                "io_retries", "plan_cache_fallbacks")
    for name, v in sorted(snapshot.get("counters", {}).items()):
        if name in mirrored:
            continue
        n = _prom_name(name) + "_total"
        metric(n, "counter", ["%s %s" % (n, _prom_val(v))])
    # host_rss_high_water_bytes mirrors the always-on hostmem gauge below
    # (same dedup rule as the mirrored counters; the live read is fresher
    # than the run gauge the loader last set)
    mirrored_gauges = ("host_rss_high_water_bytes",)
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        if name in mirrored_gauges:
            continue
        n = _prom_name(name)
        metric(n, "gauge", ["%s %s" % (n, _prom_val(v))])
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        n = _prom_name(name)
        samples = []
        for q in ("p50", "p99"):
            if q in h:
                samples.append('%s{quantile="0.%s"} %s'
                               % (n, q[1:], _prom_val(h[q])))
        samples.append("%s_sum %s" % (n, _prom_val(h.get("sum", 0.0))))
        samples.append("%s_count %s" % (n, _prom_val(h.get("count", 0))))
        metric(n, "summary", samples)
    # always-on process counters (live without any telemetry run)
    rc = _PREFIX + "recompiles_total"
    metric(rc, "counter",
           ['%s{fn="%s",bucket="%s"} %d' % (rc, _esc_label(f),
                                            _esc_label(b), n)
            for (f, b), n in sorted(recompile.counts().items())]
           or ["%s 0" % rc])
    if run_recompiles is not None:
        rr = _PREFIX + "run_recompiles"
        metric(rr, "gauge", ["%s %d" % (rr, int(run_recompiles))])
    lc = _PREFIX + "tree_kernel_launches_total"
    metric(lc, "counter",
           ['%s{mode="%s"} %d' % (lc, _esc_label(m), n)
            for m, n in sorted(launches.counts().items())]
           or ["%s 0" % lc])
    fb = _PREFIX + "predict_fallbacks_total"
    metric(fb, "counter",
           ['%s{site="%s"} %d' % (fb, _esc_label(s), n)
            for s, n in sorted(resilience.fallback_counts().items())]
           or ["%s 0" % fb])
    io = _PREFIX + "io_retries_total"
    metric(io, "counter", ["%s %d" % (io, io_retry_count())])
    # plan-cache degradations (plan/cache.py): analytic fallbacks from a
    # corrupt, foreign or mismatched tuned-plan cache, always on
    from ..plan.cache import fallback_count as _plan_fallbacks
    pf = _PREFIX + "plan_cache_fallbacks_total"
    metric(pf, "counter", ["%s %d" % (pf, _plan_fallbacks())])
    # host-memory plane (obs/hostmem.py): current RSS plus the
    # high-water (max of the chunk-boundary polls and the kernel's VmHWM)
    # — always-on like the resilience counters; the scrape IS the poll,
    # so the bounded-memory claim of the streaming loader is scrapeable
    # on any run, telemetry or not
    from . import hostmem as _hostmem
    hr = _PREFIX + "host_rss_bytes"
    metric(hr, "gauge", ["%s %d" % (hr, _hostmem.note())])
    hw = _PREFIX + "host_rss_high_water_bytes"
    metric(hw, "gauge",
           ["%s %d" % (hw, max(_hostmem.high_water(),
                               _hostmem.peak_rss_bytes()))])
    # model-quality plane (obs/quality.py): labeled per-model gauges,
    # rendered only when the run monitors traffic (no stale exposition)
    models = (quality or {}).get("models") or {}
    if models:
        def lbl(name):
            return _esc_label(name)

        dp = _PREFIX + "drift_psi"
        samples = []
        for m, info in sorted(models.items()):
            for f in info.get("features") or []:
                samples.append('%s{model="%s",feature="%s"} %s'
                               % (dp, lbl(m), lbl(f.get("name")),
                                  _prom_val(f.get("psi"))))
        if samples:
            metric(dp, "gauge", samples)
        sp = _PREFIX + "score_psi"
        metric(sp, "gauge",
               ['%s{model="%s"} %s' % (sp, lbl(m),
                                       _prom_val(info.get("score_psi")))
                for m, info in sorted(models.items())])
        gen = _PREFIX + "model_generation"
        metric(gen, "gauge",
               ['%s{model="%s"} %s' % (gen, lbl(m),
                                       _prom_val(info.get("generation")))
                for m, info in sorted(models.items())])
        beh = _PREFIX + "model_seconds_behind"
        metric(beh, "gauge",
               ['%s{model="%s"} %s'
                % (beh, lbl(m), _prom_val(info.get("seconds_behind")))
                for m, info in sorted(models.items())])
        qr = _PREFIX + "quality_rows_observed"
        metric(qr, "gauge",
               ['%s{model="%s"} %s' % (qr, lbl(m),
                                       _prom_val(info.get("rows")))
                for m, info in sorted(models.items())])
    # compile accounting (obs/compile.py): wall-seconds the run spent in
    # XLA compiles, total and per (function, shape-bucket) — warm
    # persistent-cache loads counted separately
    if compile_acct:
        ct = _PREFIX + "compile_seconds_total"
        metric(ct, "counter",
               ["%s %s" % (ct, _prom_val(
                   compile_acct.get("compile_seconds_total", 0.0)))])
        cs = _PREFIX + "compile_seconds"
        cn = _PREFIX + "compiles_key_total"
        key_samples, n_samples = [], []
        for key, info in sorted((compile_acct.get("keys") or {}).items()):
            fn_name, _, bucket = key.partition("|")
            lab = '{fn="%s",bucket="%s"}' % (_esc_label(fn_name),
                                            _esc_label(bucket))
            key_samples.append("%s%s %s" % (cs, lab,
                                            _prom_val(info.get("compile_s"))))
            n_samples.append("%s%s %d" % (cn, lab,
                                          int(info.get("compiles", 0))))
        if key_samples:
            metric(cs, "gauge", key_samples)
            metric(cn, "counter", n_samples)
        wl = _PREFIX + "compile_warm_loads_total"
        metric(wl, "counter",
               ["%s %d" % (wl, int(compile_acct.get("warm_loads", 0)))])
    # device-memory telemetry (obs/devmem.py): live card memory per
    # device — absent entirely on a CPU run
    if devmem_stats:
        for field, mname in (("bytes_in_use", "device_bytes_in_use"),
                             ("peak_bytes_in_use", "device_peak_bytes"),
                             ("bytes_reserved", "device_reserved_bytes"),
                             ("bytes_limit", "device_bytes_limit")):
            name = _PREFIX + mname
            samples = ['%s{device="%s"} %s'
                       % (name, _esc_label(dev), _prom_val(ms[field]))
                       for dev, ms in devmem_stats if ms.get(field)
                       is not None]
            if samples:
                metric(name, "gauge", samples)
    # serving residency cross-check (obs/devmem.py + serving/registry.py):
    # the registry's budget ledger vs the true stacked-ensemble bytes
    if residency:
        rb = _PREFIX + "residency_bytes"
        samples = []
        div_samples = []
        rd = _PREFIX + "residency_divergence"
        for m, info in sorted(residency.items()):
            for kind_key in ("accounted", "actual"):
                samples.append('%s{model="%s",kind="%s"} %s'
                               % (rb, _esc_label(m), kind_key,
                                  _prom_val(info.get(kind_key))))
            if info.get("divergence") is not None:
                div_samples.append('%s{model="%s"} %s'
                                   % (rd, _esc_label(m),
                                      _prom_val(info["divergence"])))
        metric(rb, "gauge", samples)
        if div_samples:
            # labeled + rebuilt per scrape from LIVE models only: a
            # departed model's divergence vanishes with it
            metric(rd, "gauge", div_samples)
    # live alerting (obs/alerts.py): one firing gauge per (rule, series)
    if alerts and alerts.get("series"):
        af = _PREFIX + "alert_state"
        metric(af, "gauge",
               ['%s{rule="%s",series="%s"} %d'
                % (af, _esc_label(st.get("rule")),
                   _esc_label(st.get("series")),
                   1 if st.get("state") == "firing" else 0)
                for st in alerts["series"]])
    return "\n".join(lines) + "\n"


def health_snapshot(tele=None) -> Dict[str, Any]:
    """The /healthz body: one dict an operator (or a supervisor probe) can
    alert on.  ``status`` is ``ok`` | ``draining`` (preemption requested or
    a serving provider is closing — the process is shutting down cleanly)
    | ``stalled`` (the dispatch watchdog fired)."""
    from .. import resilience
    from ..checkpoint import last_checkpoint_time
    now = time.time()
    out: Dict[str, Any] = {"ts": now}
    preempt = resilience.preemption_requested()
    out["preemption_requested"] = preempt
    wd = resilience.watchdog_status()
    out["watchdog"] = wd
    stall = resilience.last_stall()
    if stall is not None:
        out["watchdog_stall"] = {"section": stall.get("section"),
                                 "stall_s": stall.get("stall_s"),
                                 "ts": stall.get("ts")}
    ckpt_ts = last_checkpoint_time()
    out["last_checkpoint_age_s"] = (round(now - ckpt_ts, 3)
                                    if ckpt_ts else None)
    with _plock:
        provs = list(_providers.items())
    draining = preempt
    for name, fn in provs:
        try:
            info = fn()
        except Exception as exc:  # a dying provider must not kill /healthz
            info = {"error": str(exc)}
        out[name] = info
        if isinstance(info, dict):
            draining = draining or bool(info.get("draining"))
            if "queue_depth" in info and "queue_depth" not in out:
                out["queue_depth"] = info["queue_depth"]
    if tele is not None:
        out["uptime_s"] = round(now - tele.started_at, 3)
        out["events"] = tele.event_count
        if getattr(tele, "rank", None) is not None:
            out["rank"] = tele.rank
    if stall is not None or (wd is not None and wd.get("fired")):
        out["status"] = "stalled"
    elif draining:
        out["status"] = "draining"
    else:
        out["status"] = "ok"
    return out


class MetricsExporter:
    """The /metrics + /healthz + /summary.json listener for one run.

    ``port=0`` binds an ephemeral port (tests); the bound port is on
    ``self.port``.  All handlers are read-only snapshots; the server
    thread pool (``ThreadingHTTPServer``) keeps a slow scraper from
    serializing behind another."""

    def __init__(self, tele, port: int = 0,
                 addr: str = "127.0.0.1") -> None:
        # imported here: the serving tier imports this module for its
        # health provider, and a process that never serves a port must not
        # import http.server
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.tele = tele
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no per-scrape stderr spam
                pass

            def _send(self, code, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.partition("?")[0]
                try:
                    if path == "/metrics":
                        self._send(200, exporter._metrics_text(),
                                   "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        health = health_snapshot(exporter.tele)
                        code = 503 if health["status"] == "stalled" else 200
                        self._send(code, json.dumps(health, default=str),
                                   "application/json")
                    elif path == "/summary.json":
                        from .report import summarize
                        self._send(200, json.dumps(
                            summarize(exporter.tele), default=str),
                            "application/json")
                    elif path == "/alerts":
                        from . import alerts as _alerts
                        eng = _alerts.engine(exporter.tele)
                        body = (eng.snapshot() if eng is not None
                                else {"enabled": False, "series": [],
                                      "firing": 0, "fired_total": 0})
                        self._send(200, json.dumps(body, default=str),
                                   "application/json")
                    elif path == "/debug/profile":
                        code, body = exporter._debug_profile(
                            self.path.partition("?")[2])
                        self._send(code, json.dumps(body, default=str),
                                   "application/json")
                    else:
                        self._send(404, "not found: %s\n" % path,
                                   "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as exc:  # scrape must never kill the run
                    try:
                        self._send(500, "%s: %s\n"
                                   % (type(exc).__name__, exc),
                                   "text/plain")
                    except OSError:
                        pass

        self._server = ThreadingHTTPServer((addr, int(port)), Handler)
        self._server.daemon_threads = True
        self.addr = self._server.server_address[0]
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="lgbm-tpu-metrics", daemon=True)
        self._thread.start()

    def _metrics_text(self) -> str:
        from . import devmem, recompile
        snap = self.tele.registry.snapshot()
        base = getattr(self.tele, "recompile_baseline", {})
        run = sum(max(n - base.get(k, 0), 0)
                  for k, n in recompile.counts().items())
        mon = getattr(self.tele, "quality", None)
        acct = getattr(self.tele, "compile_acct", None)
        eng = getattr(self.tele, "alerts", None)
        # the scrape IS the devmem poll (live gauges cost nothing between
        # scrapes) and the residency cross-check runs on the same cadence
        dm = devmem.sample(self.tele)
        residency = devmem.check_residency(self.tele)
        return render_prometheus(
            snap, run_recompiles=run,
            quality=mon.snapshot() if mon is not None else None,
            compile_acct=acct.snapshot() if acct is not None else None,
            devmem_stats=dm, residency=residency,
            alerts=eng.snapshot() if eng is not None else None)

    def _debug_profile(self, query: str):
        """GET /debug/profile?seconds=N: one bounded capture into the
        run's profile directory; 409 while one is already running."""
        from urllib.parse import parse_qs
        from . import profiling
        try:
            seconds = float(parse_qs(query).get(
                "seconds", [profiling.DEFAULT_SECONDS])[0])
        except (TypeError, ValueError):
            return 400, {"error": "seconds must be a number"}
        meta = profiling.capture(self.tele, seconds=seconds, reason="http")
        if meta.get("busy"):
            return 409, meta
        return (200 if "error" not in meta else 501), meta

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)


def start_exporter(tele, port: int = 0,
                   addr: str = "127.0.0.1") -> MetricsExporter:
    """Start (or return the already-running) exporter for ``tele``; the
    exporter is owned by the run — ``Telemetry.close()`` stops it."""
    exp = getattr(tele, "exporter", None)
    if exp is not None:
        try:
            # exp.addr is the RESOLVED bound address; normalize the
            # request the same way so metrics_addr=localhost does not
            # false-alarm against 127.0.0.1
            import socket
            req_addr = socket.gethostbyname(addr)
        except OSError:
            req_addr = addr
        if int(port) not in (0, exp.port) or req_addr != exp.addr:
            # a silent mismatch would leave the operator scraping a dead
            # port with nothing in the logs explaining why
            Log.warning("telemetry exporter already listening on "
                        "http://%s:%d; ignoring request for %s:%d",
                        exp.addr, exp.port, addr, int(port))
        return exp
    exp = MetricsExporter(tele, port=port, addr=addr)
    tele.exporter = exp
    Log.info("telemetry exporter listening on http://%s:%d "
             "(/metrics /healthz /summary.json)", exp.addr, exp.port)
    return exp
