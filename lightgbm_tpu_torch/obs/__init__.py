"""The telemetry plane of the port: metrics registry, JSONL events, miss and
split-pass accounting, spans, trace ranges, the card's memory, model
quality, end-of-run reports and the live scrape surface.

The counterpart of ``lightgbm_tpu/obs/__init__.py`` (:1-149): one active
:class:`~.registry.Telemetry` run per process (:func:`configure` /
:func:`active` / :func:`disable`), consulted by the training, prediction,
serving and checkpoint paths at dispatch granularity.  With no run
configured (the default) every instrumentation site is one ``None`` check
and the hot loops make zero telemetry calls (pinned by
``tests/test_torch_telemetry.py``).

Enable from any entry point with ``telemetry_out`` (JSONL path) and
``telemetry_freq`` (event cadence); ``engine.train``, ``engine.serve``, the
CLI and the C ABI finalize the run into ``<telemetry_out>.summary.json``
(:func:`~.report.finalize_run`); ``metrics_port`` serves it live over HTTP
(:mod:`.exporter`, imported lazily).  Under a multi-process group each rank
writes its own ``<out>.rank<k>.jsonl`` shard, every event stamped with its
rank, and rank 0 alone writes the summary.  The rank comes from an
initialised ``torch.distributed`` group of more than one process or from
``LIGHTGBM_TPU_TORCH_TELEMETRY_RANK``.

``alert_rules`` installs the live alert engine on the run (:mod:`.alerts`,
its ``/alerts`` endpoint and firing gauges), ``flight_recorder`` arms one
``torch.profiler`` capture for the run's first incident (:mod:`.profiling`,
also ``/debug/profile?seconds=N``), and the end-of-run summary carries the
cost model's ``mfu``/``device_util`` estimate (:mod:`.mfu`); the three
modules are imported by their call sites, on first use.
"""
from __future__ import annotations

import os as _os
import threading
from typing import Any, Optional

from . import recompile  # noqa: F401  (re-export)
from .registry import (EVENT_SCHEMA_VERSION, Counter, Gauge, Histogram,
                       MetricsRegistry, Telemetry, iter_events, read_events,
                       shard_path, validate_event)
from .trace import annotate

__all__ = ["Telemetry", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "EVENT_SCHEMA_VERSION", "read_events", "iter_events",
           "validate_event", "shard_path", "configure", "active", "disable",
           "annotate", "recompile", "spans", "quality", "devmem"]
# the compile-accounting submodule is reachable as obs.compile but not in
# __all__: a star-import must not shadow the builtin compile()

_lock = threading.Lock()
_active: Optional[Telemetry] = None

# forces a rank without a torch.distributed group (tests simulate the shard
# sinks of a multi-process run through it)
RANK_ENV = "LIGHTGBM_TPU_TORCH_TELEMETRY_RANK"


def _resolve_rank(rank: Optional[int]):
    """(rank, sharded): explicit argument > the env override > the rank of
    an initialised ``torch.distributed`` group of more than one process.
    ``sharded`` turns the JSONL sink into a per-rank shard; a plain
    single-process run keeps rank None and the unsharded path."""
    if rank is not None:
        return int(rank), True
    env = _os.environ.get(RANK_ENV)
    if env:
        return int(env), True
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return int(dist.get_rank()), True
    return None, False


def configure(out: Optional[str] = None, freq: int = 1,
              rank: Optional[int] = None, metrics_port: int = 0,
              metrics_addr: str = "127.0.0.1",
              alert_rules: Optional[str] = None,
              alert_interval_s: float = 1.0,
              flight_recorder: bool = False, **meta: Any) -> Telemetry:
    """Install the process-active telemetry run (closing any previous one).

    ``out`` is the JSONL sink path (None keeps events in memory); with a
    rank (an explicit ``rank``, the env override or a multi-process group)
    the sink is the shard ``<out>.rank<k>.jsonl`` and every event is
    rank-stamped.  ``metrics_port > 0`` starts the live HTTP exporter
    (``/metrics`` ``/healthz`` ``/summary.json``), stopped by
    ``Telemetry.close()``/:func:`disable`.  Extra keyword arguments land on
    the ``run_start`` event.  ``alert_rules`` (a JSON rules file) starts
    the alert engine, evaluated every ``alert_interval_s``;
    ``flight_recorder`` arms the one-shot incident capture."""
    global _active
    rank, sharded = _resolve_rank(rank)
    sink = shard_path(out, rank) if (out and sharded) else out
    tele = Telemetry(out=sink, freq=freq, meta=meta, rank=rank,
                     summary_base=out)
    with _lock:
        prev, _active = _active, tele
        spans.set_telemetry(tele)
    if prev is not None:
        # close (and release any exporter port) BEFORE binding the new
        # listener: back-to-back runs may reuse one fixed metrics_port
        prev.close()
    if int(metrics_port) > 0:
        from .exporter import start_exporter
        start_exporter(tele, port=int(metrics_port), addr=metrics_addr)
    if alert_rules:
        from . import alerts as _alerts
        _alerts.install(tele, rules_path=str(alert_rules),
                        interval_s=float(alert_interval_s))
    if flight_recorder:
        from . import profiling as _profiling
        _profiling.arm_flight_recorder(tele)
    return tele


def configure_from_config(cfg, entry: str, **meta: Any
                          ) -> Optional[Telemetry]:
    """The run a config asks for (``telemetry_out`` and/or ``metrics_port``;
    a memory sink when only the port is set), or None when it asks for
    none: the one bootstrap of ``engine.train``, ``engine.serve`` and the
    CLI (engine.py:182-198 and cli.py:107-134 of the JAX package)."""
    t_out = str(getattr(cfg, "telemetry_out", "") or "")
    m_port = int(getattr(cfg, "metrics_port", 0))
    if not t_out and m_port <= 0:
        return None
    return configure(out=t_out or None,
                     freq=int(getattr(cfg, "telemetry_freq", 1)),
                     metrics_port=m_port,
                     metrics_addr=str(getattr(cfg, "metrics_addr", "")
                                      or "127.0.0.1"),
                     alert_rules=str(getattr(cfg, "alert_rules", "")
                                     or "") or None,
                     alert_interval_s=float(getattr(cfg, "alert_interval_s",
                                                    1.0)),
                     flight_recorder=bool(getattr(cfg, "flight_recorder",
                                                  False)),
                     entry=entry, **meta)


def active() -> Optional[Telemetry]:
    """The process-active telemetry run, or None (telemetry off)."""
    return _active


def disable() -> None:
    """Close and clear the active telemetry run."""
    global _active
    with _lock:
        prev, _active = _active, None
        spans.set_telemetry(None)
    if prev is not None:
        prev.close()


# re-exported after active() exists (the submodules import it lazily);
# exporter is NOT imported here: it drags http.server into every
# telemetry-off import, and its call sites reach it lazily
from . import spans  # noqa: E402,F401
from . import quality  # noqa: E402,F401
from . import compile  # noqa: E402,F401,A004
from . import devmem  # noqa: E402,F401
