"""Device-memory telemetry: the card's memory as live gauges and high-water
events.

The counterpart of ``lightgbm_tpu/obs/devmem.py`` (:1-195).  The JAX module
asks PJRT's ``Device.memory_stats()``; the port asks PyTorch's caching
allocator for every CUDA device this process has initialised:
``bytes_in_use`` is ``torch.cuda.memory_allocated``, ``peak_bytes_in_use``
``torch.cuda.max_memory_allocated``, ``bytes_reserved``
``torch.cuda.memory_reserved`` and ``bytes_limit`` the card's total memory.
A run on ``device="cpu"`` (or a process that never touched CUDA) reports no
device, as the JAX module reports none on a backend without stats: the
host's memory is never read and called the device's (``obs.hostmem`` reads
the host).

- :func:`sample` polls into the run's tracker, from the train hook,
  ``finalize_run`` and every ``/metrics`` scrape;
- a ``kind="devmem"`` event marks a phase whose peak grew;
- :func:`check_residency` holds the serving registry's accounted bytes
  against the resident tensors' true bytes and warns once per model when
  they diverge by more than ``RESIDENCY_DIVERGENCE_WARN``.

Run-owned: the tracker lives on the active telemetry run (``tele.devmem``)
and every call site gates on ``obs.active() is None`` first.
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

# warn when |actual - accounted| / actual exceeds this (the registry's
# budget ledger has drifted from the true resident footprint)
RESIDENCY_DIVERGENCE_WARN = 0.10

# memory_stats keys surfaced as gauges (when the backend reports them)
_FIELDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
           "bytes_limit")


class DevMemTracker:
    """Per-run device-memory state: fleet high-water marks + warn-once
    bookkeeping and per-model divergence for the residency cross-check
    (kept here, not in registry gauges — a departed model must vanish
    from the exposition, and registry gauges have no removal)."""

    def __init__(self) -> None:
        self.high_water: Dict[str, int] = {}
        self.last: Dict[str, Dict[str, int]] = {}
        self.warned_models: set = set()
        self.divergence: Dict[str, float] = {}
        self._lock = threading.Lock()


def tracker(tele, create: bool = False) -> Optional[DevMemTracker]:
    if tele is None:
        return None
    trk = getattr(tele, "devmem", None)
    if trk is None and create:
        with _create_lock:
            trk = getattr(tele, "devmem", None)
            if trk is None:
                trk = tele.devmem = DevMemTracker()
    return trk


_create_lock = threading.Lock()


def device_memory_stats() -> List[Tuple[str, Dict[str, int]]]:
    """[(device_index, stats)] for every CUDA device of this process; []
    when CUDA is not initialised here (a CPU run) — polling never
    initialises CUDA, and never raises."""
    import torch
    try:
        if not torch.cuda.is_initialized():
            return []
        out = []
        for d in range(torch.cuda.device_count()):
            out.append((str(d), {
                "bytes_in_use": int(torch.cuda.memory_allocated(d)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
                "bytes_reserved": int(torch.cuda.memory_reserved(d)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(d).total_memory)}))
        return out
    except Exception:
        return []


def sample(tele, phase: Optional[str] = None) -> List[Tuple[str, Dict]]:
    """Poll device memory into ``tele``'s gauges; with ``phase`` set (the
    train-chunk hook) also stamp a ``kind="devmem"`` event, flagged
    ``high_water=true`` when any device's peak grew since the last stamp.
    Returns the raw [(device, stats)] list (the exporter renders labeled
    gauges from it).  Callers gate on ``tele is not None``."""
    stats = device_memory_stats()
    if not stats:
        return stats
    trk = tracker(tele, create=True)
    total_in_use = 0
    peak_max = 0
    grew = False
    with trk._lock:
        for dev, ms in stats:
            # NOT mirrored into registry gauges: the exporter renders the
            # labeled lgbm_tpu_device_* family from the fresh sample and
            # the summary reads the tracker — a second, one-poll-stale
            # unlabeled copy would just disagree with both
            in_use = int(ms.get("bytes_in_use", 0) or 0)
            peak = int(ms.get("peak_bytes_in_use", in_use) or in_use)
            total_in_use += in_use
            peak_max = max(peak_max, peak)
            if peak > trk.high_water.get(dev, 0):
                trk.high_water[dev] = peak
                grew = True
            trk.last[dev] = ms
    if phase is not None:
        tele.event("devmem", phase=str(phase), devices=len(stats),
                   bytes_in_use=int(total_in_use),
                   peak_bytes=int(peak_max), high_water=bool(grew))
    return stats


def check_residency(tele) -> Optional[Dict[str, Dict[str, int]]]:
    """Cross-check the serving registries' accounted-vs-actual resident
    bytes (None when no serving registry exists in the process — the
    import is sys.modules-gated so a pure-training run never drags the
    serving tier in).  Divergence beyond :data:`RESIDENCY_DIVERGENCE_WARN`
    warns ONCE per model, bumps the ``residency_divergence_warnings``
    counter and pins the per-model divergence gauge.  Callers gate on
    ``tele is not None``."""
    mod = sys.modules.get(__name__.rsplit(".", 2)[0] + ".serving.registry")
    if mod is None:
        return None
    snap = mod.residency_snapshot()
    trk = tracker(tele, create=True) if snap else tracker(tele)
    if trk is not None:
        with trk._lock:
            # departed models leave the exposition AND the tracker — the
            # divergence of a model that no longer exists is not a metric
            trk.divergence = {m: d for m, d in trk.divergence.items()
                              if m in snap}
    if not snap:
        return snap
    from ..utils.log import Log
    for model, info in snap.items():
        actual = int(info.get("actual", 0))
        accounted = int(info.get("accounted", 0))
        div = abs(actual - accounted) / float(max(actual, 1))
        info["divergence"] = round(div, 6)
        with trk._lock:
            trk.divergence[model] = info["divergence"]
        if div > RESIDENCY_DIVERGENCE_WARN:
            with trk._lock:
                fresh = model not in trk.warned_models
                trk.warned_models.add(model)
            if fresh:
                Log.warning(
                    "serving residency ledger diverges for model %r: "
                    "accounted %d bytes vs actual %d (%.1f%% > %.0f%%) — "
                    "the admission budget is running on a stale footprint",
                    model, accounted, actual, div * 100.0,
                    RESIDENCY_DIVERGENCE_WARN * 100.0)
                tele.counter("residency_divergence_warnings").inc()
                tele.event("residency_divergence", model=model,
                           accounted=accounted, actual=actual,
                           divergence=round(div, 6))
    return snap


def snapshot(tele) -> Dict[str, Any]:
    """The summary view: per-device last sample + fleet high-water (empty
    when the run never saw a device with memory stats)."""
    trk = tracker(tele)
    if trk is None:
        return {}
    with trk._lock:
        if not trk.last and not trk.divergence:
            return {}
        out: Dict[str, Any] = {}
        if trk.last:
            out.update(
                devices={dev: {f: int(ms[f]) for f in _FIELDS
                               if ms.get(f) is not None}
                         for dev, ms in sorted(trk.last.items())},
                high_water_bytes=dict(sorted(trk.high_water.items())),
                peak_bytes_max=max(trk.high_water.values(), default=0))
        if trk.divergence:
            out["residency_divergence"] = dict(sorted(
                trk.divergence.items()))
        return out
