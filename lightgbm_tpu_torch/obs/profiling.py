"""Triggered profiler captures: on demand and by the flight recorder.

The counterpart of ``lightgbm_tpu/obs/profiling.py`` (:1-228), with
``torch.profiler`` in place of ``jax.profiler``:

- :func:`capture` runs ``torch.profiler.profile`` (CPU activities, and
  CUDA activities when a card is present) for a bounded window of
  ``seconds`` while the process goes on working, and exports a Chrome trace
  (``trace.json``: the host ops and every kernel the card ran, the port's
  hand-written ones by name) into the run's capture directory,
  ``<telemetry_out>.profiles/capture_<n>_<reason>/``, beside a
  ``capture.json`` of its metadata (the JAX package's layout,
  profiling.py:82-128); the exporter serves it at
  ``GET /debug/profile?seconds=N``;
- the **flight recorder**: :func:`arm_flight_recorder` arms ONE automatic
  capture a run, fired by the first watchdog stall or the first alert
  (:func:`on_incident`); a second incident, or one during a capture, does
  nothing.

- :func:`trace_block`: a profiler around a block of the caller's, its
  trace into a directory the caller names.

``torch.profiler`` is process-wide: a capture while another capture runs,
or while any other ``torch.profiler`` is active in the process (the
``--profile`` table of ``chip_smoke.py``), is refused with an error
marker, ``{"busy": true, "error": ...}``, and never nests.

Run-owned: state lives on the active :class:`~.registry.Telemetry`
(``tele.profiling``); with telemetry off no state exists and
:func:`on_incident` is one ``active() is None`` check.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import threading
import time
from typing import Any, Dict, Optional

PROFILE_DIR_SUFFIX = ".profiles"
DEFAULT_SECONDS = 1.0
MAX_SECONDS = 60.0
# the flight recorder's window: it runs before a watchdog abort, so it
# must fit inside a supervisor's grace period
FLIGHT_SECONDS = 1.0
TRACE_FILE = "trace.json"

_SAFE = re.compile(r"[^0-9A-Za-z_.-]")
# one torch.profiler a process, whichever run asks
_process_lock = threading.Lock()


class ProfilingState:
    """A run's captures, its in-flight flag and the flight recorder."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.active = False
        self.captures: list = []
        self.armed = False
        self.auto_seconds = FLIGHT_SECONDS
        self.auto_fired = False


_create_lock = threading.Lock()


def state(tele, create: bool = False) -> Optional[ProfilingState]:
    if tele is None:
        return None
    st = getattr(tele, "profiling", None)
    if st is None and create:
        with _create_lock:
            st = getattr(tele, "profiling", None)
            if st is None:
                st = tele.profiling = ProfilingState()
    return st


def artifact_root(tele) -> str:
    """The run's profile directory: beside its telemetry artifacts, or a
    per-process temporary directory for a memory-sink run."""
    base = getattr(tele, "summary_base", None) or getattr(
        tele, "out_path", None)
    if base:
        return base + PROFILE_DIR_SUFFIX
    return os.path.join(tempfile.gettempdir(),
                        "lgbm_tpu_torch_profiles_%d" % os.getpid())


def open_capture(root: str, n: int, reason: str) -> str:
    """Create and return ``<root>/capture_<n>_<reason>/``."""
    outdir = os.path.join(root, "capture_%02d_%s"
                          % (int(n), _SAFE.sub("_", str(reason))[:48]))
    os.makedirs(outdir, exist_ok=True)
    return outdir


def write_meta(outdir: str, **meta: Any) -> Dict[str, Any]:
    """Write ``capture.json`` into a capture directory (best effort)."""
    doc = {"v": 1, "ts": time.time(), "dir": outdir}
    doc.update(meta)
    try:
        from ..utils.file_io import atomic_write
        atomic_write(os.path.join(outdir, "capture.json"),
                     json.dumps(doc, indent=1, default=str))
    except OSError:
        pass
    return doc


def profiler_running() -> bool:
    """Whether a ``torch.profiler`` (ours or another) is active in the
    process."""
    import torch
    return bool(torch.autograd.profiler._is_profiler_enabled
                or torch._C._autograd._profiler_enabled())


def _profile_window(outdir: str, seconds: float) -> None:
    """Profile the process for ``seconds`` and export the Chrome trace into
    ``outdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        time.sleep(seconds)
    prof.export_chrome_trace(os.path.join(outdir, TRACE_FILE))


@contextlib.contextmanager
def _trace_into(outdir: str, profile, activities):
    try:
        with profile(activities=activities) as prof:
            yield
        os.makedirs(outdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(outdir, TRACE_FILE))
    finally:
        _process_lock.release()


def trace_block(outdir: str):
    """A context manager that runs ``torch.profiler.profile`` over its
    block and exports the Chrome trace (``trace.json``) into ``outdir``
    (profiling.py:105-114 of the JAX package, over ``jax.profiler``); a
    null context, still yielding, where no profiler can run: without
    ``torch.profiler``, or while a capture or another profiler runs in the
    process (they never nest), so that callers need no guard of their
    own."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
    except Exception:
        return contextlib.nullcontext()
    if not _process_lock.acquire(blocking=False):
        return contextlib.nullcontext()
    if profiler_running():
        _process_lock.release()
        return contextlib.nullcontext()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return _trace_into(outdir, profile, acts)


def capture(tele, seconds: float = DEFAULT_SECONDS,
            reason: str = "manual") -> Dict[str, Any]:
    """One bounded profiler capture on ``tele``'s run; returns its
    metadata, or ``{"busy": True, "error": ...}`` when a capture or another
    ``torch.profiler`` already runs in the process.  Blocks for
    ``seconds``: the /debug/profile handler calls it on its own request
    thread.  Callers gate on ``tele is not None``."""
    seconds = min(max(float(seconds), 0.05), MAX_SECONDS)
    st = state(tele, create=True)
    with st.lock:
        if st.active or not _process_lock.acquire(blocking=False):
            return {"busy": True,
                    "error": "a profiler capture is already in progress",
                    "captures": len(st.captures)}
        if profiler_running():
            _process_lock.release()
            return {"busy": True,
                    "error": "another torch.profiler is active in this "
                             "process",
                    "captures": len(st.captures)}
        st.active = True
        n = len(st.captures) + 1
    t0 = time.time()
    err = None
    outdir = None
    meta = {"n": n, "reason": str(reason), "seconds": seconds, "t0": t0}
    try:
        try:
            outdir = open_capture(artifact_root(tele), n, reason)
            try:
                _profile_window(outdir, seconds)
            except Exception as exc:  # a broken profiler must not kill
                err = "%s: %s" % (type(exc).__name__, exc)  # the run
        except OSError as exc:
            err = "cannot create capture dir: %s" % exc
        meta["dur_s"] = round(time.time() - t0, 3)
        if outdir is not None:
            meta["dir"] = outdir
            if err is None:
                meta["trace"] = os.path.join(outdir, TRACE_FILE)
            write_meta(outdir, **meta)
        if err is not None:
            meta["error"] = err
    finally:
        # append and release together: a capture started between the two
        # would reuse this capture's number and directory
        with st.lock:
            st.captures.append(meta)
            st.active = False
            _process_lock.release()
    tele.counter("profile_captures").inc()
    tele.event("profile_capture", **{k: v for k, v in meta.items()
                                     if not isinstance(v, dict)})
    from ..utils.log import Log
    Log.warning("profiler capture #%d (%s): %s", n, reason,
                err if err else outdir)
    return meta


def arm_flight_recorder(tele, seconds: float = FLIGHT_SECONDS) -> None:
    """Arm ONE automatic capture for this run (:func:`on_incident`)."""
    st = state(tele, create=True)
    with st.lock:
        st.armed = True
        st.auto_seconds = min(max(float(seconds), 0.05), MAX_SECONDS)


def on_incident(reason: str) -> Optional[Dict[str, Any]]:
    """Incident hook (watchdog stall, alert firing): capture once a run
    when the flight recorder is armed; nothing in every other state.
    Synchronous: the watchdog calls it before it aborts."""
    from . import active
    tele = active()
    if tele is None:
        return None
    st = state(tele)
    if st is None:
        return None
    with st.lock:
        if not st.armed or st.auto_fired or st.active:
            return None
        st.auto_fired = True
        seconds = st.auto_seconds
    return capture(tele, seconds=seconds, reason=str(reason))


def snapshot(tele) -> Dict[str, Any]:
    """The summary's ``profiling`` block: captures, flight-recorder
    state."""
    st = state(tele)
    if st is None:
        return {}
    with st.lock:
        if not st.captures and not st.armed:
            return {}
        return {"captures": list(st.captures),
                "flight_recorder_armed": st.armed,
                "flight_recorder_fired": st.auto_fired}
