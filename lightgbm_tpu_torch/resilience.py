"""Runtime supervision: preemption, the dispatch watchdog and the fallback
counter.

Counterpart of ``lightgbm_tpu/resilience.py`` for the PyTorch port (which
imports nothing of the JAX package).  Checkpoints make a crashed run
recoverable; this layer handles the faults that are not crashes:

- **SIGTERM/SIGINT preemption** (:func:`install_preemption_handler`): the
  signal handler only sets a flag, and the training loop polls it once an
  iteration (the JAX package polls at its fused chunks' boundaries; the
  port has no fused chunk, so every iteration end is a boundary).  On a
  set flag the loop synchronises the CUDA stream (the in-flight work
  drains), writes an emergency checkpoint through the ordinary
  ``checkpoint.py`` path and raises :class:`TrainingPreempted`; the CLI
  turns that into :data:`EXIT_PREEMPTED` (75, ``EX_TEMPFAIL``: "retry
  me"), so a supervisor can tell a resumable run from a failed one.

- **stalled dispatches** (:class:`Watchdog`): blocking work is wrapped in
  :func:`watch` sections; a monitor thread checks the open sections and,
  after ``watchdog_timeout_s`` without progress, writes a diagnostic
  artifact (section, devices, kernel launch counts and build time, host
  timer totals) and aborts the process with :data:`EXIT_STALLED`.

- **fallback accounting** (:func:`note_fallback`): a counter of degraded
  path activations.

Where the port differs from the JAX package:

- With a telemetry run active, an emergency checkpoint records
  ``preemptions``, ``preempt_checkpoint_s`` and a ``preempt_checkpoint``
  event, and a stall ``watchdog_stall_s``, a ``watchdog_stall`` event, a
  firing ``watchdog_stall`` alert (``obs/alerts.note_incident``) and the
  flight recorder's capture when the run armed one (resilience.py:199-205,
  :365-380 of the JAX package).
- The first-dispatch grace covers the first ``nvcc`` build of the kernels
  (``kernels.build()``, run at the first launch), where the JAX package's
  covers an XLA compile of a program: a section that may launch a kernel
  (``builds=True``) and opens before the kernels are built
  (``kernels.build_seconds()`` is None) is held to ``timeout *
  first_dispatch_grace``, every other section to the plain timeout.
- The port has no degraded path, so nothing calls :func:`note_fallback`
  and :func:`fallback_counts` stays empty.

Everything here is off until an entry point opts in; the poll is one
``Event.is_set()`` an iteration, and :func:`watch` returns a shared
``nullcontext`` when no watchdog is active.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

from .utils.log import LightGBMError, Log

# sysexits.h: 75 = EX_TEMPFAIL ("temporary failure; the user is invited to
# retry"), which a preempted run with a checkpoint is
EXIT_PREEMPTED = 75
# outside the sysexits range, so a supervisor can tell a watchdog abort
# (a hung dispatch: reschedule elsewhere) from the EX_* codes
EXIT_STALLED = 79


class TrainingPreempted(LightGBMError):
    """Training was interrupted by SIGTERM/SIGINT (or
    :func:`request_preemption`) after writing an emergency checkpoint; the
    run is resumable.  ``checkpoint_seconds`` is the checkpoint's write
    time (None when none was written)."""

    def __init__(self, iteration: int, checkpoint_path: Optional[str] = None,
                 signum: Optional[int] = None,
                 checkpoint_seconds: Optional[float] = None) -> None:
        self.iteration = int(iteration)
        self.checkpoint_path = checkpoint_path
        self.signum = signum
        self.checkpoint_seconds = checkpoint_seconds
        where = (" (emergency checkpoint %s)" % checkpoint_path
                 if checkpoint_path else "")
        super().__init__(
            "training preempted at iteration %d%s; rerun the same command "
            "to resume" % (iteration, where))


# ---- the preemption flag ----

_PREEMPT_FLAG = threading.Event()
_PREEMPT_SIGNUM: Optional[int] = None
_PREV_HANDLERS: Dict[int, Any] = {}


def _on_preempt_signal(signum, frame) -> None:
    """The installed handler: it only sets the flag and notes the signal;
    the checkpoint is written at the next iteration end, in the training
    loop's own thread."""
    global _PREEMPT_SIGNUM
    _PREEMPT_SIGNUM = signum
    _PREEMPT_FLAG.set()


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGINT)):
    """Route ``signals`` to the preemption flag, remembering the previous
    handlers for :func:`uninstall_preemption_handler`.

    Returns the signals this call newly installed: the caller owns exactly
    those and passes them back to :func:`uninstall_preemption_handler`.  An
    empty tuple means an earlier owner (a C host through
    ``LGBM_PreemptionInstall``, an outer caller) already holds every
    requested signal.  Off the main thread (a CPython restriction) nothing
    is installed and a warning says so; :func:`request_preemption` still
    sets the flag."""
    installed = []
    for sig in signals:
        if sig in _PREV_HANDLERS:
            continue
        try:
            _PREV_HANDLERS[sig] = signal.signal(sig, _on_preempt_signal)
        except ValueError:  # not the main thread
            Log.warning(
                "cannot install the %s preemption handler from a non-main "
                "thread; arm it from the main thread (or feed "
                "request_preemption() from your own watcher)",
                signal.Signals(sig).name)
            continue
        installed.append(sig)
    if installed:
        Log.debug("preemption handler installed for %s",
                  ", ".join(signal.Signals(s).name for s in installed))
    return tuple(installed)


def uninstall_preemption_handler(signals=None) -> None:
    """Restore the handlers that :func:`install_preemption_handler` found
    for ``signals`` (an ownership tuple); ``None`` restores every one (for
    the process-wide owner and test teardown only)."""
    sigs = list(_PREV_HANDLERS) if signals is None else list(signals)
    for sig in sigs:
        if sig not in _PREV_HANDLERS:
            continue
        prev = _PREV_HANDLERS.pop(sig)
        try:
            signal.signal(sig, prev)
        except (ValueError, TypeError):  # non-main thread, foreign handler
            pass


def preemption_requested() -> bool:
    """True once a handled signal (or :func:`request_preemption`) fired."""
    return _PREEMPT_FLAG.is_set()


def request_preemption() -> None:
    """Set the flag from code (tests; a host that receives the preemption
    notice another way)."""
    _PREEMPT_FLAG.set()


def clear_preemption() -> None:
    """Consume the flag.  The training loops call this when they handle a
    preemption, so that a later ``train()`` in the same process (the
    in-process resume) does not stop again at once."""
    global _PREEMPT_SIGNUM
    _PREEMPT_SIGNUM = None
    _PREEMPT_FLAG.clear()


def arm_supervision(preempt: bool, watchdog_timeout_s: float,
                    artifact_base: Optional[str] = None):
    """The arming policy of every entry point (``engine.train``, the CLI):
    install the preemption handler when asked, and start the watchdog when
    a timeout is set and none is active.  Returns ``(owned_signals,
    owned_watchdog)`` for :func:`disarm_supervision`."""
    owned_signals = install_preemption_handler() if preempt else ()
    owned_wd = float(watchdog_timeout_s) > 0 and watchdog_active() is None
    if owned_wd:
        art = (artifact_base + ".stall.json") if artifact_base else None
        start_watchdog(float(watchdog_timeout_s), artifact=art)
    return owned_signals, owned_wd


def disarm_supervision(owned_signals, owned_wd: bool) -> None:
    """Tear down what :func:`arm_supervision` armed, and nothing that an
    outer owner armed."""
    if owned_signals:
        uninstall_preemption_handler(owned_signals)
    if owned_wd:
        stop_watchdog()


def emergency_checkpoint(booster, prefix: str):
    """Write the emergency checkpoint through ``checkpoint.py``'s atomic
    path; returns ``(path, seconds)``.  Only the write leader (rank 0 of a
    parallel learner's processes, which all stop together) writes; the
    others return ``(None, None)`` (resilience.py:189-190)."""
    from .parallel.learners import is_write_leader
    if not is_write_leader(getattr(booster, "group", None)):
        return None, None
    t0 = time.perf_counter()
    path = booster.save_checkpoint(prefix)
    dt = time.perf_counter() - t0
    signame = (signal.Signals(_PREEMPT_SIGNUM).name
               if _PREEMPT_SIGNUM is not None else "request")
    Log.warning("preemption (%s): wrote emergency checkpoint %s in %.0f ms",
                signame, path, dt * 1e3)
    from .obs import active as _telemetry_active
    tele = _telemetry_active()
    if tele is not None:
        tele.counter("preemptions").inc()
        tele.histogram("preempt_checkpoint_s").observe(dt)
        tele.event("preempt_checkpoint", iteration=int(booster.iter_),
                   dt_s=dt, path=path, signal=signame)
        tele.flush()  # the process is about to stop; keep the tail
    return path, dt


# ---- the dispatch watchdog ----

# the stall bar of a section that may run the first kernel build, as a
# multiple of the timeout (an nvcc build of the kernels is not a hang)
FIRST_DISPATCH_GRACE = 10.0


def _kernels_built() -> bool:
    from .kernels import build_seconds
    return build_seconds() is not None


class Watchdog:
    """Monitor thread around blocking dispatches.

    Sites wrap their blocking work in :meth:`section`; the monitor wakes a
    few times per timeout and, when an open section has made no progress
    for its bar, writes a diagnostic artifact and aborts the process
    (``os._exit(EXIT_STALLED)``): a hung device call cannot be interrupted
    from Python, so a clean abort with diagnostics is what is left.

    ``abort=False`` (tests, hosts with their own supervision) records the
    stall and calls ``on_stall(diag)`` instead of exiting."""

    def __init__(self, timeout_s: float, artifact: Optional[str] = None,
                 abort: bool = True,
                 on_stall: Optional[Callable[[Dict], None]] = None,
                 first_dispatch_grace: float = FIRST_DISPATCH_GRACE) -> None:
        self.timeout_s = float(timeout_s)
        self.artifact = artifact
        self.abort = abort
        self.on_stall = on_stall
        self.first_dispatch_grace = max(1.0, float(first_dispatch_grace))
        self.fired: Optional[Dict] = None
        self._lock = threading.Lock()
        self._sections: Dict[int, tuple] = {}
        self._next_token = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="lgbm-torch-watchdog",
                                        daemon=True)

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    @contextlib.contextmanager
    def section(self, name: str, builds: bool = False, **info: Any):
        """Mark a blocking dispatch.  ``builds``: the section may launch a
        kernel, so when it opens before the kernels are built it may hold
        their first build and gets the grace bar."""
        grace = bool(builds) and not _kernels_built()
        bar = self.timeout_s * (self.first_dispatch_grace if grace else 1.0)
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._sections[token] = (name, bar, time.monotonic(), info)
        try:
            yield
        finally:
            with self._lock:
                self._sections.pop(token, None)

    def status(self) -> Dict[str, Any]:
        """Open sections, the age of the oldest, and whether this watchdog
        fired."""
        now = time.monotonic()
        with self._lock:
            ages = [now - start for _, _, start, _ in
                    self._sections.values()]
        return {"active": True, "timeout_s": self.timeout_s,
                "open_sections": len(ages),
                "oldest_open_s": round(max(ages), 3) if ages else None,
                "fired": self.fired is not None}

    def _run(self) -> None:
        poll = max(min(self.timeout_s / 4.0, 1.0), 0.01)
        while not self._stop.wait(poll):
            now = time.monotonic()
            with self._lock:
                stalled = [(name, now - start, info)
                           for name, bar, start, info
                           in self._sections.values() if now - start > bar]
            if stalled and self.fired is None:
                # the oldest section is the blocker
                name, elapsed, info = max(stalled, key=lambda s: s[1])
                self._handle_stall(name, elapsed, info)
                if self.abort:
                    os._exit(EXIT_STALLED)
                # a watchdog that does not abort fires once; its monitor
                # ends here, so it hands back the process-active slot (else
                # every later arm_supervision would see one armed)
                global _WATCHDOG
                if _WATCHDOG is self:
                    _WATCHDOG = None
                return

    def _diagnostics(self, name: str, elapsed: float,
                     info: Dict[str, Any]) -> Dict[str, Any]:
        from . import device as _device
        from .kernels import build_seconds
        from .utils.timer import global_timer
        diag: Dict[str, Any] = {
            "v": 1, "kind": "watchdog_stall", "ts": time.time(),
            "section": name, "stall_s": round(elapsed, 3),
            "timeout_s": self.timeout_s, "pid": os.getpid(),
            "info": dict(info),
            "launches": _device.launches(),
            "kernel_build_s": build_seconds(),
            "host_phases": {k: round(v, 6)
                            for k, v in global_timer.totals().items()},
        }
        try:  # the devices the process sees; no call waits on the card
            import torch
            diag["devices"] = (
                [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
                if torch.cuda.is_available() else ["cpu"])
        except Exception as exc:  # a wedged runtime still gets its report
            diag["devices"] = "unavailable: %s" % exc
        return diag

    def _handle_stall(self, name: str, elapsed: float,
                      info: Dict[str, Any]) -> None:
        global _LAST_STALL
        diag = self._diagnostics(name, elapsed, info)
        self.fired = diag
        _LAST_STALL = diag
        Log.warning("WATCHDOG: no progress in %r for %.1f s (timeout %.1f s)"
                    " - writing diagnostics and aborting", name, elapsed,
                    self.timeout_s)
        from .obs import active as _telemetry_active
        tele = _telemetry_active()
        if tele is not None:
            tele.gauge("watchdog_stall_s").set(elapsed)
            tele.event("watchdog_stall", section=name, stall_s=elapsed,
                       timeout_s=self.timeout_s)
            # a stall is an incident: into the alert stream, and the
            # flight recorder's one capture, taken before the abort so the
            # trace exists when a supervisor reads the exit code
            # (resilience.py:371-380 of the JAX package); both do nothing
            # unless the run armed them
            from .obs import alerts as _alerts
            from .obs import profiling as _profiling
            _alerts.note_incident(tele, "watchdog_stall", section=name,
                                  stall_s=elapsed)
            _profiling.on_incident("watchdog_stall")
            tele.flush()
        if self.artifact:
            try:
                from .utils.file_io import atomic_write
                atomic_write(self.artifact, json.dumps(diag, indent=1,
                                                       default=str))
                Log.warning("WATCHDOG: diagnostics written to %s",
                            self.artifact)
            except OSError as exc:  # must not stop the abort
                Log.warning("WATCHDOG: could not write diagnostics (%s)", exc)
        if self.on_stall is not None:
            self.on_stall(diag)


_WATCHDOG: Optional[Watchdog] = None
_NULL_CTX = contextlib.nullcontext()
# the last stall's diagnostics, kept past the one-shot watchdog's teardown;
# cleared when a fresh watchdog arms
_LAST_STALL: Optional[Dict] = None


def last_stall() -> Optional[Dict]:
    """Diagnostics of the most recent watchdog stall (None when the current
    watchdog generation has seen none)."""
    return _LAST_STALL


def clear_stall() -> None:
    """Drop the recorded stall (tests; a host that recovered on its own).
    Arming a fresh watchdog clears it too."""
    global _LAST_STALL
    _LAST_STALL = None


def start_watchdog(timeout_s: float, artifact: Optional[str] = None,
                   abort: bool = True,
                   on_stall: Optional[Callable[[Dict], None]] = None,
                   first_dispatch_grace: float = FIRST_DISPATCH_GRACE
                   ) -> Watchdog:
    """Install the process-active watchdog, replacing any previous one."""
    global _LAST_STALL, _WATCHDOG
    _LAST_STALL = None
    prev, _WATCHDOG = _WATCHDOG, Watchdog(
        timeout_s, artifact=artifact, abort=abort, on_stall=on_stall,
        first_dispatch_grace=first_dispatch_grace)
    if prev is not None:
        prev.stop()
    Log.debug("watchdog armed: timeout %.1f s%s", timeout_s,
              (", artifact %s" % artifact) if artifact else "")
    return _WATCHDOG.start()


def stop_watchdog() -> None:
    global _WATCHDOG
    prev, _WATCHDOG = _WATCHDOG, None
    if prev is not None:
        prev.stop()


def watchdog_active() -> Optional[Watchdog]:
    return _WATCHDOG


def watchdog_status() -> Optional[Dict[str, Any]]:
    """The active watchdog's :meth:`Watchdog.status` (None when none is
    armed)."""
    wd = _WATCHDOG
    return wd.status() if wd is not None else None


def watch(name: str, builds: bool = False, **info: Any):
    """Context manager marking a blocking dispatch for the active watchdog
    (see :meth:`Watchdog.section`); a shared no-op when none is armed."""
    wd = _WATCHDOG
    if wd is None:
        return _NULL_CTX
    return wd.section(name, builds=builds, **info)


# ---- fallback accounting ----

_FB_LOCK = threading.Lock()
_FALLBACKS: Dict[str, int] = {}


def note_fallback(site: str, reason: str = "", **fields: Any) -> None:
    """Count one degraded-path activation at ``site``.  No port path has a
    degraded form, so nothing calls this yet."""
    with _FB_LOCK:
        _FALLBACKS[site] = _FALLBACKS.get(site, 0) + 1


def fallback_counts() -> Dict[str, int]:
    with _FB_LOCK:
        return dict(_FALLBACKS)


def reset_fallbacks() -> None:
    with _FB_LOCK:
        _FALLBACKS.clear()
