"""Name-keyed wall-clock aggregation for host-side profiling.

A copy of ``lightgbm_tpu/utils/timer.py`` for the PyTorch port, the
counterpart of the reference's ``Common::Timer``/``FunctionTimer``/
``global_timer`` (include/LightGBM/utils/common.h:1032-1093): host paths are
instrumented with scopes whose accumulated times are printed at process exit
(and at the end of a CLI ``task=train``) when verbosity reaches debug.  A
scope measures the host's wall clock only and synchronises nothing, as the
JAX package's does not: device work queued inside a scope is timed by the
scope that first waits for it.  Device time is ``torch.profiler``'s job.

Scopes stack: each ``stop(name)`` closes the most recent open scope of that
name (per thread), so re-entrant instrumentation accumulates every scope's
time.  Start stacks are thread-local; the totals map is lock-protected.
"""
from __future__ import annotations

import atexit
import threading
import time
from collections import OrderedDict
from contextlib import ContextDecorator
from typing import Dict, List


class Timer:
    def __init__(self) -> None:
        self._local = threading.local()
        self._lock = threading.Lock()
        self._totals: "OrderedDict[str, float]" = OrderedDict()
        # bumped by reset(): start stacks are thread-local, so reset cannot
        # reach another thread's in-flight scope — instead each scope
        # records the epoch it opened in and stop() discards scopes that
        # straddle a reset
        self._epoch = 0

    def _starts(self) -> Dict[str, List[tuple]]:
        starts = getattr(self._local, "starts", None)
        if starts is None:
            starts = self._local.starts = {}
        return starts

    def start(self, name: str) -> None:
        self._starts().setdefault(name, []).append(
            (self._epoch, time.perf_counter()))

    def stop(self, name: str) -> None:
        stack = self._starts().get(name)
        if stack:
            epoch, t0 = stack.pop()
            self.add(name, time.perf_counter() - t0, epoch)

    @property
    def epoch(self) -> int:
        """The reset count a scope opens in (see :meth:`add`)."""
        return self._epoch

    def add(self, name: str, seconds: float, epoch: int) -> None:
        """Add a scope timed elsewhere (a span's own stamps) that opened
        at ``epoch``."""
        with self._lock:
            # epoch compared under the SAME lock reset() bumps it in: a
            # scope straddling a concurrent reset is discarded, not added
            # to the freshly-zeroed totals
            if epoch != self._epoch:
                return
            self._totals[name] = self._totals.get(name, 0.0) + seconds

    def total(self, name: str) -> float:
        with self._lock:
            return self._totals.get(name, 0.0)

    def totals(self) -> Dict[str, float]:
        """Snapshot of all accumulated scope totals (seconds)."""
        with self._lock:
            return dict(self._totals)

    def reset(self) -> None:
        self._starts().clear()
        with self._lock:
            self._totals.clear()
            self._epoch += 1

    def summary(self) -> str:
        lines = ["LightGBM-TPU host timing summary:"]
        for name, tot in sorted(self.totals().items(), key=lambda kv: -kv[1]):
            lines.append("  %s: %.6f s" % (name, tot))
        return "\n".join(lines)

    def print(self) -> None:
        from .log import Log
        Log.debug("%s", self.summary())


global_timer = Timer()


@atexit.register
def _print_at_exit() -> None:
    """The reference dumps global_timer when the process ends
    (common.h:1089-1093 ~Timer); Log.debug keeps it gated on
    verbosity >= debug like every other debug line."""
    if global_timer.totals():
        global_timer.print()


class FunctionTimer(ContextDecorator):
    """``with FunctionTimer("name"):`` or ``@FunctionTimer("name")`` scope timer."""

    def __init__(self, name: str, timer: Timer = global_timer) -> None:
        self._name = name
        self._timer = timer

    def __enter__(self) -> "FunctionTimer":
        self._timer.start(self._name)
        return self

    def __exit__(self, *exc) -> bool:
        self._timer.stop(self._name)
        return False
