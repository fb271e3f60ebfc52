"""Host-memory tracking: always-on RSS and high-water readings.

The counterpart of ``lightgbm_tpu/obs/hostmem.py`` (:1-90), host Python
only.  Readings come from ``/proc`` (``/proc/self/statm`` for the current
RSS, ``VmHWM`` in ``/proc/self/status`` for the kernel's own high-water),
with a ``resource.getrusage`` fallback elsewhere.

- :func:`peak_rss_bytes`: the OS-tracked lifetime peak (``VmHWM``);
- :func:`note` / :func:`high_water`: the process-local observed peak across
  explicit poll points (every ``/metrics`` scrape).
"""
from __future__ import annotations

import os
import threading

try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):
    _PAGE = 4096

_LOCK = threading.Lock()
_HIGH = 0


def rss_bytes() -> int:
    """Current resident set size in bytes (0 if unreadable)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        # ru_maxrss is a PEAK (kilobytes on Linux), not current — best
        # effort on platforms without /proc
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return 0


def peak_rss_bytes() -> int:
    """OS-tracked lifetime peak RSS (VmHWM) in bytes (0 if unreadable)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return 0


def note() -> int:
    """Poll current RSS, fold it into the observed high-water, return it."""
    global _HIGH
    cur = rss_bytes()
    if cur > _HIGH:
        with _LOCK:
            if cur > _HIGH:
                _HIGH = cur
    return cur


def high_water() -> int:
    """Largest RSS seen across :func:`note` calls this process."""
    return _HIGH
