"""Scheme-dispatched file IO, atomic writes with retries, and the CRC32
trailer of checkpoint files.

Counterpart of ``lightgbm_tpu/utils/file_io.py`` for the PyTorch port
(which imports nothing of the JAX package), and of the reference's
``VirtualFileReader``/``VirtualFileWriter`` (src/io/file_io.cpp:62-134):
local files by default, with a registry for remote schemes
(:func:`register_scheme`, :func:`open_file`, :func:`exists`).  ``hdfs://``
routes through ``pyarrow.fs`` when it is installed and raises by name when
it is not.

``atomic_write`` is the durability primitive every model, snapshot and
checkpoint write goes through: the bytes land in a same-directory temp
file, are fsynced and renamed over the destination, and the directory is
fsynced, so a kill at any point leaves either the old complete file or the
new one.  Transient filesystem faults (``EIO``, ``EAGAIN``, ``EINTR``,
``EBUSY``, ``ETIMEDOUT``, ``ESTALE``) are retried with bounded jittered
backoff (:func:`retry_io`, configured by the ``io_retry_attempts`` /
``io_retry_backoff_s`` parameters through :func:`configure_retries`); every
other error (a full disk, permissions) raises at once.  A process-global
fault hook (:func:`set_fault_hook`) lets tests kill or fail the writer
between the temp write and the rename.  A retry is logged and counted
(:func:`io_retry_count`, always on); with a telemetry run active it also
bumps ``io_retries`` and emits an ``io_retry`` event (file_io.py:95-110 of
the JAX package).
"""
from __future__ import annotations

import errno
import os
import random
import threading
import time
import zlib
from typing import Callable, Dict, Optional

from .log import Log

_SCHEMES: Dict[str, Callable] = {}

# called with the stage name ("written", "synced", "replaced") and the
# destination path inside atomic_write; raising from it (or killing the
# process) simulates a crash or an I/O fault at that point
_FAULT_HOOK: Optional[Callable[[str, str], None]] = None


def set_fault_hook(hook: Optional[Callable[[str, str], None]]) -> None:
    """Install ``hook(stage, path)``, fired inside :func:`atomic_write`:
    "written" after the temp write, "synced" after its fsync (both before
    the rename) and "replaced" after ``os.replace``, before the directory
    fsync.  ``None`` clears it.  Raising ``OSError`` from the hook
    simulates transient (``EIO``) and fatal (``ENOSPC``) faults against the
    retry policy."""
    global _FAULT_HOOK
    _FAULT_HOOK = hook


# ---- retry with backoff for transient filesystem faults ----

RETRYABLE_ERRNOS = frozenset(
    e for e in (errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY,
                getattr(errno, "ETIMEDOUT", None),
                getattr(errno, "ESTALE", None)) if e is not None)

_RETRY = {"attempts": 3, "base_delay": 0.05}
_IO_RETRY_LOCK = threading.Lock()
_IO_RETRIES = 0


def configure_retries(attempts: Optional[int] = None,
                      base_delay: Optional[float] = None) -> None:
    """Set the process-wide file-IO retry policy (the ``io_retry_attempts``
    and ``io_retry_backoff_s`` parameters come here through the config)."""
    if attempts is not None:
        _RETRY["attempts"] = max(1, int(attempts))
    if base_delay is not None:
        _RETRY["base_delay"] = max(0.0, float(base_delay))


def is_retryable(exc: OSError) -> bool:
    """True for a transient errno; an unknown errno counts as fatal."""
    return getattr(exc, "errno", None) in RETRYABLE_ERRNOS


def io_retry_count() -> int:
    """Retried IO attempts in this process."""
    with _IO_RETRY_LOCK:
        return _IO_RETRIES


def reset_io_retry_count() -> None:
    global _IO_RETRIES
    with _IO_RETRY_LOCK:
        _IO_RETRIES = 0


def _note_retry(what: str, path: str, exc: OSError, attempt: int) -> None:
    global _IO_RETRIES
    with _IO_RETRY_LOCK:
        _IO_RETRIES += 1
    Log.warning("%s %s failed transiently (%s); retrying (attempt %d/%d)",
                what, path, exc, attempt + 1, _RETRY["attempts"])
    from ..obs import active as _telemetry_active
    tele = _telemetry_active()
    if tele is not None:
        tele.counter("io_retries").inc()
        tele.event("io_retry", what=what, path=path,
                   errno=int(getattr(exc, "errno", -1) or -1),
                   attempt=int(attempt + 1))


def retry_io(fn: Callable[[], object], what: str = "io", path: str = ""):
    """``fn()`` with bounded, jittered exponential backoff on retryable
    ``OSError``s; fatal errnos raise at once, and the last attempt's error
    raises when all attempts fail."""
    attempts = int(_RETRY["attempts"])
    base = float(_RETRY["base_delay"])
    for i in range(attempts):
        try:
            return fn()
        except OSError as exc:
            if not is_retryable(exc) or i == attempts - 1:
                raise
            _note_retry(what, path, exc, i)
            # full jitter: [0.5, 1.5) * base * 2^i, so processes retrying
            # against one shared store do not retry in step
            time.sleep(base * (1 << i) * (0.5 + random.random()))


def _fsync_dir(dirname: str) -> None:
    """fsync the directory, so that the rename itself survives a crash
    (POSIX makes a new directory entry durable only once its directory is
    synced).  Best effort: some filesystems refuse it."""
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def atomic_write(path: str, data, fsync: bool = True) -> None:
    """Write ``data`` (str or bytes) to ``path`` atomically and durably:
    temp file in the same directory -> write -> fsync -> rename over
    ``path`` -> fsync of the directory, retried as :func:`retry_io` says.
    A ``scheme://`` path is a plain streamed write through its opener (its
    store gives whatever atomicity it has)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    if "://" in path:
        retry_io(lambda: _scheme_write(path, data), "write", path)
        return
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, ".%s.tmp.%d" % (os.path.basename(path), os.getpid()))

    def attempt():
        try:
            with open(tmp, "wb") as fh:
                fh.write(data)
                if _FAULT_HOOK is not None:
                    _FAULT_HOOK("written", path)
                if fsync:
                    fh.flush()
                    os.fsync(fh.fileno())
            if _FAULT_HOOK is not None:
                _FAULT_HOOK("synced", path)
            os.replace(tmp, path)
            if _FAULT_HOOK is not None:
                _FAULT_HOOK("replaced", path)
            if fsync:
                _fsync_dir(d)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    retry_io(attempt, "atomic_write", path)


def _scheme_write(path: str, data: bytes) -> None:
    with open_file(path, "wb") as fh:
        fh.write(data)


_CRC_TRAILER = b"\nCRC32 "


def append_crc_trailer(data: bytes) -> bytes:
    """``data`` plus a ``\\nCRC32 xxxxxxxx nnnnnnnnnnnn\\n`` trailer: the
    checksum and byte length of everything before it, so that truncation
    and bit flips are both detected."""
    return data + _CRC_TRAILER + (
        "%08x %012d\n" % (zlib.crc32(data) & 0xFFFFFFFF, len(data))
    ).encode("ascii")


def check_crc_trailer(blob: bytes) -> bytes:
    """The payload of ``blob`` without the trailer of
    :func:`append_crc_trailer`; ``ValueError`` naming what failed (trailer
    missing, length mismatch, checksum mismatch)."""
    tail_len = len(_CRC_TRAILER) + 8 + 1 + 12 + 1
    if len(blob) < tail_len or not blob.endswith(b"\n"):
        raise ValueError("checkpoint trailer missing (file truncated?)")
    payload, trailer = blob[:-tail_len], blob[-tail_len:]
    if not trailer.startswith(_CRC_TRAILER):
        raise ValueError("checkpoint trailer missing (file truncated?)")
    try:
        crc_hex, length = trailer[len(_CRC_TRAILER):].split()
        want_crc = int(crc_hex, 16)
        want_len = int(length)
    except ValueError:
        raise ValueError("checkpoint trailer malformed")
    if want_len != len(payload):
        raise ValueError("checkpoint length mismatch: trailer says %d bytes, "
                         "file has %d (truncated or concatenated)"
                         % (want_len, len(payload)))
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != want_crc:
        raise ValueError("checkpoint CRC32 mismatch: %08x != %08x (corrupt)"
                         % (got, want_crc))
    return payload


# ---- scheme registry ----

def register_scheme(prefix: str, opener: Callable) -> None:
    """Register ``opener(path, mode) -> file object`` for ``prefix://``."""
    _SCHEMES[prefix] = opener


def _hdfs_open(path: str, mode: str):
    try:
        from pyarrow import fs as pafs
    except ImportError as exc:
        raise OSError(
            "hdfs:// paths need pyarrow (the reference builds with USE_HDFS "
            "and libhdfs; here pyarrow.fs provides the client)") from exc
    hdfs, rel = pafs.FileSystem.from_uri(path)
    if "r" in mode:
        stream = hdfs.open_input_stream(rel)
    else:
        stream = hdfs.open_output_stream(rel)
    if "b" not in mode:
        import io
        return io.TextIOWrapper(stream)
    return stream


register_scheme("hdfs", _hdfs_open)


def open_file(path: str, mode: str = "r"):
    """Open ``path`` locally, or through the opener registered for its
    ``scheme://``."""
    if "://" in path:
        scheme = path.split("://", 1)[0]
        opener = _SCHEMES.get(scheme)
        if opener is None:
            raise OSError("No file-IO handler registered for scheme %r "
                          "(register_scheme)" % scheme)
        return opener(path, mode)
    return open(path, mode)


def exists(path: str) -> bool:
    """Whether ``path`` exists; a ``scheme://`` path exists when its opener
    opens it for reading."""
    if "://" in path:
        try:
            with open_file(path, "rb"):
                return True
        except OSError:
            return False
    return os.path.exists(path)
