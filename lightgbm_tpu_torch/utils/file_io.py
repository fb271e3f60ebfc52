"""Atomic file writes and the CRC32 trailer of checkpoint files.

Carries ``atomic_write``, ``append_crc_trailer`` and ``check_crc_trailer`` of
``lightgbm_tpu/utils/file_io.py`` (:203, :212) for the PyTorch port (which
imports nothing of the JAX package), without that module's retries, fault
hooks and remote schemes."""
from __future__ import annotations

import os
import zlib


def atomic_write(path: str, data) -> None:
    """Write ``data`` (str or bytes) to ``path`` through a temporary file in
    the same directory, fsync and rename, so readers never see a partial
    file."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, ".%s.tmp.%d" % (os.path.basename(path), os.getpid()))
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


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
