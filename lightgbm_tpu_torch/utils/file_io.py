"""Atomic file writes.

Carries ``atomic_write`` of ``lightgbm_tpu/utils/file_io.py`` for the PyTorch
port (which imports nothing of the JAX package), without that module's
retries, fault hooks and remote schemes."""
from __future__ import annotations

import os


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
