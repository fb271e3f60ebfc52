"""Build and load the hand-written CUDA kernels (``lightgbm_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``.
The libraries are built at first use into ``build/kernels/`` at the repository
root, named by a hash of the sources so an edited source is rebuilt; all
sources compile in parallel, one ``nvcc`` each.  Nothing is built or loaded
at import time.  A build (or a load of libraries built before) is the port's
``kernels`` miss in ``obs.recompile``; with a telemetry run active its
seconds go to the compile accounting as ``kernels|nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("histogram", "partition", "histogram_int", "partition_level",
           "histogram_masked")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the exported entry points (pointers and streams as void*;
# ctypes would cut an untyped pointer to 32 bits)
SIGNATURES = {
    "histogram": {"lgbt_hist_rows": [_P, _I, _I, _I, _I, _I, _I, _I, _LL, _LL,
                                     _I, _P, _P, _P],
                  "lgbt_hist_rows_window": [_P, _I, _I, _I, _I, _I, _I, _I,
                                            _P, _LL, _I, _P, _P, _P]},
    "partition": {"lgbt_partition_hist": [_P, _P, _I, _P, _LL, _LL, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                          _I, _I, _I, _P, _P, _P],
                  "lgbt_partition_window": [_P, _P, _I, _P, _LL, _I, _I, _I,
                                            _I, _I, _I, _I, _I, _I, _P, _P,
                                            _P, _I, _I, _I, _I, _P, _P, _P,
                                            _P]},
    "histogram_int": {"lgbt_hist_rows_int": [_P, _I, _I, _I, _I, _I, _I, _I,
                                             _LL, _LL, _I, _I, _P, _P, _P],
                      "lgbt_hist_rows_int_window": [_P, _I, _I, _I, _I, _I,
                                                    _I, _I, _P, _I, _I, _P,
                                                    _P, _P]},
    "partition_level": {"lgbt_partition_level": [_P, _P, _I, _P, _I, _I, _I,
                                                 _I, _I, _I, _I, _I, _I, _I,
                                                 _I, _I, _I, _I, _I, _P, _P,
                                                 _P, _P],
                        "lgbt_partition_level_window": [_P, _P, _I, _P]
                        + [_I] * 18 + [_P] * 6},
    "histogram_masked": {"lgbt_hist_masked": [_P, _LL, _I, _I, _P, _LL, _I,
                                              _I, _LL, _LL, _I, _P, _P, _P]},
}


class KernelBuildError(RuntimeError):
    pass


class _Libraries:
    """The loaded libraries and what building them cost (one per process)."""

    def __init__(self) -> None:
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds: Optional[float] = None
        self.ptxas_log: Dict[str, str] = {}


_STATE = _Libraries()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found (looked on PATH and in "
                               "/usr/local/cuda/bin)")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / ("%s.cu" % name)]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by name.

    ``nvcc`` runs once per source, all started together.  A compile failure
    raises :class:`KernelBuildError` with the compiler's output."""
    if _STATE.libs:
        return _STATE.libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    targets = {n: BUILD_DIR / ("lib%s_%s.so" % (n, _digest(n))) for n in SOURCES}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / ("%s.cu" % name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        _STATE.ptxas_log[name] = out
        if proc.returncode != 0:
            errors.append("nvcc %s.cu failed (rc %d):\n%s"
                          % (name, proc.returncode, out))
        else:
            os.replace(tmp, so)
    if errors:
        raise KernelBuildError("\n".join(errors))
    libs = {}
    for name, so in targets.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[name] = lib
    _STATE.libs = libs
    _STATE.build_seconds = time.perf_counter() - t0
    from ..obs import active as _telemetry_active
    from ..obs import compile as _compile
    from ..obs import recompile as _recompile
    _recompile.record("kernels", "nvcc" if procs else "load")
    tele = _telemetry_active()
    if tele is not None:
        _compile.note_dispatch(tele, "kernels", "nvcc",
                               _STATE.build_seconds, 1)
    return libs


def library(name: str) -> ctypes.CDLL:
    return build()[name]


def build_seconds() -> Optional[float]:
    return _STATE.build_seconds


def ptxas_log() -> Dict[str, str]:
    return dict(_STATE.ptxas_log)


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d" % (what, err))
