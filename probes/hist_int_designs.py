"""Time the integer histogram kernel (``lightgbm_tpu_torch/csrc/hist_int.cuh``)
beside two designs that lost to it on an H100 (``probes/hist_int_designs.cu``):
one packed 64-bit shared atomic per (row, feature) instead of two int32 ones,
and int32 partials of the segments summed by a second pass instead of int64
global atomics into an accumulator.  Each design runs the library kernel's
grid (``int_hist_grid``) and is held bit for bit against it first.

The partials design differs from the library's only for a window of several
segments, so it is timed only where the grid has more than one.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/hist_int_designs.py

Times are queued device times (``chip_smoke.queued_ms``) of one call on a
random quantized u8 row store of 28 features and 256 bins.  The last line is
a JSON object of them, in ms, by row count.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from lightgbm_tpu_torch import kernels  # noqa: E402
from lightgbm_tpu_torch.core import histogram as H  # noqa: E402
from lightgbm_tpu_torch.device import cuda_stream_ptr  # noqa: E402

F, B = 28, 256
COUNTS = (1 << 20, 20000, 1000)


def build_probe() -> ctypes.CDLL:
    out = ROOT / "build" / "probes" / "libhist_int_designs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = ([kernels._nvcc()] + kernels.NVCC_FLAGS
           + ["-I", str(kernels.CSRC), "-o", str(out),
              str(ROOT / "probes" / "hist_int_designs.cu")])
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_hist_int.argtypes = [P, I, I, I, I, LL, I, I, I, P, P, P, P]
    lib.probe_hist_int.restype = I
    return lib


def design_ms(lib, rows, voff, count, pack, partials, want) -> float:
    """Queued time of one design over rows [0, count); raises unless it
    gives the library kernel's bits ``want``."""
    ft, nseg = H.int_hist_grid(count, F, B)
    out = torch.empty((F, 2, B), dtype=torch.float32, device=rows.device)
    part = (torch.empty((nseg, F, 2, B), dtype=torch.int32,
                        device=rows.device) if partials else None)
    acc = torch.empty((F, 2, B), dtype=torch.int64, device=rows.device)

    def run():
        err = lib.probe_hist_int(
            rows.data_ptr(), rows.shape[1], voff, F, B, count, nseg, ft,
            int(pack), H.data_ptr(part), acc.data_ptr(), out.data_ptr(),
            cuda_stream_ptr(rows))
        kernels.check(err, "probe_hist_int")
    run()
    if not torch.equal(out, want):
        raise AssertionError("design pack=%s partials=%s differs at %d rows"
                             % (pack, partials, count))
    return chip_smoke.queued_ms(run)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(chip_smoke.gpu_name_and_power())
    lib = build_probe()
    rows, voff = chip_smoke.make_store(COUNTS[0], F, B, quantized=True,
                                       device="cuda", seed=13)
    kw = dict(num_features=F, voff=voff, quantized=True)
    result = {}
    for count in COUNTS:
        ft, nseg = H.int_hist_grid(count, F, B)
        want = H.histogram_rows(rows, B, 0, count, **kw)
        times = {"library": chip_smoke.queued_ms(
            lambda: H.histogram_rows(rows, B, 0, count, **kw))}
        times["packed_u64_atomics"] = design_ms(lib, rows, voff, count, True,
                                                False, want)
        times["int32_partials"] = (design_ms(lib, rows, voff, count, False,
                                             True, want)
                                   if nseg > 1 else None)
        print("%8d rows (%d-feature tiles, %d segments): %s" % (
            count, ft, nseg, ", ".join(
                "%s %s" % (k, "n/a (one segment)" if v is None
                           else "%.4f ms" % v) for k, v in times.items())))
        result[count] = times
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
