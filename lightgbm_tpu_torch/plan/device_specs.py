"""Per-card hardware tables: one source of truth for the planner and MFU.

The counterpart of ``lightgbm_tpu/plan/device_specs.py`` (:1-139).  The
port runs on NVIDIA cards only, so its table holds NVIDIA rows: SM count,
shared memory a block may take, device-memory rate and the peak rate of the
units the port's kernels accumulate on.  The exact histogram kernels add f64
partials on the CUDA cores and the integer ones add int32 on the CUDA cores;
neither runs on the tensor cores, so the 989 TFLOP/s bf16 tensor peak is not
their yardstick.

An unknown kind (the CPU, a card without a row) keeps ``None`` peaks
(device_specs.py:64-66 of the JAX package): utilization ratios stay
``None`` rather than a made-up number (``obs/mfu.py``).

Dependency-free: ``core/histogram.py`` imports this module at load, so it
imports neither torch at module level nor anything of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class DeviceSpec(NamedTuple):
    """Hardware envelope of one card kind."""
    kind: str                     # lowercase substring of the card's name
    sm_count: Optional[int]       # streaming multiprocessors
    smem_block_bytes: Optional[int]  # shared memory one block may take
    hbm_bw: Optional[float]       # device-memory bytes/s
    peak_ops: Optional[float]     # f64 or int32 adds/s on the CUDA cores


# NVIDIA H100 SXM5 80 GB (torch.cuda.get_device_name: "NVIDIA H100 80GB
# HBM3"): 132 SMs and 227 KB of shared memory a block (Hopper tuning
# guide); 3.35 TB/s of HBM3 and FP64 34 TFLOP/s outside the tensor cores
# (H100 data sheet, SXM column).  The FP64 figure counts an FMA as two
# operations (64 FP64 lanes x 132 SMs x 2 x ~1.98 GHz), so a plain add runs
# at half of it; the SM's 64 INT32 lanes (Hopper architecture whitepaper)
# give the integer kernels' adds the same rate.
H100_SM_COUNT = 132
H100_SMEM_BLOCK_BYTES = 227 * 1024          # 232,448 B
H100_HBM_BW = 3.35e12
H100_PEAK_ADDS = 34e12 / 2
# NVIDIA H100 PCIe 80 GB: 114 SMs, 2.0 TB/s HBM2e, FP64 26 TFLOP/s (data
# sheet, PCIe column)
H100_PCIE_SM_COUNT = 114

# matched in order against the lowercased card name: the PCIe row before
# the SXM one, whose "h100" also matches "nvidia h100 pcie"
SPECS = (
    DeviceSpec("h100 pcie", H100_PCIE_SM_COUNT, H100_SMEM_BLOCK_BYTES,
               2.0e12, 26e12 / 2),
    DeviceSpec("h100", H100_SM_COUNT, H100_SMEM_BLOCK_BYTES, H100_HBM_BW,
               H100_PEAK_ADDS),
)

DEFAULT_SPEC = DeviceSpec("unknown", None, None, None, None)

# the integer histogram kernel's target blocks: two a streaming
# multiprocessor of the H100 (core/histogram.py int_hist_grid)
INT_FILL_BLOCKS = 2 * H100_SM_COUNT


def spec_for(device_kind: Optional[str]) -> DeviceSpec:
    """The row of ``device_kind`` (substring match, first hit), or
    :data:`DEFAULT_SPEC`; never None."""
    kind = str(device_kind or "").lower()
    for spec in SPECS:
        if spec.kind in kind:
            return spec
    return DEFAULT_SPEC


_current_kind_cache: Optional[str] = None


def current_device_kind(device=None) -> str:
    """The lowercased name of the card ``device`` would run on (the first
    CUDA card when ``device`` is None and CUDA is available), or ``"cpu"``
    for a CPU device or a host without CUDA.  The card's name is memoized:
    the card set of a process does not change."""
    global _current_kind_cache
    if device is not None and str(getattr(device, "type", device)) == "cpu":
        return "cpu"
    if _current_kind_cache is not None:
        return _current_kind_cache
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    _current_kind_cache = str(torch.cuda.get_device_name(0)).lower()
    return _current_kind_cache


def device_peaks(device_kind: Optional[str]):
    """{"bw": bytes/s, "ops": adds/s, "kind": str} of a kind with published
    peaks, else None (the CPU, unknown cards)."""
    spec = spec_for(device_kind)
    if spec.hbm_bw is None or spec.peak_ops is None:
        return None
    return {"bw": spec.hbm_bw, "ops": spec.peak_ops,
            "kind": str(device_kind).lower()}
