"""Device selection and per-kernel launch counters.

The device rule: every entry point of the port takes ``device=`` and defaults
to ``cuda``.  When CUDA is missing and the caller did not ask for the CPU,
the entry point raises; it never falls back to the CPU on its own.  (LightGBM's
``device_type`` config key is not read for this: its upstream default is
``cpu``.)

The launch counters are plain integers, one per hand-written kernel family.
A kernel wrapper adds one where it launches its kernel and nowhere else, so a
run can show that its main path went through the kernels
(:func:`reset_launches` before the run, :func:`launches` after it).  The
split passes also count, at the same place, the routes their scal rows take
(:func:`route_launches`): launches with a window that unfolds an EFB group
column (``use_unfold``) or routes by a category bitset (``is_cat``), and the
number of such windows.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

DeviceLike = Union[str, torch.device, None]

KERNELS = ("histogram", "partition", "histogram_int", "partition_level",
           "histogram_masked")

_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
SPLIT_KERNELS = ("partition", "partition_level")
ROUTES = ("unfold", "categorical")
_ROUTES: Dict[str, Dict[str, int]] = {
    k: {c: 0 for r in ROUTES for c in (r, r + "_windows")}
    for k in SPLIT_KERNELS}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable, so a
    caller that did not pass ``device="cpu"`` never runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    return dev


def count_launch(kernel: str) -> None:
    """Record one launch of ``kernel`` (called by its wrapper only)."""
    _LAUNCHES[kernel] += 1


def count_routes(kernel: str, unfold: int, categorical: int) -> None:
    """Record the routes of one launch of split pass ``kernel`` (called by
    its wrapper only, beside :func:`count_launch`): ``unfold`` and
    ``categorical`` are the numbers of its windows with ``use_unfold = 1``
    and with ``is_cat = 1``."""
    for route, windows in (("unfold", unfold), ("categorical", categorical)):
        _ROUTES[kernel][route] += int(windows > 0)
        _ROUTES[kernel][route + "_windows"] += int(windows)


def launches() -> Dict[str, int]:
    """Launch counts since the last :func:`reset_launches`."""
    return dict(_LAUNCHES)


def route_launches() -> Dict[str, Dict[str, int]]:
    """Per split pass: launches that unfolded a group column or routed by a
    bitset, and their windows, since the last :func:`reset_launches`."""
    return {k: dict(v) for k, v in _ROUTES.items()}


def reset_launches() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
    for counts in _ROUTES.values():
        for c in counts:
            counts[c] = 0


def cuda_stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle.

    ``torch._C._cuda_getCurrentRawStream`` returns the handle without
    building a ``torch.cuda.Stream`` (a few microseconds a kernel call)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Validate what a kernel wrapper passes as a raw pointer."""
    if not t.is_cuda:
        raise ValueError("%s is on %s; the kernel takes a CUDA tensor"
                         % (name, t.device))
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("%s must have %d dims, got shape %s"
                         % (name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
