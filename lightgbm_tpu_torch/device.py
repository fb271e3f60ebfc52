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
column (``use_unfold``), routes by a category bitset (``is_cat``) or
histograms a feature window (the trailing ``hist_feature_begin`` of a
feature-parallel rank), and the number of such windows.  The split pass
with its window in device memory (``core/partition.py``
``partition_hist_window``) cannot read its scal row on the host, so its
kernel adds its routes to three counters on the card
(:func:`route_counter`), which :func:`route_launches` reads back; the level
pass with its windows in device memory (``partition_hist_level_window``)
adds its launches and windows to four (:func:`level_route_counter`).
"""
from __future__ import annotations

from typing import Dict, Union

import torch

DeviceLike = Union[str, torch.device, None]

# "histogram_window": the row-store histogram with its window in device
# memory (exact or integer), the histogram pool's rebuilt parent
KERNELS = ("histogram", "partition", "histogram_int", "partition_level",
           "histogram_masked", "histogram_window")

_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
SPLIT_KERNELS = ("partition", "partition_level")
ROUTES = ("unfold", "categorical", "feature_window")
_ROUTES: Dict[str, Dict[str, int]] = {
    k: {c: 0 for r in ROUTES for c in (r, r + "_windows")}
    for k in SPLIT_KERNELS}
# per CUDA device: int64 [3], the device-window launches that unfolded a
# group column, that routed by a bitset and that histogrammed a feature
# window
_ROUTE_COUNTERS: Dict[torch.device, torch.Tensor] = {}
# per CUDA device: int64 [4], the device-window level passes that unfolded
# a group column and their windows, that routed by a bitset and theirs
_LEVEL_ROUTE_COUNTERS: Dict[torch.device, torch.Tensor] = {}


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


def to_device_async(a, device: torch.device) -> torch.Tensor:
    """The numpy array ``a`` on ``device`` without the host waiting for
    the card: on CUDA through a pinned staging copy and a non-blocking
    transfer (a copy from pageable memory blocks the host until the card
    has run everything queued before it)."""
    import numpy as np
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def count_launch(kernel: str) -> None:
    """Record one launch of ``kernel`` (called by its wrapper only)."""
    _LAUNCHES[kernel] += 1


def count_routes(kernel: str, unfold: int, categorical: int,
                 feature_window: int = 0) -> None:
    """Record the routes of one launch of split pass ``kernel`` (called by
    its wrapper only, beside :func:`count_launch`): ``unfold``,
    ``categorical`` and ``feature_window`` are the numbers of its windows
    with ``use_unfold = 1``, with ``is_cat = 1`` and with a
    ``hist_feature_begin``."""
    for route, windows in (("unfold", unfold), ("categorical", categorical),
                           ("feature_window", feature_window)):
        _ROUTES[kernel][route] += int(windows > 0)
        _ROUTES[kernel][route + "_windows"] += int(windows)


def route_counter(device: torch.device) -> torch.Tensor:
    """The device-window split pass's route counters on CUDA ``device``
    (int64 [3]: launches of a live window with ``use_unfold = 1``, with
    ``is_cat = 1``, with a feature window), which its kernel increments;
    made at the first call (so before any CUDA graph capture of a step)."""
    t = _ROUTE_COUNTERS.get(device)
    if t is None:
        t = _ROUTE_COUNTERS[device] = torch.zeros(3, dtype=torch.int64,
                                                  device=device)
    return t


def level_route_counter(device: torch.device) -> torch.Tensor:
    """The device-window level pass's route counters on CUDA ``device``
    (int64 [4]: launches with a live window of ``use_unfold = 1`` and such
    windows, launches with a live window of ``is_cat = 1`` and such
    windows), which its kernel increments; made at the first call."""
    t = _LEVEL_ROUTE_COUNTERS.get(device)
    if t is None:
        t = _LEVEL_ROUTE_COUNTERS[device] = torch.zeros(
            4, dtype=torch.int64, device=device)
    return t


def launches() -> Dict[str, int]:
    """Launch counts since the last :func:`reset_launches`."""
    return dict(_LAUNCHES)


def route_launches() -> Dict[str, Dict[str, int]]:
    """Per split pass: launches that unfolded a group column, routed by a
    bitset or histogrammed a feature window, and their windows, since the
    last :func:`reset_launches`.  Reads the device-window counters back
    (:func:`route_counter`, :func:`level_route_counter`): a device->host
    transfer per counter."""
    out = {k: dict(v) for k, v in _ROUTES.items()}
    for t in _ROUTE_COUNTERS.values():
        unfold, categorical, fwin = (int(v) for v in t.cpu())
        part = out["partition"]
        for route, n in (("unfold", unfold), ("categorical", categorical),
                         ("feature_window", fwin)):
            part[route] += n
            part[route + "_windows"] += n
    for t in _LEVEL_ROUTE_COUNTERS.values():
        counts = [int(v) for v in t.cpu()]
        level = out["partition_level"]
        for i, route in enumerate(("unfold", "categorical")):
            level[route] += counts[2 * i]
            level[route + "_windows"] += counts[2 * i + 1]
    return out


def reset_launches() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
    for counts in _ROUTES.values():
        for c in counts:
            counts[c] = 0
    for t in list(_ROUTE_COUNTERS.values()) + list(
            _LEVEL_ROUTE_COUNTERS.values()):
        t.zero_()


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
