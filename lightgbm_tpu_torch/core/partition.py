"""Fused split pass: route + stable partition + smaller-child histogram.

Counterpart of ``lightgbm_tpu/core/partition.py`` ``partition_hist_pallas``
(its small-window and pipelined kernels; the TPU's size buckets are a TPU-ism
and one implementation serves every window here) with the output contract of
``partition_hist_xla``:

    partition_hist(rows, scal, ...) -> (rows_new, hist [F, 2, B], nl)

``scal`` is the scalar row of partition.py:1030-1037, i32
``[12 + num_bins // 32]`` or ``[13 + num_bins // 32]``: (window_begin,
window_count, group_col, threshold_bin, default_left, missing_type,
num_bin_f, default_bin, is_cat, hist_left_side, use_unfold, efb_offset,
*cat_bitset_words[, hist_feature_begin]).  The window ``[wb, wb + wc)`` is
stably partitioned (left rows first), ``nl`` is the left count, and ``hist``
is the histogram of the child that ``hist_left_side`` names, already folded
to ``[F, 2, B]``.  The optional trailing ``hist_feature_begin`` (the feature
window of a feature-parallel rank, feature_parallel_tree_learner.cpp:33-52)
makes ``hist`` cover the columns ``[f_begin, f_begin + num_features)`` of
the store only, while the rows are routed and partitioned on the whole
store as without it; absent, it is 0.  ``missing_type`` is the kernel's own
code, as ``_route_tile`` reads it: 1 routes the NaN bin ``num_bin_f - 1``, 2
the default (zero) bin, anything else nothing; it is NOT the ``MissingType``
enum (ZERO = 1, NAN = 2) -- :func:`scal_missing_code` maps one to the other.

Two versions of the one function:

- :func:`partition_hist_plain`: mask + cumsum + index scatter in plain
  PyTorch, as ``partition_hist_xla`` does.  Returns a new tensor.
- :func:`partition_hist_cuda`: the wrapper of ``csrc/partition.cu``.  It
  partitions IN PLACE through a scratch window (``rows`` is returned,
  updated), as the TPU kernel aliased ``rows``; rows outside the window are
  never written.

:func:`partition_hist` takes the plain version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.

The leaf-wise build keeps its whole state on the card, so its split pass
takes the window as the TPU kernel takes it (scalar prefetch,
partition.py:1090-1093 and :1130-1133), from a scal row in device memory
that the host never reads::

    partition_hist_window(rows, scal, work, ...) -> (hist [F, 2, B], nl [1])

``scal`` is an int32 tensor on the store's device, with or without the
trailing ``hist_feature_begin`` (the kernel's child histogram reads it on
the device, as it reads the window), and ``rows`` is partitioned in
place.  :func:`window_workspace` sizes the launch's buffers once for the
largest window (``work``): the grid, the
scratch window, the tile counts and the histogram's partials.  A window of
``wc = 0`` (a dead step of the build) leaves the store as it is, with a
zero histogram and ``nl = 0``.  On the same window it equals
:func:`partition_hist` bit for bit: the exact child histogram's blocks take
from ``wc`` the segments that ``_segments`` gives the host-window launch.
Its plain version, :func:`partition_hist_window_plain`, is
:func:`partition_hist_plain` on the window's rows, which reads the scal
row on the host.  With ``quantized=True``
(``hist_precision=quantized``) the child histogram is the exact integer sum of
the integer-valued g/h (``histogram.histogram_plain_int``, or the integer
kernel ``csrc/hist_int.cuh`` on the card).

The level-batched pass, the counterpart of ``partition_hist_level_pallas``
(partition.py:1191-1218), runs the same function over every window of a tree
level at once, from one row store into another::

    partition_hist_level(src, dst, scals[G, S], ...) -> (hist [G, F, 2, B],
                                                         nl [G])

Each window ``[wb, wb + wc)`` of ``src`` is stably partitioned into the same
rows of ``dst``; no other row of either store is written, and nothing is
copied back (the learner alternates the two stores by depth,
``core/tree_learner.py``).  The windows must be pairwise disjoint; a slot
with ``wc = 0`` writes nothing and has a zero histogram and ``nl = 0``; the
windows of ``dst`` equal G sequential :func:`partition_hist` calls on
``src`` bit for bit.  Its plain version is those G plain calls, one window
each; :func:`partition_hist_level_cuda` is the wrapper of
``csrc/partition_level.cu``, one call per level whatever the window sizes.
The TPU's per-level bucket classes (``level_plan``/``fused_bucket_plan``) and
the per-class window masking (tree_learner.py:1176-1202) were a TPU cost
model and have no counterpart here.

Level growth on the device takes its windows as the TPU kernel takes them,
from scal rows in device memory that the host never reads::

    partition_hist_level_window(src, dst, scals, work, ...)
        -> (hist [G, F, 2, B], nl [G])

``scals`` is an int32 [G, S] tensor on the stores' device.  The kernel
(``lgbt_partition_level_window``) builds on the card the block and
histogram maps that :func:`level_meta` builds on the host, and every launch
is sized once for a bound (:func:`level_bounds`, :func:`level_workspace`),
so a CUDA graph can capture it; exact, each window keeps ``_segments`` of
its rows, so it equals :func:`partition_hist_level` bit for bit.  Its plain
version, :func:`partition_hist_level_window_plain`, reads no scal row on
the host either: each position finds its window through
:func:`level_meta_device`'s block map, and each window's histogram is
summed as :func:`partition_hist_level_plain` sums it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..device import (check_tensor, count_launch, count_routes,
                      cuda_stream_ptr, level_route_counter, route_counter)
from ..io.binning import MissingType
from ..plan import planner as _planner
from ..plan import state as _plan_state
from ..utils.log import Log
from .histogram import (_INT_BLOCK_ROWS, _INT_HIST_SMEM, _INT_SEG_ROWS,
                        _INT_SMALL_ROWS, _INT_SMALL_SEG_ROWS, _SEG_ROWS,
                        _hist_sums, _row_chunks, _segments, check_hist_shape,
                        check_int_segments, data_ptr, exact_partials,
                        histogram_rows_plain, int_accumulator, int_hist_grid,
                        int_hist_grids, rows_split, segment_cap)

SCAL_HEAD = 12

ScalLike = Union[torch.Tensor, Sequence[int]]

SCAL_MISSING_NAN = 1     # scal[5]: the NaN bin (num_bin - 1) is missing
SCAL_MISSING_ZERO = 2    # scal[5]: the default bin is missing


def scal_missing_code(missing_type: int) -> int:
    """``MissingType`` (NONE 0, ZERO 1, NAN 2) -> the scal row's code."""
    return {int(MissingType.NAN): SCAL_MISSING_NAN,
            int(MissingType.ZERO): SCAL_MISSING_ZERO}.get(int(missing_type), 0)


def part_tile_rows(row_width: int) -> int:
    """Rows per block of the split pass's kernels for rows of
    ``row_width`` bytes: the active plan's ``part_block_bytes`` (128 KiB in
    the analytic plan, ``plan/state.py``) over the width, clamped to [32,
    2048] (2048: kPartMaxTile, csrc/part_common.cuh); analytic: 2048 at W =
    64, 1024 at W = 128, 64 at W = 2048."""
    return _planner.part_tile(_plan_state.part_block_bytes(), row_width)


def part_blocks(count, row_width: int):
    """Blocks of the split pass over a window of ``count`` rows (an int or
    an int array)."""
    return -(-count // part_tile_rows(row_width))


def _scal_host(scal: ScalLike, num_bins: int) -> torch.Tensor:
    s = torch.as_tensor(scal, dtype=torch.int32).cpu().reshape(-1)
    base = SCAL_HEAD + num_bins // 32
    if s.numel() not in (base, base + 1):
        raise ValueError("scal needs %d entries (12 + num_bins // 32), or %d "
                         "with the feature window, got %d"
                         % (base, base + 1, s.numel()))
    return s


def scal_feature_begin(s: torch.Tensor, num_bins: int) -> int:
    """The histogram's first column: the scal row's optional trailing
    ``hist_feature_begin``, else 0."""
    base = SCAL_HEAD + num_bins // 32
    return int(s[base]) if s.numel() > base else 0


def check_feature_window(f_begin: int, num_features: int, voff: int,
                         bpc: int, packed: bool) -> None:
    """Refuse a feature window that starts below column 0 or reaches past
    the bin bytes (into the values at ``voff``)."""
    end = ((num_features + f_begin + 1) // 2 if packed
           else (num_features + f_begin) * bpc)
    if f_begin < 0 or end > voff:
        raise ValueError("feature window [%d, %d) outside the bin columns "
                         "(values at byte %d)" % (f_begin,
                                                 f_begin + num_features, voff))


def extract_column(rows: torch.Tensor, gcol: int, bpc: int,
                   packed: bool) -> torch.Tensor:
    """One bin column of the row store as i64."""
    if packed:
        byte = rows[:, gcol // 2].long()
        return (byte >> 4) & 15 if gcol % 2 == 1 else byte & 15
    if bpc == 2:
        return rows[:, 2 * gcol].long() | (rows[:, 2 * gcol + 1].long() << 8)
    return rows[:, gcol].long()


def route_left(col: torch.Tensor, scal: torch.Tensor,
               num_bins: int) -> torch.Tensor:
    """go-left decision of each bin code (``_route_tile`` semantics: EFB
    unfold, NaN bin = nb - 1, zero bin = default_bin, categorical bitset)."""
    thr, dleft, mt, nb, dbin, is_cat, unf, eoff = [
        int(scal[i]) for i in (3, 4, 5, 6, 7, 8, 10, 11)]
    if unf == 1:
        col = torch.where((col >= eoff) & (col <= eoff + nb - 2),
                          col - eoff + 1, torch.zeros_like(col))
    if is_cat == 1:
        words = scal[SCAL_HEAD:SCAL_HEAD + num_bins // 32].long() & 0xFFFFFFFF
        words = words.to(col.device)
        word = words[torch.clamp(col >> 5, 0, words.numel() - 1)]
        return ((word >> (col & 31)) & 1) == 1
    if mt == SCAL_MISSING_NAN:
        missing = col == nb - 1
    elif mt == SCAL_MISSING_ZERO:
        missing = col == dbin
    else:
        missing = torch.zeros_like(col, dtype=torch.bool)
    return torch.where(missing, torch.full_like(missing, dleft == 1),
                       col <= thr)


def partition_hist_plain(rows: torch.Tensor, scal: ScalLike, *,
                         num_features: int, num_bins: int, voff: int,
                         bpc: int = 1, packed: bool = False,
                         quantized: bool = False):
    """Plain PyTorch version (the ``partition_hist_xla`` contract)."""
    s = _scal_host(scal, num_bins)
    f_begin = scal_feature_begin(s, num_bins)
    wb, wc, gcol, hist_left = int(s[0]), int(s[1]), int(s[2]), int(s[9])
    n = rows.shape[0]
    dev = rows.device
    gl = route_left(extract_column(rows, gcol, bpc, packed), s, num_bins)
    iota = torch.arange(n, device=dev)
    inw = (iota >= wb) & (iota < wb + wc)
    sel_l = gl & inw
    sel_r = ~gl & inw
    nl = int(sel_l.sum())
    cl = torch.cumsum(sel_l.long(), 0)
    cr = torch.cumsum(sel_r.long(), 0)
    dest = torch.where(sel_l, wb + cl - 1,
                       torch.where(sel_r, wb + nl + cr - 1, iota))
    rows_new = torch.empty_like(rows)
    rows_new[dest] = rows
    side = sel_l if hist_left == 1 else sel_r
    hist = histogram_rows_plain(
        rows, num_bins, wb, wc, num_features=num_features, voff=voff,
        bpc=bpc, packed=packed, f_begin=f_begin, quantized=quantized,
        weight=side[wb:wb + wc].to(torch.float32))
    return rows_new, hist, torch.tensor([nl], dtype=torch.int32, device=dev)


def _check_store(rows: torch.Tensor, voff: int, num_features: int,
                 num_bins: int) -> None:
    check_tensor(rows, "rows", torch.uint8, ndim=2)
    W = rows.shape[1]
    if W % 16 or voff % 4 or voff + 8 > W:
        raise ValueError("row width %d must be a multiple of 16 with the "
                         "values 4-aligned inside it (voff %d)" % (W, voff))
    check_hist_shape(num_features, num_bins)


def partition_hist_cuda(rows: torch.Tensor, scal: ScalLike, *,
                        num_features: int, num_bins: int, voff: int,
                        bpc: int = 1, packed: bool = False,
                        quantized: bool = False):
    """Launch the hand-written fused split pass (``csrc/partition.cu``);
    partitions ``rows`` in place and returns it."""
    from .. import kernels
    _check_store(rows, voff, num_features, num_bins)
    s = _scal_host(scal, num_bins)
    f_begin = scal_feature_begin(s, num_bins)
    check_feature_window(f_begin, num_features, voff, bpc, packed)
    n, W = rows.shape
    wb, wc = int(s[0]), int(s[1])
    if not 0 <= wb <= wb + wc <= n:
        raise ValueError("window [%d, %d) outside %d rows" % (wb, wb + wc, n))
    dev = rows.device
    hist = torch.empty((num_features, 2, num_bins), dtype=torch.float32,
                       device=dev)
    nl = torch.empty((1,), dtype=torch.int32, device=dev)
    if wc == 0:
        # identity partition, zero histogram: nothing to launch
        hist.zero_()
        nl.zero_()
        return rows, hist, nl
    # from pinned memory, so that the host does not wait for the stream
    # (the kernels read the head and the bitset words; the window's start
    # rides as an argument)
    scal_dev = s.pin_memory().to(dev, non_blocking=True)
    scratch = torch.empty((wc, W), dtype=torch.uint8, device=dev)
    tile = part_tile_rows(W)
    nblk = part_blocks(wc, W)
    blk = torch.empty((nblk,), dtype=torch.int32, device=dev)
    win = torch.empty((2,), dtype=torch.int32, device=dev)
    if quantized:
        ft, nseg = int_hist_grid(wc, num_features, num_bins)
        check_int_segments(wc, nseg)
        partial = int_accumulator(nseg, num_features, num_bins, dev)
    else:
        ft, nseg = 0, _segments(wc, num_features, num_bins)
        partial = exact_partials(nseg, num_features, num_bins, dev)
    lib = kernels.library("partition")
    err = lib.lgbt_partition_hist(
        rows.data_ptr(), scratch.data_ptr(), W, scal_dev.data_ptr(), wb, wc,
        bpc, int(packed), num_bins // 32, num_features, num_bins, f_begin,
        voff, nblk, tile, blk.data_ptr(), win.data_ptr(), nl.data_ptr(), nseg,
        ft, int(quantized), data_ptr(partial), hist.data_ptr(),
        cuda_stream_ptr(rows))
    count_launch("partition")
    count_routes("partition", int(s[10] == 1), int(s[8] == 1),
                 int(s.numel() > SCAL_HEAD + num_bins // 32))
    kernels.check(err, "partition kernel")
    return rows, hist, nl


def partition_hist(rows: torch.Tensor, scal: ScalLike, *, num_features: int,
                   num_bins: int, voff: int, bpc: int = 1,
                   packed: bool = False, quantized: bool = False):
    """Fused split pass -> (rows_new, hist [F, 2, B] f32, nl [1] i32).

    A CUDA tensor goes through the kernel (in place) or raises; a CPU tensor
    through the plain version."""
    fn = partition_hist_cuda if rows.is_cuda else partition_hist_plain
    return fn(rows, scal, num_features=num_features, num_bins=num_bins,
              voff=voff, bpc=bpc, packed=packed, quantized=quantized)


# ---- the window in device memory ----

class WindowWork(NamedTuple):
    """The buffers of :func:`partition_hist_window_cuda`, sized for windows
    of up to ``bound`` rows of a ``[>= bound, W]`` store (one leaf-wise tree,
    or a learner's trees, reuse them)."""
    bound: int
    tile: int                 # rows a tile (part_tile_rows of W)
    nblk: int                 # tiles of a bound-row window
    seg_cap: int              # exact: the most segments (segment_cap)
    nseg: int                 # exact: segments of a bound-row window;
    ft: int                   # quantized: the integer grid of the bound
    quantized: bool
    scratch: torch.Tensor     # [bound, W] u8
    blk: torch.Tensor         # [nblk] i32 tile counts
    win: torch.Tensor         # [2] i32, the child's {start, count}
    partial: Optional[torch.Tensor]  # f64 partials or the int64 accumulator


def window_workspace(rows: torch.Tensor, bound: int, *, num_features: int,
                     num_bins: int, quantized: bool = False) -> WindowWork:
    """The device-window split pass's buffers for windows of at most
    ``bound`` rows of ``rows``' width, on its device, under the active
    plan's tile (``part_tile_rows``)."""
    W, dev = rows.shape[1], rows.device
    F, B = num_features, num_bins
    tile = part_tile_rows(W)
    nblk = max(1, part_blocks(bound, W))
    if quantized:
        ft, nseg = int_hist_grid(max(bound, 1), F, B)
        check_int_segments(bound, nseg)
        cap, partial = 1, int_accumulator(nseg, F, B, dev)
    else:
        ft, nseg, cap = 0, _segments(bound, F, B), segment_cap(F, B)
        partial = exact_partials(nseg, F, B, dev)
    return WindowWork(
        bound, tile, nblk, cap, nseg, ft, quantized,
        torch.empty((max(bound, 1), W), dtype=torch.uint8, device=dev),
        torch.empty((nblk,), dtype=torch.int32, device=dev),
        torch.empty((2,), dtype=torch.int32, device=dev), partial)


def partition_hist_window_plain(rows: torch.Tensor, scal: torch.Tensor,
                                work: Optional[WindowWork] = None, *,
                                num_features: int, num_bins: int, voff: int,
                                bpc: int = 1, packed: bool = False,
                                quantized: bool = False):
    """Plain version: :func:`partition_hist_plain` on the rows of the
    window ``scal`` names, written back over them (no other row is
    written); reads ``scal`` on the host.  ``work`` is not used."""
    s = _scal_host(scal, num_bins)
    wb, wc = int(s[0]), int(s[1])
    if not 0 <= wb <= wb + wc <= rows.shape[0]:
        raise ValueError("window [%d, %d) outside %d rows"
                         % (wb, wb + wc, rows.shape[0]))
    local = s.clone()
    local[0] = 0
    part, hist, nl = partition_hist_plain(
        rows[wb:wb + wc], local, num_features=num_features,
        num_bins=num_bins, voff=voff, bpc=bpc, packed=packed,
        quantized=quantized)
    rows[wb:wb + wc] = part
    return hist, nl


def partition_hist_window_cuda(rows: torch.Tensor, scal: torch.Tensor,
                               work: Optional[WindowWork] = None, *,
                               num_features: int, num_bins: int, voff: int,
                               bpc: int = 1, packed: bool = False,
                               quantized: bool = False):
    """Launch the split pass with its window in device memory
    (``lgbt_partition_window``, ``csrc/partition.cu``); partitions
    ``rows`` in place.  Reads nothing back and copies nothing to the card,
    so a CUDA graph can capture it.  Every window must lie in the first
    ``work.bound`` rows, and a trailing ``hist_feature_begin`` must keep
    the columns ``[f_begin, f_begin + num_features)`` inside the bin bytes
    (the kernel reads both on the device and checks neither); ``work``
    None makes one for the whole store."""
    from .. import kernels
    _check_store(rows, voff, num_features, num_bins)
    check_tensor(scal, "scal", torch.int32, ndim=1)
    base = SCAL_HEAD + num_bins // 32
    if scal.numel() not in (base, base + 1):
        raise ValueError("scal needs %d entries (12 + num_bins // 32), or %d "
                         "with the feature window, got %d"
                         % (base, base + 1, scal.numel()))
    if scal.device != rows.device:
        raise ValueError("scal on %s, rows on %s" % (scal.device,
                                                     rows.device))
    fwin = int(scal.numel() == base + 1)
    check_feature_window(0, num_features, voff, bpc, packed)
    n, W = rows.shape
    if work is None:
        work = window_workspace(rows, n, num_features=num_features,
                                num_bins=num_bins, quantized=quantized)
    if (work.scratch.shape[1] != W or work.bound > n
            or work.quantized != quantized
            or work.scratch.device != rows.device):
        raise ValueError("the workspace was made for another store or "
                         "precision")
    dev = rows.device
    hist = torch.empty((num_features, 2, num_bins), dtype=torch.float32,
                       device=dev)
    nl = torch.empty((1,), dtype=torch.int32, device=dev)
    err = kernels.library("partition").lgbt_partition_window(
        rows.data_ptr(), work.scratch.data_ptr(), W, scal.data_ptr(),
        work.bound, bpc, int(packed), num_bins // 32, num_features, num_bins,
        voff, fwin, work.nblk, work.tile, work.blk.data_ptr(),
        work.win.data_ptr(),
        nl.data_ptr(), work.seg_cap, work.nseg, work.ft, int(quantized),
        data_ptr(work.partial), hist.data_ptr(),
        route_counter(dev).data_ptr(), cuda_stream_ptr(rows))
    count_launch("partition")
    kernels.check(err, "partition kernel")
    return hist, nl


def partition_hist_window(rows: torch.Tensor, scal: torch.Tensor,
                          work: Optional[WindowWork] = None, *,
                          num_features: int, num_bins: int, voff: int,
                          bpc: int = 1, packed: bool = False,
                          quantized: bool = False):
    """Split pass of the window the scal tensor names -> (hist [F, 2, B]
    f32, nl [1] i32), ``rows`` partitioned in place.

    A CUDA tensor goes through the kernel (one launch, sized by ``work``)
    or raises; a CPU tensor through the plain version."""
    fn = (partition_hist_window_cuda if rows.is_cuda
          else partition_hist_window_plain)
    return fn(rows, scal, work, num_features=num_features,
              num_bins=num_bins, voff=voff, bpc=bpc, packed=packed,
              quantized=quantized)


# ---- level-batched pass ----

_MAX_GRID_Y = 65535     # grid rows of the histogram and reduce launches


def _scals_host(scals, num_bins: int) -> np.ndarray:
    """[G, S] scal rows as host int32, checked for width."""
    if isinstance(scals, torch.Tensor):
        scals = scals.cpu().numpy()
    s = np.asarray(scals, dtype=np.int64).reshape(-1, SCAL_HEAD + num_bins
                                                  // 32)
    if s.size and (s.min() < -2 ** 31 or s.max() >= 2 ** 31):
        raise ValueError("scal rows must fit int32")
    return s.astype(np.int32)


def check_windows(wb: np.ndarray, wc: np.ndarray, n: int) -> None:
    """Refuse windows that leave ``[0, n)`` or overlap (``wc = 0`` slots are
    ignored)."""
    live = wc > 0
    b = wb[live].astype(np.int64)
    e = b + wc[live]
    if (wc < 0).any() or (b < 0).any() or (e > n).any():
        raise ValueError("a window lies outside the %d rows of the store" % n)
    order = np.argsort(b, kind="stable")
    if (e[order][:-1] > b[order][1:]).any():
        raise ValueError("the windows of a level must be disjoint")


def check_stores(src: torch.Tensor, dst: torch.Tensor, s: np.ndarray) -> None:
    """Refuse a level pass whose stores are one buffer, or differ in shape,
    type or device, or whose windows leave the stores or overlap."""
    check_store_pair(src, dst)
    check_windows(s[:, 0], s[:, 1], src.shape[0])


def check_store_pair(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Refuse two stores that are one buffer, or differ in shape, type or
    device."""
    if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
        raise ValueError("the level pass reads src and writes dst: they must "
                         "be two row stores, not one")
    if (src.shape != dst.shape or src.dtype != dst.dtype
            or src.device != dst.device):
        raise ValueError("src %s %s on %s and dst %s %s on %s must match"
                         % (tuple(src.shape), src.dtype, src.device,
                            tuple(dst.shape), dst.dtype, dst.device))


def partition_hist_level_plain(src: torch.Tensor, dst: torch.Tensor, scals,
                               *, num_features: int, num_bins: int,
                               voff: int, bpc: int = 1, packed: bool = False,
                               quantized: bool = False):
    """Plain version: one plain single-window call per window, on the
    window's rows of ``src``, written into the same rows of ``dst``."""
    s = _scals_host(scals, num_bins)
    check_stores(src, dst, s)
    hists, nls = [], []
    for row in s:
        wb, wc = int(row[0]), int(row[1])
        local = row.copy()
        local[0] = 0
        part, h, nl = partition_hist_plain(
            src[wb:wb + wc], local.tolist(), num_features=num_features,
            num_bins=num_bins, voff=voff, bpc=bpc, packed=packed,
            quantized=quantized)
        dst[wb:wb + wc] = part
        hists.append(h)
        nls.append(nl)
    if not hists:
        return (torch.zeros((0, num_features, 2, num_bins), device=src.device),
                torch.zeros((0,), dtype=torch.int32, device=src.device))
    return torch.stack(hists), torch.cat(nls)


class ExactHistMap(NamedTuple):
    """The exact histogram kernel's map of a level pass: each window keeps
    the segments of its single-window call (``_segments`` of its rows).  Its
    part of ``LevelMeta.meta``: [G, 2] (segments, first partial row), then
    (window, segment) of each grid row."""
    nseg: int            # grid rows, and f64 partial rows [F, 2, B]


class IntHistMap(NamedTuple):
    """The integer histogram kernel's map of a level pass
    (``int_hist_grids``, the windows sharing the plan's int_fill_blocks by
    rows).  Its part of ``LevelMeta.meta``: [G, 4] (segments, accumulator
    row, features a block, first block; ``kIntInfo`` in csrc/hist_int.cuh),
    then the window of each block."""
    nblocks: int         # blocks of the launch
    nacc: int            # int64 accumulator rows: windows of several segments
    ft_max: int          # the widest feature tile
    reduce: bool         # some window needs pass 2
    seg_rows: int        # the most rows one block sums


class LevelMeta(NamedTuple):
    """The host-built maps of one level pass (``csrc/partition_level.cu``)."""
    meta: np.ndarray     # int32: scal rows, window rows, block map, then
                         # the histogram's map
    nblk: int            # blocks of the count and scatter kernels
    hist: Union[ExactHistMap, IntHistMap]


def _exact_hist_map(wc: np.ndarray, F: int, num_bins: int):
    nseg = np.asarray([_segments(int(c), F, num_bins) if c > 0 else 0
                       for c in wc], dtype=np.int64)
    poff = np.cumsum(nseg) - nseg
    gs = np.repeat(np.arange(wc.size), nseg)
    NS = int(nseg.sum())
    hmap = np.stack([gs, np.arange(NS) - poff[gs]], 1)
    return (np.concatenate([np.stack([nseg, poff], 1).reshape(-1),
                            hmap.reshape(-1)]), ExactHistMap(NS))


def _int_hist_map(wc: np.ndarray, F: int, num_bins: int):
    live = wc > 0
    share = -(-_plan_state.int_fill_blocks() * wc // max(int(wc.sum()), 1))
    ft, nseg = int_hist_grids(wc, F, num_bins, share)
    ft = np.where(live, ft, F)
    nseg = np.where(live, nseg, 0)
    nhb = nseg * -(-F // ft)              # blocks of each window
    first = np.cumsum(nhb) - nhb
    shared = (nseg > 1).astype(np.int64)  # one accumulator row each
    arow = np.cumsum(shared) - shared
    info = np.stack([nseg, arow, ft, first], 1)
    hmap = np.repeat(np.arange(wc.size), nhb)
    return (np.concatenate([info.reshape(-1), hmap]),
            IntHistMap(nblocks=int(nhb.sum()), nacc=int(shared.sum()),
                       ft_max=int(ft[live].max()) if live.any() else 1,
                       reduce=bool((nseg != 1).any()),
                       seg_rows=int(np.max(-(-wc // np.maximum(nseg, 1)),
                                           initial=0))))


def level_meta(s: np.ndarray, num_features: int, num_bins: int,
               row_width: int, quantized: bool = False) -> LevelMeta:
    """The block and histogram maps of ``csrc/partition_level.cu`` for scal
    rows ``s`` [G, S] of an F-feature, B-bin store of ``row_width``-byte
    rows: the exact kernel's (:class:`ExactHistMap`) or, when
    ``quantized``, the integer kernel's (:class:`IntHistMap`)."""
    G = s.shape[0]
    wc = s[:, 1].astype(np.int64)
    if int(wc.sum()) >= 2 ** 31:
        raise ValueError("a level's windows hold 2**31 rows or more")
    nblk = part_blocks(wc, row_width)
    blk_off = np.cumsum(nblk) - nblk
    NB = int(nblk.sum())
    gb = np.repeat(np.arange(G), nblk)
    blkmap = np.stack([gb, np.arange(NB) - blk_off[gb]], 1)
    # the window rows of csrc/partition_level.cu (kWinMeta = 2 columns)
    wmeta = np.stack([blk_off, nblk], 1)
    hist_map = _int_hist_map if quantized else _exact_hist_map
    hmeta, hist = hist_map(wc, num_features, num_bins)
    meta = np.concatenate([s.reshape(-1), wmeta.reshape(-1),
                           blkmap.reshape(-1), hmeta])
    return LevelMeta(meta.astype(np.int32), NB, hist)


def partition_hist_level_cuda(src: torch.Tensor, dst: torch.Tensor, scals,
                              *, num_features: int, num_bins: int, voff: int,
                              bpc: int = 1, packed: bool = False,
                              quantized: bool = False):
    """Launch the hand-written level pass (``csrc/partition_level.cu``) over
    every window of ``scals``: from ``src`` into ``dst``."""
    from .. import kernels
    _check_store(src, voff, num_features, num_bins)
    check_tensor(dst, "dst", torch.uint8, ndim=2)
    s = _scals_host(scals, num_bins)
    check_stores(src, dst, s)
    G, S = s.shape
    W = src.shape[1]
    dev = src.device
    hist = torch.empty((G, num_features, 2, num_bins), dtype=torch.float32,
                       device=dev)
    if G == 0:
        return hist, torch.zeros((0,), dtype=torch.int32, device=dev)
    lm = level_meta(s, num_features, num_bins, W, quantized)
    h = lm.hist
    if quantized:
        check_int_segments(h.seg_rows, 1)
        # blocks, accumulator rows, and the integer launch's arguments
        nhist, nrows, iargs = h.nblocks, h.nacc, (h.ft_max, h.nacc,
                                                  int(h.reduce))
    else:
        # grid rows (window, segment), f64 partial rows
        nhist, nrows, iargs = h.nseg, h.nseg, (0, 0, 0)
    if G > _MAX_GRID_Y or (not quantized and nhist > _MAX_GRID_Y):
        raise ValueError("%d windows in %d histogram segments exceed the "
                         "grid's %d rows" % (G, nhist, _MAX_GRID_Y))
    # the one host->device copy, from pinned memory so that it does not
    # wait for the stream's earlier work
    meta_dev = torch.from_numpy(lm.meta).pin_memory().to(dev,
                                                          non_blocking=True)
    work = torch.empty((lm.nblk + 3 * G,), dtype=torch.int32, device=dev)
    partial = torch.empty((max(nrows, 1), num_features, 2, num_bins),
                          dtype=torch.int64 if quantized else torch.float64,
                          device=dev)
    lib = kernels.library("partition_level")
    err = lib.lgbt_partition_level(
        src.data_ptr(), dst.data_ptr(), W, meta_dev.data_ptr(), G, S,
        lm.nblk, nhist, part_tile_rows(W), bpc, int(packed), num_bins // 32,
        num_features, num_bins, voff, int(quantized), *iargs,
        work.data_ptr(), partial.data_ptr(), hist.data_ptr(),
        cuda_stream_ptr(src))
    count_launch("partition_level")
    live = s[:, 1] > 0
    count_routes("partition_level", int((live & (s[:, 10] == 1)).sum()),
                 int((live & (s[:, 8] == 1)).sum()))
    kernels.check(err, "partition_level kernel")
    return hist, work[lm.nblk:lm.nblk + G]


def partition_hist_level(src: torch.Tensor, dst: torch.Tensor, scals, *,
                         num_features: int, num_bins: int, voff: int,
                         bpc: int = 1, packed: bool = False,
                         quantized: bool = False):
    """Level-batched split pass -> (hist [G, F, 2, B] f32, nl [G] i32) over
    the disjoint windows of ``scals`` [G, S]: each window's rows of ``src``
    are stably partitioned into the same rows of ``dst``; no other row of
    either store is written.

    A CUDA tensor goes through the kernel (one call) or raises; a CPU tensor
    through the plain version."""
    fn = (partition_hist_level_cuda if src.is_cuda
          else partition_hist_level_plain)
    return fn(src, dst, scals, num_features=num_features, num_bins=num_bins,
              voff=voff, bpc=bpc, packed=packed, quantized=quantized)


# ---- the level pass with its windows in device memory ----

LEVEL_INT_GRIDS = ("device", "bound")


class LevelBounds(NamedTuple):
    """The launch sizes of :func:`partition_hist_level_window_cuda` for G
    windows of at most ``n`` rows in all: ``NB`` count and scatter blocks,
    ``NH`` histogram grid rows (exact) or blocks (quantized), and what the
    kernel's maps need besides (``csrc/partition_level.cu``)."""
    tile: int           # rows a count/scatter tile (part_tile_rows)
    NB: int             # ceil(n / tile) + G
    NH: int
    seg_cap: int        # exact: the most segments a window takes
    fill: int           # quantized: the blocks a level's windows share
    ft_b: int           # quantized, the bound's grid: features a block,
    nseg_b: int         # segments a window
    ft_max: int         # quantized: the widest feature tile


def level_bounds(n: int, G: int, num_features: int, num_bins: int,
                 row_width: int, quantized: bool = False,
                 int_grid: str = "device",
                 fill: Optional[int] = None) -> LevelBounds:
    """Sizes that hold for any G disjoint windows of ``n`` rows in all.

    Tiles: a window of wc rows has ceil(wc / tile) <= wc / tile + 1.
    Exact segments: ``_segments`` gives min(seg_cap, ceil(wc / 2048)) <=
    wc / 2048 + 1.  Quantized, ``int_grid`` "device" (``int_hist_grids`` of
    each window aiming at its share ceil(fill * wc / sum(wc)) of ``fill``
    blocks, as ``level_meta`` does): a window's blocks are at most its
    share + (wide + 1) * need + wide * ceil(wc / _INT_BLOCK_ROWS), where
    ``wide`` is the fewest tiles of F features and ``need`` <= wc / 4096 +
    1 the segments a small window takes; summed over the windows that is
    ``NH`` below.  "bound": every window takes the grid of an n-row window
    (``int_hist_grid(n)``)."""
    if int_grid not in LEVEL_INT_GRIDS:
        raise ValueError("int_grid %r (device or bound)" % (int_grid,))
    F, B = num_features, num_bins
    tile = part_tile_rows(row_width)
    NB = -(-n // tile) + G
    seg_cap = segment_cap(F, B)
    fill = _plan_state.int_fill_blocks() if fill is None else int(fill)
    ft_b = nseg_b = ft_max = 0
    if not quantized:
        NH = max(1, min(G * seg_cap, -(-n // _SEG_ROWS) + G))
    else:
        ft_smem = max(1, min(F, _INT_HIST_SMEM // (8 * B)))
        wide = -(-F // ft_smem)
        if int_grid == "device":
            NH = (fill + G + (wide + 1) * (-(-n // _INT_SMALL_SEG_ROWS) + G)
                  + wide * (-(-n // _INT_BLOCK_ROWS) + G))
            ft_max = -(-F // wide)
        else:
            ft_b, nseg_b = int_hist_grid(max(n, 1), F, B, fill)
            NH = G * nseg_b * -(-F // ft_b)
            ft_max = ft_b
    return LevelBounds(tile, NB, NH, seg_cap, fill, ft_b, nseg_b, ft_max)


def _map_sizes(G: int, bd: LevelBounds, quantized: bool) -> int:
    """int32 entries of the kernel's maps: window rows, block map, the
    histogram's window rows and map."""
    return 2 * G + 2 * bd.NB + (4 if quantized else 2) * G + (
        1 if quantized else 2) * bd.NH


class LevelWork(NamedTuple):
    """The buffers of :func:`partition_hist_level_window_cuda`, sized once
    for up to ``G`` windows of at most ``n`` rows in all of a ``W``-byte
    store (a learner's level trees reuse them; a level of fewer windows
    launches on a part of them)."""
    n: int
    G: int
    W: int
    num_features: int
    num_bins: int
    quantized: bool
    int_grid: str
    fill: int
    tile: int
    maps: torch.Tensor                # int32, the maps the kernel builds
    work: torch.Tensor                # int32: tile prefixes, nl, windows
    partial: torch.Tensor             # exact: f64 [NH, F, 2, B] partials;
                                      # quantized: int64 [G, F, 2, B], zero

    def bounds(self, G: int) -> LevelBounds:
        return level_bounds(self.n, G, self.num_features, self.num_bins,
                            self.W, self.quantized, self.int_grid, self.fill)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.maps, self.work, self.partial))


def level_workspace(n: int, G: int, W: int, num_features: int,
                    num_bins: int, quantized: bool = False, *, device,
                    int_grid: str = "device") -> LevelWork:
    """The device-window level pass's buffers for up to ``G`` windows of
    at most ``n`` rows in all of ``W``-byte rows, on ``device``, under the
    active plan's tile and integer fill.  At 1,048,576 rows, 28 features,
    256 bins and G = 128 (a 255-leaf tree's last level) the exact partials
    are 640 x 28 x 2 x 256 f64, 73.4 MB, and the rest a few tens of
    KB."""
    if n >= 2 ** 31:
        raise ValueError("a level's windows hold 2**31 rows or more")
    if G > _MAX_GRID_Y:
        raise ValueError("%d windows exceed the grid's %d rows"
                         % (G, _MAX_GRID_Y))
    F, B = num_features, num_bins
    check_hist_shape(F, B)
    bd = level_bounds(n, G, F, B, W, quantized, int_grid)
    if not quantized and bd.NH > _MAX_GRID_Y:
        raise ValueError("%d histogram segments exceed the grid's %d rows"
                         % (bd.NH, _MAX_GRID_Y))
    i32 = dict(dtype=torch.int32, device=device)
    if quantized:
        partial = torch.zeros((max(G, 1), F, 2, B), dtype=torch.int64,
                              device=device)
    else:
        partial = torch.empty((bd.NH, F, 2, B), dtype=torch.float64,
                              device=device)
    w = LevelWork(n, G, W, F, B, quantized, int_grid, bd.fill, bd.tile,
                  torch.empty((_map_sizes(G, bd, quantized),), **i32),
                  torch.empty((bd.NB + 3 * G,), **i32), partial)
    Log.debug("level workspace: %d windows of %d rows, %.1f MiB",
              G, n, w.nbytes() / 2 ** 20)
    return w


class LevelMapsDevice(NamedTuple):
    """The maps of one level pass, as ``csrc/partition_level.cu``'s
    lvl_meta_kernel writes them for a bound (:class:`LevelBounds`): int32
    device tensors, entries past the level's blocks -1."""
    wmeta: torch.Tensor    # [G, 2] first block, blocks
    blkmap: torch.Tensor   # [NB, 2] (window, tile)
    hinfo: torch.Tensor    # exact [G, 2] (segments, first partial row);
                           # quantized [G, 4] (segments, accumulator row,
                           # features a block, first block)
    hmap: torch.Tensor     # exact [NH, 2] (window, segment); quantized [NH]

    def flat(self) -> torch.Tensor:
        """In the order of the kernel's ``maps`` buffer."""
        return torch.cat([t.reshape(-1) for t in self])


def _int_grids_device(count: torch.Tensor, num_features: int, num_bins: int,
                      blocks: torch.Tensor):
    """``histogram.int_hist_grids`` in torch ops on int64 tensors."""
    f = num_features
    ft_max = max(1, min(f, _INT_HIST_SMEM // (8 * num_bins)))
    wide = -(-f // ft_max)
    row_segs = -(-count // _INT_SEG_ROWS)
    small = count <= _INT_SMALL_ROWS
    one = torch.ones_like(count)
    need = torch.where(small, torch.clamp(-(-count // _INT_SMALL_SEG_ROWS),
                                          min=1), one)
    narrowest = torch.where(row_segs <= 1, one * f, one * -(-f // 2))
    narrow = torch.clamp(torch.minimum(narrowest, -(-blocks // need)),
                         min=wide)
    ntiles = torch.where(small, narrow, one * wide)
    nseg = torch.maximum(torch.maximum(torch.minimum(row_segs,
                                                     blocks // ntiles), need),
                         -(-count // _INT_BLOCK_ROWS))
    return -(-f // ntiles), nseg


def _entry_map(first: torch.Tensor, count: torch.Tensor, size: int):
    """For each entry b < ``size``: the window g whose entries [first[g],
    first[g] + count[g]) hold it and b - first[g], or (-1, -1) past them
    all."""
    dev = first.device
    b = torch.arange(size, dtype=torch.int64, device=dev)
    if first.numel() == 0:
        neg = torch.full_like(b, -1)
        return neg, neg
    g = torch.searchsorted(first, b, right=True) - 1
    inside = b < first[-1] + count[-1]
    return (torch.where(inside, g, -1),
            torch.where(inside, b - first[g.clamp(min=0)], -1))


def level_meta_device(scals: torch.Tensor, num_features: int, num_bins: int,
                      row_width: int, *, bound_rows: int,
                      quantized: bool = False,
                      int_grid: str = "device") -> LevelMapsDevice:
    """:func:`level_meta`'s block and histogram maps in plain torch ops over
    ``scals[:, 1]`` on its device (no host read), padded to the bounds of
    G windows of ``bound_rows`` rows in all, as the kernel builds them."""
    G = scals.shape[0]
    F, B = num_features, num_bins
    bd = level_bounds(bound_rows, G, F, B, row_width, quantized, int_grid)
    wc = scals[:, 1].long().clamp(min=0)
    live = wc > 0
    nblk = -(-wc // bd.tile)
    first = torch.cumsum(nblk, 0) - nblk
    blkmap = torch.stack(_entry_map(first, nblk, bd.NB), 1)
    zero = torch.zeros_like(wc)
    if not quantized:
        nseg = torch.where(live, torch.clamp(-(-wc // _SEG_ROWS), 1,
                                             bd.seg_cap), zero)
        poff = torch.cumsum(nseg, 0) - nseg
        hinfo = torch.stack([nseg, poff], 1)
        hmap = torch.stack(_entry_map(poff, nseg, bd.NH), 1)
    else:
        if int_grid == "device":
            share = -(-bd.fill * wc // wc.sum().clamp(min=1))
            ft, nseg = _int_grids_device(wc, F, B, share)
        else:
            ft, nseg = zero + bd.ft_b, zero + bd.nseg_b
        ft = torch.where(live, ft, zero + F)
        nseg = torch.where(live, nseg, zero)
        nhb = nseg * -(-F // ft)
        hfirst = torch.cumsum(nhb, 0) - nhb
        shared = (nseg > 1).long()
        arow = torch.cumsum(shared, 0) - shared
        hinfo = torch.stack([nseg, arow, ft, hfirst], 1)
        hmap = _entry_map(hfirst, nhb, bd.NH)[0]
    i32 = torch.int32
    return LevelMapsDevice(torch.stack([first, nblk], 1).to(i32),
                           blkmap.to(i32), hinfo.to(i32), hmap.to(i32))


def _check_level_window(src: torch.Tensor, dst: torch.Tensor,
                        scals: torch.Tensor, num_bins: int) -> None:
    """The checks a level pass with its windows in device memory can make
    on shapes alone: the store pair, the scal rows' width and type, G."""
    check_store_pair(src, dst)
    S = SCAL_HEAD + num_bins // 32
    if scals.dim() != 2 or scals.shape[1] != S or scals.dtype != torch.int32:
        raise ValueError("scals must be int32 [G, %d], got %s %s"
                         % (S, scals.dtype, tuple(scals.shape)))
    if scals.device != src.device:
        raise ValueError("scals on %s, the stores on %s"
                         % (scals.device, src.device))
    if scals.shape[0] > _MAX_GRID_Y:
        raise ValueError("%d windows exceed the grid's %d rows"
                         % (scals.shape[0], _MAX_GRID_Y))
    if src.shape[0] >= 2 ** 31:
        raise ValueError("a level's windows hold 2**31 rows or more")


def _route_rows(rows: torch.Tensor, sc: torch.Tensor, num_bins: int,
                bpc: int, packed: bool) -> torch.Tensor:
    """:func:`route_left` of each row of ``rows`` [n, W] by its own scal row
    ``sc`` [n, S] (int64)."""
    gcol = sc[:, 2]

    def byte(i):
        return torch.gather(rows, 1, i[:, None])[:, 0].long()
    if packed:
        b = byte(gcol // 2)
        col = torch.where(gcol % 2 == 1, b >> 4, b) & 15
    elif bpc == 2:
        col = byte(2 * gcol) | (byte(2 * gcol + 1) << 8)
    else:
        col = byte(gcol)
    thr, dleft, mt, nb, dbin, is_cat, unf, eoff = (
        sc[:, i] for i in (3, 4, 5, 6, 7, 8, 10, 11))
    col = torch.where(unf == 1, torch.where(
        (col >= eoff) & (col <= eoff + nb - 2), col - eoff + 1,
        torch.zeros_like(col)), col)
    nw = num_bins // 32
    cat_left = torch.zeros_like(col, dtype=torch.bool)
    if nw:
        words = sc[:, SCAL_HEAD:SCAL_HEAD + nw] & 0xFFFFFFFF
        word = torch.gather(words, 1, torch.clamp(col >> 5, 0, nw - 1)[:, None]
                            )[:, 0]
        cat_left = ((word >> (col & 31)) & 1) == 1
    missing = torch.where(mt == SCAL_MISSING_NAN, col == nb - 1,
                          (mt == SCAL_MISSING_ZERO) & (col == dbin))
    num_left = torch.where(missing, dleft == 1, col <= thr)
    return torch.where(is_cat == 1, cat_left, num_left)


def partition_hist_level_window_plain(src: torch.Tensor, dst: torch.Tensor,
                                      scals: torch.Tensor,
                                      work: Optional[LevelWork] = None, *,
                                      num_features: int, num_bins: int,
                                      voff: int, bpc: int = 1,
                                      packed: bool = False,
                                      quantized: bool = False):
    """Plain version: reads no scal row on the host.  Each position finds
    its window through the block map of :func:`level_meta_device` (its
    tile's start, forward filled), routes by its window's scal row, takes
    its rank among its window's left or right rows and moves to that row
    of ``dst`` (rows outside the windows are written back as ``dst`` held
    them); each window's left count is the sum of its tiles' counts.  The
    histograms sum each window's smaller side over ``src`` in row order in
    one f64 (or int64) sequence, as :func:`partition_hist_level_plain`'s
    single-window calls do, so the two agree bit for bit.  ``work`` is not
    used."""
    _check_level_window(src, dst, scals, num_bins)
    n, W = src.shape
    G, F, dev = scals.shape[0], num_features, src.device
    maps = level_meta_device(scals, F, num_bins, W, bound_rows=n)
    tile = part_tile_rows(W)
    sl = scals.long()
    wb, wc = sl[:, 0], sl[:, 1].clamp(min=0)
    gb, tb = maps.blkmap[:, 0].long(), maps.blkmap[:, 1].long()
    NB = gb.numel()
    pos = torch.arange(n, device=dev)
    # each position's tile: marks at the tiles' first rows, forward filled
    marks = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    if G:
        start = torch.where(gb >= 0, wb[gb.clamp(min=0)] + tb * tile, n)
        marks[start] = torch.arange(1, NB + 1, device=dev)
    last = torch.cummax(torch.where(marks[:n] > 0, pos, 0), 0).values
    blk = marks[last] - 1
    g = gb[blk.clamp(min=0)].clamp(min=0) if G else torch.zeros_like(pos)
    inw = (blk >= 0) & (pos < wb[g] + wc[g]) if G else pos < 0
    sc = sl[g] if G else torch.zeros((n, scals.shape[1]), dtype=torch.int64,
                                     device=dev)
    gl = _route_rows(src, sc, num_bins, bpc, packed)
    left, right = gl & inw, ~gl & inw
    # the count kernel's tile sums, and each window's left total
    tiles = torch.zeros(max(NB, 1), dtype=torch.int64, device=dev)
    tiles.index_add_(0, blk.clamp(min=0), left.long())
    nl = torch.zeros(G, dtype=torch.int64, device=dev)
    if G:
        nl.index_add_(0, gb.clamp(min=0), tiles[:NB] * (gb >= 0))
    cl = torch.cumsum(left.long(), 0) - left.long()
    cr = torch.cumsum(right.long(), 0) - right.long()
    first = wb[g].clamp(max=n - 1) if n else wb[g]
    dest = torch.where(left, wb[g] + cl - cl[first],
                       wb[g] + nl[g] + cr - cr[first]) if n else pos
    dest = torch.where(inw, dest, pos)
    dst.index_copy_(0, dest, torch.where(inw[:, None], src, dst))
    side = torch.where(sc[:, 9] == 1, left, right)
    window = torch.where(side, g, -1)

    def chunks():
        for a, b in _row_chunks(n, F):
            bins, values = rows_split(src[a:b], F, voff, bpc, packed)
            yield bins, values, window[a:b]
    hist = _hist_sums(chunks(), F, num_bins, quantized, dev, num_windows=G)
    return hist, nl.to(torch.int32)


def partition_hist_level_window_cuda(src: torch.Tensor, dst: torch.Tensor,
                                     scals: torch.Tensor,
                                     work: Optional[LevelWork] = None, *,
                                     num_features: int, num_bins: int,
                                     voff: int, bpc: int = 1,
                                     packed: bool = False,
                                     quantized: bool = False):
    """Launch the level pass with its windows in device memory
    (``lgbt_partition_level_window``, ``csrc/partition_level.cu``): from
    ``src`` into ``dst``, the G scal rows ``scals`` [G, S] int32 on the
    card.  Reads nothing back and copies nothing to the card, so a CUDA
    graph can capture it.  The windows must be disjoint and lie in the
    first ``work.n`` rows (the kernel reads them on the device and checks
    neither); ``work`` None makes one for the whole store.  Returns (hist
    [G, F, 2, B], nl [G] i32, a view into ``work``)."""
    from .. import kernels
    _check_store(src, voff, num_features, num_bins)
    check_tensor(dst, "dst", torch.uint8, ndim=2)
    check_tensor(scals, "scals", torch.int32, ndim=2)
    _check_level_window(src, dst, scals, num_bins)
    check_feature_window(0, num_features, voff, bpc, packed)
    n, W = src.shape
    G, S = scals.shape
    dev = src.device
    if work is None:
        work = level_workspace(n, G, W, num_features, num_bins, quantized,
                               device=dev)
    if (work.W != W or work.n > n or work.G < G
            or work.quantized != quantized
            or work.num_features != num_features
            or work.num_bins != num_bins or work.maps.device != dev
            or work.tile != part_tile_rows(W)):
        raise ValueError("the level workspace was made for another store, "
                         "width, precision or frontier")
    hist = torch.empty((G, num_features, 2, num_bins), dtype=torch.float32,
                       device=dev)
    if G == 0:
        return hist, work.work[:0]
    bd = work.bounds(G)
    err = kernels.library("partition_level").lgbt_partition_level_window(
        src.data_ptr(), dst.data_ptr(), W, scals.data_ptr(), G, S, bd.NB,
        bd.NH, bd.tile, bpc, int(packed), num_bins // 32, num_features,
        num_bins, voff, bd.seg_cap, int(quantized),
        LEVEL_INT_GRIDS.index(work.int_grid), bd.fill, bd.ft_b, bd.nseg_b,
        bd.ft_max, work.maps.data_ptr(), work.work.data_ptr(),
        work.partial.data_ptr(), hist.data_ptr(),
        level_route_counter(dev).data_ptr(), cuda_stream_ptr(src))
    count_launch("partition_level")
    kernels.check(err, "partition_level kernel")
    return hist, work.work[bd.NB:bd.NB + G]


def partition_hist_level_window(src: torch.Tensor, dst: torch.Tensor,
                                scals: torch.Tensor,
                                work: Optional[LevelWork] = None, *,
                                num_features: int, num_bins: int, voff: int,
                                bpc: int = 1, packed: bool = False,
                                quantized: bool = False):
    """Level pass over the G windows the scal tensor ``scals`` [G, S] names
    -> (hist [G, F, 2, B] f32, nl [G] i32): each window's rows of ``src``
    stably partitioned into the same rows of ``dst``.

    A CUDA tensor goes through the kernel (one call, sized by ``work``) or
    raises; a CPU tensor through the plain version."""
    fn = (partition_hist_level_window_cuda if src.is_cuda
          else partition_hist_level_window_plain)
    return fn(src, dst, scals, work, num_features=num_features,
              num_bins=num_bins, voff=voff, bpc=bpc, packed=packed,
              quantized=quantized)
