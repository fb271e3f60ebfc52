"""Fused split pass: route + stable partition + smaller-child histogram.

Counterpart of ``lightgbm_tpu/core/partition.py`` ``partition_hist_pallas``
(its small-window and pipelined kernels; the TPU's size buckets are a TPU-ism
and one implementation serves every window here) with the output contract of
``partition_hist_xla``:

    partition_hist(rows, scal, ...) -> (rows_new, hist [F, 2, B], nl)

``scal`` is the scalar row of partition.py:1030-1037, i32
``[12 + num_bins // 32]``: (window_begin, window_count, group_col,
threshold_bin, default_left, missing_type, num_bin_f, default_bin, is_cat,
hist_left_side, use_unfold, efb_offset, *cat_bitset_words).  The window
``[wb, wb + wc)`` is stably partitioned (left rows first), ``nl`` is the left
count, and ``hist`` is the histogram of the child that ``hist_left_side``
names, already folded to ``[F, 2, B]``.  ``missing_type`` is the kernel's own
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
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from ..device import check_tensor, count_launch, cuda_stream_ptr
from ..io.binning import MissingType
from .histogram import (_segments, check_hist_shape, histogram_plain,
                        rows_split)

SCAL_HEAD = 12
_PART_TILE = 2048        # rows per block of the count/scatter kernels

ScalLike = Union[torch.Tensor, Sequence[int]]

SCAL_MISSING_NAN = 1     # scal[5]: the NaN bin (num_bin - 1) is missing
SCAL_MISSING_ZERO = 2    # scal[5]: the default bin is missing


def scal_missing_code(missing_type: int) -> int:
    """``MissingType`` (NONE 0, ZERO 1, NAN 2) -> the scal row's code."""
    return {int(MissingType.NAN): SCAL_MISSING_NAN,
            int(MissingType.ZERO): SCAL_MISSING_ZERO}.get(int(missing_type), 0)


def _scal_host(scal: ScalLike, num_bins: int) -> torch.Tensor:
    s = torch.as_tensor(scal, dtype=torch.int32).cpu().reshape(-1)
    if s.numel() != SCAL_HEAD + num_bins // 32:
        raise ValueError("scal needs %d entries (12 + num_bins // 32), got %d"
                         % (SCAL_HEAD + num_bins // 32, s.numel()))
    return s


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
                         bpc: int = 1, packed: bool = False):
    """Plain PyTorch version (the ``partition_hist_xla`` contract)."""
    s = _scal_host(scal, num_bins)
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
    bins, values = rows_split(rows, num_features, voff, bpc, packed)
    hist = histogram_plain(bins, values * side.to(torch.float32)[None],
                           num_bins)
    return rows_new, hist, torch.tensor([nl], dtype=torch.int32, device=dev)


def partition_hist_cuda(rows: torch.Tensor, scal: ScalLike, *,
                        num_features: int, num_bins: int, voff: int,
                        bpc: int = 1, packed: bool = False):
    """Launch the hand-written fused split pass (``csrc/partition.cu``);
    partitions ``rows`` in place and returns it."""
    from .. import kernels
    check_tensor(rows, "rows", torch.uint8, ndim=2)
    s = _scal_host(scal, num_bins)
    n, W = rows.shape
    wb, wc = int(s[0]), int(s[1])
    if not 0 <= wb <= wb + wc <= n:
        raise ValueError("window [%d, %d) outside %d rows" % (wb, wb + wc, n))
    if W % 16 or voff % 4 or voff + 8 > W:
        raise ValueError("row width %d must be a multiple of 16 with the "
                         "values 4-aligned inside it (voff %d)" % (W, voff))
    check_hist_shape(num_features, num_bins)
    dev = rows.device
    hist = torch.empty((num_features, 2, num_bins), dtype=torch.float32,
                       device=dev)
    nl = torch.empty((1,), dtype=torch.int32, device=dev)
    if wc == 0:
        # identity partition, zero histogram: nothing to launch
        hist.zero_()
        nl.zero_()
        return rows, hist, nl
    scal_dev = s.to(dev)
    scratch = torch.empty((wc, W), dtype=torch.uint8, device=dev)
    nblk = -(-wc // _PART_TILE)
    blk = torch.empty((nblk,), dtype=torch.int32, device=dev)
    win = torch.empty((2,), dtype=torch.int32, device=dev)
    nseg = _segments(wc)
    partial = torch.empty((nseg, num_features, 2, num_bins),
                          dtype=torch.float64, device=dev)
    lib = kernels.library("partition")
    err = lib.lgbt_partition_hist(
        rows.data_ptr(), scratch.data_ptr(), W, scal_dev.data_ptr(), wb, wc,
        bpc, int(packed), num_bins // 32, num_features, num_bins, voff, nblk,
        blk.data_ptr(), win.data_ptr(), nl.data_ptr(), nseg,
        partial.data_ptr(), hist.data_ptr(), cuda_stream_ptr(rows))
    count_launch("partition")
    kernels.check(err, "partition kernel")
    return rows, hist, nl


def partition_hist(rows: torch.Tensor, scal: ScalLike, *, num_features: int,
                   num_bins: int, voff: int, bpc: int = 1,
                   packed: bool = False):
    """Fused split pass -> (rows_new, hist [F, 2, B] f32, nl [1] i32).

    A CUDA tensor goes through the kernel (in place) or raises; a CPU tensor
    through the plain version."""
    fn = partition_hist_cuda if rows.is_cuda else partition_hist_plain
    return fn(rows, scal, num_features=num_features, num_bins=num_bins,
              voff=voff, bpc=bpc, packed=packed)
