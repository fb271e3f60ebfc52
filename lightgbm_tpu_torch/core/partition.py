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
CUDA tensor it launches the kernel or raises.  With ``quantized=True``
(``hist_precision=quantized``) the child histogram is the exact integer sum of
the integer-valued g/h (``histogram.histogram_plain_int``, or the integer
kernel ``csrc/hist_int.cuh`` on the card).

The level-batched pass, the counterpart of ``partition_hist_level_pallas``
(partition.py:1191-1218), runs the same function over every window of a tree
level at once::

    partition_hist_level(rows, scals[G, S], ...) -> (rows, hist [G, F, 2, B],
                                                     nl [G])

The windows must be pairwise disjoint; a slot with ``wc = 0`` is an identity
with a zero histogram and ``nl = 0``; the result equals G sequential
:func:`partition_hist` calls bit for bit.  Its plain version is those G plain
calls; :func:`partition_hist_level_cuda` is the wrapper of
``csrc/partition_level.cu``, one call per level whatever the window sizes.
The TPU's per-level bucket classes (``level_plan``/``fused_bucket_plan``) and
the per-class window masking (tree_learner.py:1176-1202) were a TPU cost
model and have no counterpart here.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..device import check_tensor, count_launch, cuda_stream_ptr
from ..io.binning import MissingType
from .histogram import (_segments, check_hist_shape, check_int_segments,
                        histogram_rows_plain)

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
                         bpc: int = 1, packed: bool = False,
                         quantized: bool = False):
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
    hist = histogram_rows_plain(
        rows, num_bins, wb, wc, num_features=num_features, voff=voff,
        bpc=bpc, packed=packed, quantized=quantized,
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
    scal_dev = s.to(dev)
    scratch = torch.empty((wc, W), dtype=torch.uint8, device=dev)
    nblk = -(-wc // _PART_TILE)
    blk = torch.empty((nblk,), dtype=torch.int32, device=dev)
    win = torch.empty((2,), dtype=torch.int32, device=dev)
    nseg = _segments(wc, num_features, num_bins)
    if quantized:
        check_int_segments(wc, nseg)
    partial = torch.empty((nseg, num_features, 2, num_bins),
                          dtype=torch.int32 if quantized else torch.float64,
                          device=dev)
    lib = kernels.library("partition")
    err = lib.lgbt_partition_hist(
        rows.data_ptr(), scratch.data_ptr(), W, scal_dev.data_ptr(), wb, wc,
        bpc, int(packed), num_bins // 32, num_features, num_bins, voff, nblk,
        blk.data_ptr(), win.data_ptr(), nl.data_ptr(), nseg, int(quantized),
        partial.data_ptr(), hist.data_ptr(), cuda_stream_ptr(rows))
    count_launch("partition")
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


def partition_hist_level_plain(rows: torch.Tensor, scals, *,
                               num_features: int, num_bins: int, voff: int,
                               bpc: int = 1, packed: bool = False,
                               quantized: bool = False):
    """Plain version: G sequential plain single-window calls."""
    s = _scals_host(scals, num_bins)
    check_windows(s[:, 0], s[:, 1], rows.shape[0])
    hists, nls = [], []
    for row in s:
        rows, h, nl = partition_hist_plain(
            rows, row.tolist(), num_features=num_features, num_bins=num_bins,
            voff=voff, bpc=bpc, packed=packed, quantized=quantized)
        hists.append(h)
        nls.append(nl)
    if not hists:
        return (rows, torch.zeros((0, num_features, 2, num_bins),
                                  device=rows.device),
                torch.zeros((0,), dtype=torch.int32, device=rows.device))
    return rows, torch.stack(hists), torch.cat(nls)


def level_meta(s: np.ndarray, num_features: int, num_bins: int):
    """The host-built block and segment maps of ``csrc/partition_level.cu``
    for scal rows ``s`` [G, S] of an F-feature, B-bin store: (meta int32,
    NB, NS, rows the partition stages, the largest rows per histogram
    segment)."""
    G = s.shape[0]
    wc = s[:, 1].astype(np.int64)
    nblk = -(-wc // _PART_TILE)
    # each window keeps its single-window call's segmentation
    nseg = np.asarray([_segments(int(c), num_features, num_bins)
                       if c > 0 else 0 for c in wc],
                      dtype=np.int64)
    blk_off = np.cumsum(nblk) - nblk
    soff = np.cumsum(wc) - wc
    poff = np.cumsum(nseg) - nseg
    NB, NS = int(nblk.sum()), int(nseg.sum())
    gb = np.repeat(np.arange(G), nblk)
    blkmap = np.stack([gb, np.arange(NB) - blk_off[gb]], 1)
    gs = np.repeat(np.arange(G), nseg)
    segmap = np.stack([gs, np.arange(NS) - poff[gs]], 1)
    # the window rows of csrc/partition_level.cu (kWinMeta = 4 columns)
    wmeta = np.stack([blk_off, nblk, soff, np.zeros(G, np.int64)], 1)
    meta = np.concatenate([s.reshape(-1), wmeta.reshape(-1),
                           np.stack([nseg, poff], 1).reshape(-1),
                           blkmap.reshape(-1), segmap.reshape(-1)])
    if int(wc.sum()) >= 2 ** 31:
        raise ValueError("a level's windows hold 2**31 rows or more")
    seg_rows = int(np.max(-(-wc // np.maximum(nseg, 1)))) if G else 0
    return meta.astype(np.int32), NB, NS, int(wc.sum()), seg_rows


def partition_hist_level_cuda(rows: torch.Tensor, scals, *,
                              num_features: int, num_bins: int, voff: int,
                              bpc: int = 1, packed: bool = False,
                              quantized: bool = False):
    """Launch the hand-written level pass (``csrc/partition_level.cu``) over
    every window of ``scals``; partitions ``rows`` in place."""
    from .. import kernels
    _check_store(rows, voff, num_features, num_bins)
    s = _scals_host(scals, num_bins)
    G, S = s.shape
    n, W = rows.shape
    check_windows(s[:, 0], s[:, 1], n)
    dev = rows.device
    hist = torch.empty((G, num_features, 2, num_bins), dtype=torch.float32,
                       device=dev)
    if G == 0:
        return rows, hist, torch.zeros((0,), dtype=torch.int32, device=dev)
    meta, NB, NS, srows, seg_rows = level_meta(s, num_features, num_bins)
    if NS > _MAX_GRID_Y or G > _MAX_GRID_Y:
        raise ValueError("%d windows in %d histogram segments exceed the "
                         "grid's %d rows" % (G, NS, _MAX_GRID_Y))
    if quantized:
        check_int_segments(seg_rows, 1)
    # the one host->device copy, from pinned memory so that it does not
    # wait for the stream's earlier work
    meta_dev = torch.from_numpy(meta).pin_memory().to(dev, non_blocking=True)
    scratch = torch.empty((max(srows, 1), W), dtype=torch.uint8, device=dev)
    work = torch.empty((NB + 3 * G,), dtype=torch.int32, device=dev)
    partial = torch.empty((max(NS, 1), num_features, 2, num_bins),
                          dtype=torch.int32 if quantized else torch.float64,
                          device=dev)
    lib = kernels.library("partition_level")
    err = lib.lgbt_partition_level(
        rows.data_ptr(), scratch.data_ptr(), W, meta_dev.data_ptr(), G, S,
        NB, NS, bpc, int(packed), num_bins // 32, num_features, num_bins,
        voff, int(quantized), work.data_ptr(), partial.data_ptr(),
        hist.data_ptr(), cuda_stream_ptr(rows))
    count_launch("partition_level")
    kernels.check(err, "partition_level kernel")
    return rows, hist, work[NB:NB + G]


def partition_hist_level(rows: torch.Tensor, scals, *, num_features: int,
                         num_bins: int, voff: int, bpc: int = 1,
                         packed: bool = False, quantized: bool = False):
    """Level-batched split pass -> (rows_new, hist [G, F, 2, B] f32,
    nl [G] i32) over the disjoint windows of ``scals`` [G, S].

    A CUDA tensor goes through the kernel (one call, in place) or raises; a
    CPU tensor through the plain version."""
    fn = (partition_hist_level_cuda if rows.is_cuda
          else partition_hist_level_plain)
    return fn(rows, scals, num_features=num_features, num_bins=num_bins,
              voff=voff, bpc=bpc, packed=packed, quantized=quantized)
