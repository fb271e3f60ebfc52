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
CUDA tensor it launches the kernel or raises.  With ``quantized=True``
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
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from ..device import check_tensor, count_launch, count_routes, cuda_stream_ptr
from ..io.binning import MissingType
from ..plan import planner as _planner
from ..plan import state as _plan_state
from .histogram import (_segments, check_hist_shape,
                        check_int_segments, data_ptr, exact_partials,
                        histogram_rows_plain, int_accumulator, int_hist_grid,
                        int_hist_grids)

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
    if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
        raise ValueError("the level pass reads src and writes dst: they must "
                         "be two row stores, not one")
    if (src.shape != dst.shape or src.dtype != dst.dtype
            or src.device != dst.device):
        raise ValueError("src %s %s on %s and dst %s %s on %s must match"
                         % (tuple(src.shape), src.dtype, src.device,
                            tuple(dst.shape), dst.dtype, dst.device))
    check_windows(s[:, 0], s[:, 1], src.shape[0])


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
