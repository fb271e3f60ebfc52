"""Feature histograms over the combined row store, and over separate bins
and values.

Counterpart of ``lightgbm_tpu/core/histogram.py`` ``histogram_rows``: per
(feature, bin) sums of grad and hess over rows ``[start, start + count)`` of the
u8 row store (bin bytes at column 0, f32 grad/hess at ``voff``), returned as
``[F, 2, B]`` f32.  The TPU runs this function through two kernels, the
factored one and, past its accumulator gate (wide F such as 2000 features at
256 bins), the classic packed-tile one; here one kernel serves every F.

Two versions of the one function live here:

- :func:`histogram_rows_plain`, plain PyTorch: the row store is split into
  bins and values (``rows_split``, the counterpart of ``rows_split_xla``) and
  summed with flattened-id ``index_add_`` calls over row chunks (the
  counterpart of ``histogram_xla_masked``).
- :func:`histogram_rows_cuda`, the wrapper of the hand-written kernel in
  ``csrc/histogram.cu`` (see ``csrc/hist_common.cuh`` for its design).

With ``quantized=True`` (``hist_precision=quantized``) the g/h bytes of the
row store hold integer-valued f32 (``core/quant.py``) and the result is their
exact integer sums, rounded to f32 once: the plain version sums in int64
(:func:`histogram_plain_int`), a CUDA tensor goes through the integer kernel
``csrc/histogram_int.cu`` (design in ``csrc/hist_int.cuh``) on a grid of its
own (:func:`int_hist_grid`).

:func:`histogram_masked` is the counterpart of ``histogram_pallas_masked`` /
``histogram_xla_masked`` over separate ``bins`` [R, F] (or nibble-packed) and
channel-major ``values`` [2, R], with the kernel ``csrc/histogram_masked.cu``;
:func:`build_histogram` (over all rows) is its entry point.

Each dispatcher takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.  The TPU's one-hot MXU
contraction, bf16 hi/lo split and factored accumulator layout are TPU-only and
are not carried over.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import check_tensor, count_launch, cuda_stream_ptr
from ..plan import state as _plan_state

from ..device import DeviceLike, resolve_device

# row segments per kernel launch: about 2048 rows each, at most this many,
# and at most as many as keep the f64 partials [nseg, F, 2, B] within the
# budget (32 segments at F = 2000, B = 256; no cap below 2,340 at F = 28)
_SEG_ROWS = 2048
_MAX_SEGMENTS = 528
_PARTIAL_BUDGET = 256 << 20     # bytes
# rows x features per index_add_ call of the plain versions
_PLAIN_CHUNK = 1 << 24


def pad_bins_pow2(num_bins: int) -> int:
    """Histogram bin width: next power of two, min 32 (bitset words and the
    reference's kernel-block width, ``_pad_bins_pow2``)."""
    b = 32
    while b < num_bins:
        b *= 2
    return b


def unpack_nibbles(packed: torch.Tensor, num_cols: int) -> torch.Tensor:
    """[N, ceil(C/2)] nibble-packed u8 -> [N, C] bin codes."""
    lo = packed & 15
    hi = (packed >> 4) & 15
    return torch.stack([lo, hi], dim=2).reshape(
        packed.shape[0], 2 * packed.shape[1])[:, :num_cols]


def f32_column(rows: torch.Tensor, off: int) -> torch.Tensor:
    """Little-endian f32 stored in 4 byte columns of the row store."""
    return rows[:, off:off + 4].contiguous().view(torch.float32).reshape(-1)


def rows_split(rows: torch.Tensor, num_features: int, voff: int, bpc: int = 1,
               packed: bool = False, f_begin: int = 0):
    """Row store -> (bins [N, F] i64, values [2, N] f32)."""
    if packed:
        if f_begin:
            raise ValueError("feature windows are not used with nibble packing")
        bins = unpack_nibbles(rows[:, :(num_features + 1) // 2], num_features)
    elif bpc == 2:
        sl = rows[:, 2 * f_begin:2 * (f_begin + num_features)].long()
        bins = sl[:, 0::2] | (sl[:, 1::2] << 8)
    else:
        bins = rows[:, f_begin:f_begin + num_features]
    values = torch.stack([f32_column(rows, voff), f32_column(rows, voff + 4)])
    return bins.long(), values


def _row_chunks(n: int, num_features: int):
    """Row ranges of at most ``_PLAIN_CHUNK`` (row, feature) pairs."""
    step = max(1, _PLAIN_CHUNK // max(num_features, 1))
    return [(r, min(r + step, n)) for r in range(0, n, step)]


def _hist_sums(chunks, num_features: int, num_bins: int, quantized: bool,
               device) -> torch.Tensor:
    """[F, 2, B] sums of ``values`` [2, n] by ``bins`` [n, F] over the
    (bins, values) ``chunks`` in row order: f64 (or int64 of the rounded
    values when ``quantized``), rounded to f32 once.  One index_add_ per
    chunk over flattened (feature, bin) ids; out-of-range bins are dropped
    like a segment sum drops them."""
    f = num_features
    dtype = torch.int64 if quantized else torch.float64
    out = torch.zeros((f * num_bins + 1, 2), dtype=dtype, device=device)
    offs = torch.arange(f, device=device)[None, :] * num_bins
    for bins, values in chunks:
        n = bins.shape[0]
        b = bins.long()
        ids = torch.where((b >= 0) & (b < num_bins), b + offs, f * num_bins)
        vals = values.t().round() if quantized else values.t()
        out.index_add_(0, ids.reshape(-1),
                       vals.to(dtype)[:, None, :].expand(n, f, 2)
                       .reshape(n * f, 2))
    return out[:-1].reshape(f, num_bins, 2).permute(0, 2, 1).float() \
        .contiguous()


def histogram_plain(bins: torch.Tensor, values: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """[F, 2, B] sums of ``values`` [2, N] by ``bins`` [N, F], summed in f64
    and rounded to f32 once, as the kernel does, so the two agree to the last
    bit or two."""
    f = bins.shape[1]
    return _hist_sums(((bins[a:b], values[:, a:b])
                       for a, b in _row_chunks(bins.shape[0], f)),
                      f, num_bins, False, bins.device)


def histogram_plain_int(bins: torch.Tensor, values: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """[F, 2, B] exact sums of integer-valued ``values`` [2, N] by ``bins``
    [N, F]: summed in int64, converted to f32 once."""
    f = bins.shape[1]
    return _hist_sums(((bins[a:b], values[:, a:b])
                       for a, b in _row_chunks(bins.shape[0], f)),
                      f, num_bins, True, bins.device)


def histogram_rows_plain(rows: torch.Tensor, num_bins: int, start: int,
                         count: int, *, num_features: int, voff: int,
                         bpc: int = 1, packed: bool = False,
                         f_begin: int = 0, quantized: bool = False,
                         weight: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of the row-store histogram.  ``weight`` [count]
    (optional) multiplies each window row's values (a 0/1 side mask)."""
    window = rows[start:start + count]

    def chunks():
        for a, b in _row_chunks(count, num_features):
            bins, values = rows_split(window[a:b], num_features, voff, bpc,
                                      packed, f_begin)
            if weight is not None:
                values = values * weight[a:b][None]
            yield bins, values
    return _hist_sums(chunks(), num_features, num_bins, quantized,
                      rows.device)


def _segments(count: int, num_features: int, num_bins: int) -> int:
    """Row segments of a kernel launch over ``count`` rows: a function of
    (count, F, B) only, so every launch of a window sums in the same order."""
    cap = _PARTIAL_BUDGET // (num_features * 2 * num_bins * 8)
    cap = max(1, min(_MAX_SEGMENTS, cap))
    return max(1, min(cap, -(-count // _SEG_ROWS)))


# rows one block of the integer kernel can sum: its int32 partial holds
# |sum| <= rows * 255 (its packed shared-memory sums hold twice as many)
_INT_BLOCK_ROWS = (2 ** 31 - 1) // 255
# the integer kernel's grid (csrc/hist_int.cuh): the shared memory of one
# copy of a tile's int32 sums (kIntHistSmem), the fewest rows worth a
# segment of their own, the most rows of a window whose feature tiles narrow
# before its rows split, and the most rows a block of such a window stages
# in turn; the blocks it aims at are the plan's int_fill_blocks (two an SM
# of the H100 in the analytic plan, plan/device_specs.py)
_INT_HIST_SMEM = 64 << 10
_INT_SEG_ROWS = 1024
_INT_SMALL_ROWS = 1 << 16
_INT_SMALL_SEG_ROWS = 4096


def int_hist_grids(count: np.ndarray, num_features: int, num_bins: int,
                   blocks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The integer kernel's grid over windows of ``count`` rows, each aiming
    at its entry of ``blocks`` blocks where its rows allow it: (features a
    block, row segments), int64 arrays of one entry a window.

    The widest tile is what one copy of its sums leaves in shared memory.  A
    small window (at most ``_INT_SMALL_ROWS`` rows) narrows its tiles first,
    since the blocks of a window of one segment write its histogram
    themselves: down to one feature a block when its rows make one segment,
    two when they make more (a block of two features stages each row once
    for both).  Its rows still split into segments of at most
    ``_INT_SMALL_SEG_ROWS``, since a block stages its rows in turn (a level
    pass gives each window few blocks).  Then the rows split into segments
    of at least ``_INT_SEG_ROWS`` rows up to the target, and into as many as
    keep each block within ``_INT_BLOCK_ROWS``.  Integer sums are exact, so
    the bits do not depend on the grid."""
    count = np.asarray(count, dtype=np.int64)
    blocks = np.asarray(blocks, dtype=np.int64)
    f = num_features
    ft_max = max(1, min(f, _INT_HIST_SMEM // (8 * num_bins)))
    wide = -(-f // ft_max)
    row_segs = -(-count // _INT_SEG_ROWS)
    small = count <= _INT_SMALL_ROWS
    need = np.where(small, np.maximum(1, -(-count // _INT_SMALL_SEG_ROWS)), 1)
    narrowest = np.where(row_segs <= 1, f, -(-f // 2))
    narrow = np.maximum(wide, np.minimum(narrowest, -(-blocks // need)))
    ntiles = np.where(small, narrow, wide)
    nseg = np.maximum(np.maximum(np.minimum(row_segs, blocks // ntiles), need),
                      -(-count // _INT_BLOCK_ROWS))
    return -(-f // ntiles), nseg


def int_hist_grid(count: int, num_features: int, num_bins: int,
                  blocks: Optional[int] = None) -> Tuple[int, int]:
    """:func:`int_hist_grids` of one window of ``count`` rows: (features a
    block, row segments), aiming at ``blocks`` blocks (the active plan's
    ``int_fill_blocks`` when None, ``plan/state.py``)."""
    if blocks is None:
        blocks = _plan_state.int_fill_blocks()
    ft, nseg = int_hist_grids(np.array([count]), num_features, num_bins,
                              np.array([blocks]))
    return int(ft[0]), int(nseg[0])


def check_int_segments(count: int, nseg: int) -> None:
    """Refuse a window whose blocks (``nseg`` segments of it) could hold
    more rows than one block of the integer kernel can sum."""
    if -(-count // nseg) > _INT_BLOCK_ROWS:
        raise ValueError("%d rows in %d segments overflow the int32 partials "
                         "(at most %d rows a block)"
                         % (count, nseg, _INT_BLOCK_ROWS))


# the most bins the exact kernel's block of one feature with 4-byte bins can
# take: hist_block_smem(1, B, 4, 0) <= kHistSmemMax in csrc/hist_common.cuh,
# whose launch_hist refuses a larger block
_MAX_BINS = 10905


def check_hist_shape(num_features: int, num_bins: int) -> None:
    """Refuse what the kernels' shared-memory tiling cannot take: a block
    of one feature, with 4-byte bins, must fit in one SM's shared memory
    (up to _MAX_BINS bins)."""
    if num_features < 1 or not 1 <= num_bins <= _MAX_BINS:
        raise ValueError("histogram kernel needs num_features >= 1 and "
                         "1 <= num_bins <= %d, got %d, %d"
                         % (_MAX_BINS, num_features, num_bins))


def exact_partials(nseg: int, num_features: int, num_bins: int,
                   device) -> Optional[torch.Tensor]:
    """The exact kernel's f64 segment partials [nseg, F, 2, B], or None for
    one segment, whose histogram the kernel writes itself."""
    if nseg == 1:
        return None
    return torch.empty((nseg, num_features, 2, num_bins),
                       dtype=torch.float64, device=device)


def int_accumulator(nseg: int, num_features: int, num_bins: int,
                    device) -> Optional[torch.Tensor]:
    """The integer kernel's int64 accumulator [1, F, 2, B] of a window of
    ``nseg`` segments (the launch zeroes it), or None for one segment, whose
    histogram its blocks write themselves."""
    if nseg == 1:
        return None
    return torch.empty((1, num_features, 2, num_bins), dtype=torch.int64,
                       device=device)


def data_ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def histogram_rows_cuda(rows: torch.Tensor, num_bins: int, start: int,
                        count: int, *, num_features: int, voff: int,
                        bpc: int = 1, packed: bool = False,
                        f_begin: int = 0,
                        quantized: bool = False) -> torch.Tensor:
    """Launch the hand-written histogram kernel (``csrc/histogram.cu``), or
    the integer one (``csrc/histogram_int.cu``) when ``quantized``."""
    from .. import kernels
    check_tensor(rows, "rows", torch.uint8, ndim=2)
    n, W = rows.shape
    if not 0 <= start <= start + count <= n:
        raise ValueError("window [%d, %d) outside %d rows"
                         % (start, start + count, n))
    if voff % 4 or voff + 8 > W:
        raise ValueError("voff %d must be 4-aligned with 8 bytes inside W=%d"
                         % (voff, W))
    ncol = ((num_features + f_begin + 1) // 2 if packed
            else (num_features + f_begin) * bpc)
    if ncol > voff:
        raise ValueError("bin columns overlap the values at voff")
    check_hist_shape(num_features, num_bins)
    out = torch.empty((num_features, 2, num_bins), dtype=torch.float32,
                      device=rows.device)
    args = (rows.data_ptr(), W, voff, bpc, int(packed), num_features,
            num_bins, f_begin, start, count)
    if quantized:
        name = "histogram_int"
        ft, nseg = int_hist_grid(count, num_features, num_bins)
        check_int_segments(count, nseg)
        acc = int_accumulator(nseg, num_features, num_bins, rows.device)
        err = kernels.library(name).lgbt_hist_rows_int(
            *args, nseg, ft, data_ptr(acc), out.data_ptr(),
            cuda_stream_ptr(rows))
    else:
        name = "histogram"
        nseg = _segments(count, num_features, num_bins)
        partial = exact_partials(nseg, num_features, num_bins, rows.device)
        err = kernels.library(name).lgbt_hist_rows(
            *args, nseg, data_ptr(partial), out.data_ptr(),
            cuda_stream_ptr(rows))
    count_launch(name)
    kernels.check(err, "%s kernel" % name)
    return out


def histogram_rows(rows: torch.Tensor, num_bins: int, start: int, count: int,
                   *, num_features: int, voff: int, bpc: int = 1,
                   packed: bool = False, f_begin: int = 0,
                   quantized: bool = False) -> torch.Tensor:
    """Histogram of rows ``[start, start + count)`` -> [F, 2, B] f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    the plain version."""
    fn = histogram_rows_cuda if rows.is_cuda else histogram_rows_plain
    return fn(rows, num_bins, int(start), int(count),
              num_features=num_features, voff=voff, bpc=bpc, packed=packed,
              f_begin=f_begin, quantized=quantized)


# ---- separate bins and values (``histogram_pallas_masked``) ----

_BIN_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def _check_masked(bins: torch.Tensor, values: torch.Tensor, num_bins: int,
                  start: int, count: int, num_cols: int) -> int:
    """The JAX entry's shape rules; returns the feature count."""
    if bins.dim() != 2:
        raise ValueError("bins must be [R, F], got shape %s"
                         % (tuple(bins.shape),))
    n, width = bins.shape
    if tuple(values.shape) != (2, n):
        raise ValueError("values must be [2, %d], got shape %s"
                         % (n, tuple(values.shape)))
    if not (128 % num_bins == 0 or num_bins % 128 == 0):
        raise ValueError("num_bins must divide or be a multiple of 128 (use "
                         "pad_bins_pow2); got %d" % num_bins)
    if not 0 <= start <= start + count <= n:
        raise ValueError("window [%d, %d) outside %d rows"
                         % (start, start + count, n))
    if num_cols and (num_cols + 1) // 2 != width:
        raise ValueError("nibble-packed bins of %d columns need %d bytes a "
                         "row, got %d" % (num_cols, (num_cols + 1) // 2,
                                          width))
    return num_cols or width


def histogram_masked_plain(bins: torch.Tensor, values: torch.Tensor,
                           num_bins: int, start: int, count: int,
                           num_cols: int = 0) -> torch.Tensor:
    """Plain version (``histogram_xla_masked``): [F, 2, B] sums over rows
    ``[start, start + count)``, summed in f64 and rounded to f32 once."""
    f = _check_masked(bins, values, num_bins, start, count, num_cols)
    window = bins[start:start + count]
    vals = values[:, start:start + count]

    def chunks():
        for a, b in _row_chunks(count, f):
            part = window[a:b]
            yield (unpack_nibbles(part, num_cols) if num_cols else part,
                   vals[:, a:b])
    return _hist_sums(chunks(), f, num_bins, False, bins.device)


def histogram_masked_cuda(bins: torch.Tensor, values: torch.Tensor,
                          num_bins: int, start: int, count: int,
                          num_cols: int = 0) -> torch.Tensor:
    """Launch the hand-written masked histogram
    (``csrc/histogram_masked.cu``)."""
    from .. import kernels
    f = _check_masked(bins, values, num_bins, start, count, num_cols)
    if not bins.is_cuda or bins.dtype not in _BIN_BYTES:
        raise TypeError("bins must be a CUDA u8, i16 or i32 tensor, got %s on "
                        "%s" % (bins.dtype, bins.device))
    if num_cols and bins.dtype != torch.uint8:
        raise TypeError("nibble-packed bins must be u8")
    check_tensor(bins, "bins", bins.dtype, ndim=2)
    check_tensor(values, "values", torch.float32, ndim=2)
    if values.device != bins.device:
        raise ValueError("bins on %s, values on %s"
                         % (bins.device, values.device))
    check_hist_shape(f, num_bins)
    n, width = bins.shape
    out = torch.empty((f, 2, num_bins), dtype=torch.float32,
                      device=bins.device)
    nseg = _segments(count, f, num_bins)
    partial = exact_partials(nseg, f, num_bins, bins.device)
    bpc = _BIN_BYTES[bins.dtype]
    err = kernels.library("histogram_masked").lgbt_hist_masked(
        bins.data_ptr(), width * bpc, bpc, int(bool(num_cols)),
        values.data_ptr(), n, f, num_bins, start, count, nseg,
        data_ptr(partial), out.data_ptr(), cuda_stream_ptr(bins))
    count_launch("histogram_masked")
    kernels.check(err, "histogram_masked kernel")
    return out


def histogram_masked(bins: torch.Tensor, values: torch.Tensor, num_bins: int,
                     start: int, count: int,
                     num_cols: int = 0) -> torch.Tensor:
    """Histogram over rows ``[start, start + count)`` of ``bins`` [R, F]
    (u8/i16/i32, or nibble-packed u8 [R, ceil(F/2)] with ``num_cols`` = F)
    weighted by ``values`` [2, R] f32 (channel-major, not pre-masked) ->
    [F, 2, B] f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    the plain version."""
    fn = histogram_masked_cuda if bins.is_cuda else histogram_masked_plain
    return fn(bins, values, num_bins, int(start), int(count),
              num_cols=num_cols)


def build_histogram(bins, values, num_bins: int, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """[F, 2, B] f32 histogram of every row of ``bins`` [N, F] (values
    [2, N] pre-masked): the counterpart of ``build_histogram`` /
    ``histogram_pallas``.

    ``bins`` and ``values`` (tensors or arrays) are moved to ``device``,
    ``cuda`` unless the caller passes ``"cpu"``."""
    dev = resolve_device(device)
    bins = torch.as_tensor(bins).to(dev)
    values = torch.as_tensor(values, dtype=torch.float32).to(dev)
    if bins.dtype == torch.int64:
        bins = bins.to(torch.int32)
    return histogram_masked(bins.contiguous(), values.contiguous(), num_bins,
                            0, bins.shape[0])
