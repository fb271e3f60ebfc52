"""Feature histograms over the combined row store.

Counterpart of ``lightgbm_tpu/core/histogram.py`` ``histogram_rows``: per
(feature, bin) sums of grad and hess over rows ``[start, start + count)`` of the
u8 row store (bin bytes at column 0, f32 grad/hess at ``voff``), returned as
``[F, 2, B]`` f32.

Two versions of the one function live here:

- :func:`histogram_rows_plain`, plain PyTorch: the row store is split into
  bins and values (``rows_split``, the counterpart of ``rows_split_xla``) and
  summed with one flattened-id ``index_add_`` (the counterpart of
  ``histogram_xla_masked``).
- :func:`histogram_rows_cuda`, the wrapper of the hand-written kernel in
  ``csrc/histogram.cu`` (see ``csrc/hist_common.cuh`` for its design).

:func:`histogram_rows` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.  The TPU's one-hot MXU
contraction, bf16 hi/lo split and factored accumulator layout are TPU-only and
are not carried over.
"""
from __future__ import annotations

import torch

from ..device import check_tensor, count_launch, cuda_stream_ptr

# row segments per kernel launch: about 2048 rows each, at most this many
_SEG_ROWS = 2048
_MAX_SEGMENTS = 528


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


def histogram_plain(bins: torch.Tensor, values: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """[F, 2, B] sums of ``values`` [2, N] by ``bins`` [N, F] (one index_add_
    over flattened (feature, bin) ids; out-of-range bins are dropped like a
    segment sum drops them).  Summed in f64 and rounded to f32 once, as the
    kernel does, so the two agree to the last bit or two."""
    n, f = bins.shape
    ids = bins + torch.arange(f, device=bins.device)[None, :] * num_bins
    keep = (bins >= 0) & (bins < num_bins)
    ids = torch.where(keep, ids, f * num_bins)           # overflow slot
    vals = values.t().double()[:, None, :].expand(n, f, 2).reshape(n * f, 2)
    out = torch.zeros((f * num_bins + 1, 2), dtype=torch.float64,
                      device=bins.device)
    out.index_add_(0, ids.reshape(-1), vals)
    return out[:-1].reshape(f, num_bins, 2).permute(0, 2, 1).float() \
        .contiguous()


def histogram_rows_plain(rows: torch.Tensor, num_bins: int, start: int,
                         count: int, *, num_features: int, voff: int,
                         bpc: int = 1, packed: bool = False,
                         f_begin: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the row-store histogram."""
    window = rows[start:start + count]
    bins, values = rows_split(window, num_features, voff, bpc, packed, f_begin)
    return histogram_plain(bins, values, num_bins)


def _segments(count: int) -> int:
    return max(1, min(_MAX_SEGMENTS, -(-count // _SEG_ROWS)))


def check_hist_shape(num_features: int, num_bins: int) -> None:
    """Refuse what the kernel's shared-memory tiling cannot take: one
    feature's f64 [2, B] accumulators must fit the 96 KB block budget."""
    if num_features < 1 or not 1 <= num_bins <= 6144:
        raise ValueError("histogram kernel needs num_features >= 1 and "
                         "1 <= num_bins <= 6144, got %d, %d"
                         % (num_features, num_bins))


def histogram_rows_cuda(rows: torch.Tensor, num_bins: int, start: int,
                        count: int, *, num_features: int, voff: int,
                        bpc: int = 1, packed: bool = False,
                        f_begin: int = 0) -> torch.Tensor:
    """Launch the hand-written histogram kernel (``csrc/histogram.cu``)."""
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
    nseg = _segments(count)
    partial = torch.empty((nseg, num_features, 2, num_bins),
                          dtype=torch.float64, device=rows.device)
    lib = kernels.library("histogram")
    err = lib.lgbt_hist_rows(rows.data_ptr(), W, voff, bpc, int(packed),
                             num_features, num_bins, f_begin, start, count,
                             nseg, partial.data_ptr(), out.data_ptr(),
                             cuda_stream_ptr(rows))
    count_launch("histogram")
    kernels.check(err, "histogram kernel")
    return out


def histogram_rows(rows: torch.Tensor, num_bins: int, start: int, count: int,
                   *, num_features: int, voff: int, bpc: int = 1,
                   packed: bool = False, f_begin: int = 0) -> torch.Tensor:
    """Histogram of rows ``[start, start + count)`` -> [F, 2, B] f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    the plain version."""
    fn = histogram_rows_cuda if rows.is_cuda else histogram_rows_plain
    return fn(rows, num_bins, int(start), int(count),
              num_features=num_features, voff=voff, bpc=bpc, packed=packed,
              f_begin=f_begin)
