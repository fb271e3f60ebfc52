// Histogram over a window of separate bins and values.
//
// Replaces lightgbm_tpu/core/histogram.py `histogram_pallas_masked` and
// `histogram_pallas` (the kernel `_hist_kernel_mxu`, pallas_call at
// histogram.py:303), which `build_histogram` (histogram.py:856) reaches:
// per (feature, bin) sums of grad and hess over rows [start, start + count)
// of `bins` [R, F] (u8, i16 or i32; or nibble-packed u8 [R, ceil(F / 2)])
// weighted by `values` [2, R] f32, channel-major, not pre-masked.
//
// What bounds it on the card: device-memory bytes, each row's bin bytes
// (F * bytes per bin) and its two f32 values (8 B): 36 B a row at F = 28
// with u8 bins, about 11 us per million rows at 3.35 TB/s.
//
// Design: the row-store kernel of hist_common.cuh, addressed through
// HistArgs' bins pointer and row stride and its separate value pointers
// (bins = `bins`, stride F * bytes per bin; grad at `values`, hess R floats
// further), so the two cannot drift apart: rows staged through shared
// memory, per-segment f64 shared-memory sums in row order (a warp per
// feature, lanes over rows), partials reduced in segment order, rounded to
// f32 once; no float atomics, so the same input gives the same bits.  The
// TPU's window masking of whole row tiles (`in_w`) becomes the segment
// bounds: rows outside the window are never read.
//
// Plain C interface for ctypes: pointers and the stream as void*, the CUDA
// error of the launches returned as an int.
#include "hist_common.cuh"

extern "C" int lgbt_hist_masked(const void* bins, long long bstride, int bpc,
                                int packed, const void* values, long long R,
                                int F, int B, long long start, long long count,
                                int nseg, void* partial, void* out,
                                void* stream) {
  lgbt::HistArgs a = lgbt::hist_args_window(bpc, packed, F, B, 0, start,
                                            count, nullptr, nseg);
  a.bins = static_cast<const uint8_t*>(bins);
  a.bstride = bstride;
  a.vals = static_cast<const uint8_t*>(values);
  a.vstride = 4;
  a.vchan = 4 * R;
  a.partial = static_cast<double*>(partial);
  return (int)lgbt::launch_hist(a, static_cast<float*>(out),
                                static_cast<cudaStream_t>(stream));
}
