// Root histogram over a window of the row store under quantized gradients:
// exact integer sums of the integer-valued f32 grad/hess at `voff`.
//
// Replaces the quantized form of lightgbm_tpu/core/histogram.py
// `histogram_pallas_rows` with quantized=True: the factored pallas_call at
// histogram.py:743 and the classic one at :774).  The kernel, what bounds
// it on the card (device-memory bytes: the bin sectors and the g/h sector of
// each row) and the design against that bound are described in hist_int.cuh,
// which partition.cu and partition_level.cu share.
//
// Plain C interface for ctypes: pointers and the stream as void*, the CUDA
// error of the launches returned as an int.
#include "hist_int.cuh"

// The window [start, start + count) in `nseg` segments of `ft`-feature tiles
// (core/histogram.py `int_hist_grid`); `acc` holds F * 2 * B int64 for a
// window of several segments (unused, and may be null, for one).
extern "C" int lgbt_hist_rows_int(const void* rows, int W, int voff, int bpc,
                                  int packed, int F, int B, int f_begin,
                                  long long start, long long count, int nseg,
                                  int ft, void* acc, void* out,
                                  void* stream) {
  lgbt::HistArgs a = lgbt::hist_args_one(
      static_cast<const uint8_t*>(rows), W, voff, bpc, packed, F, B, f_begin,
      start, count, nullptr, nseg);
  lgbt::IntGrid q = lgbt::int_grid_one(nseg, ft);
  q.acc = static_cast<unsigned long long*>(acc);
  return (int)lgbt::launch_hist_int(a, q, 0, nseg > 1,
                                    static_cast<float*>(out),
                                    static_cast<cudaStream_t>(stream));
}

// The same with the window's {start, count} in device memory (`win`,
// int32; the histogram pool's rebuilt parent): the grid of a `bound`-row
// window (`nseg` segments of `ft`-feature tiles, `int_hist_grid` of the
// bound), whose blocks read the window and cut it in `nseg` segments.
// Integer sums do not depend on the grid, so the result equals
// lgbt_hist_rows_int's bit for bit; a count of 0 gives a zero histogram.
extern "C" int lgbt_hist_rows_int_window(const void* rows, int W, int voff,
                                         int bpc, int packed, int F, int B,
                                         int f_begin, const void* win,
                                         int nseg, int ft, void* acc,
                                         void* out, void* stream) {
  lgbt::HistArgs a = lgbt::hist_args_one(
      static_cast<const uint8_t*>(rows), W, voff, bpc, packed, F, B, f_begin,
      0, 0, static_cast<const int*>(win), nseg);
  lgbt::IntGrid q = lgbt::int_grid_one(nseg, ft);
  q.acc = static_cast<unsigned long long*>(acc);
  return (int)lgbt::launch_hist_int(a, q, 0, nseg > 1,
                                    static_cast<float*>(out),
                                    static_cast<cudaStream_t>(stream));
}
