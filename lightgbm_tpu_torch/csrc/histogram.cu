// Root histogram over a window of the combined row store.
//
// Replaces lightgbm_tpu/core/histogram.py `histogram_pallas_rows` — the
// factored `_hist_kernel_rows_fac` (pallas_call at histogram.py:743) and the
// classic `_hist_kernel_rows` (histogram.py:774, the TPU's wide-F layout),
// which compute the same function in two TPU layouts.  The kernels, what
// bounds them on the card (device-memory bytes: the bin sectors and the g/h
// sector of each row, 64 B at F = 28 and 2,048 B at F = 2000) and the design
// against that bound are described in hist_common.cuh, which partition.cu
// shares.
//
// lgbt_hist_rows_window takes the window from device memory (the
// histogram pool's rebuilt parent in the leaf-wise device build).
//
// Plain C interface for ctypes: pointers and the stream as void*, the CUDA
// error of the launches returned as an int.
#include "hist_common.cuh"

extern "C" int lgbt_hist_rows(const void* rows, int W, int voff, int bpc,
                              int packed, int F, int B, int f_begin,
                              long long start, long long count, int nseg,
                              void* partial, void* out, void* stream) {
  lgbt::HistArgs a = lgbt::hist_args_one(
      static_cast<const uint8_t*>(rows), W, voff, bpc, packed, F, B, f_begin,
      start, count, nullptr, nseg);
  a.partial = static_cast<double*>(partial);
  return (int)lgbt::launch_hist(a, static_cast<float*>(out),
                                static_cast<cudaStream_t>(stream));
}

// The same histogram with its window in device memory (the histogram
// pool's rebuilt parent, core/histogram.py `histogram_rows_window`): `win`
// holds the window's {start, count} as int32 on the card, and no window
// holds more than `bound` rows.  The grid is sized for `bound`; every block
// derives from the count it reads the segments (`_segments`, at most
// `seg_cap`) and the feature tile that lgbt_hist_rows gives that count, and
// blocks past them exit, so each bin's f64 sum is the same sequence of
// additions as lgbt_hist_rows' at that count, bit for bit.  A count of 0
// writes a zero histogram.  `partial` holds the f64 partials of a
// `bound`-row window (null when that is one segment).  Nothing is read
// back and nothing copied to the card, so a CUDA graph can capture it.
extern "C" int lgbt_hist_rows_window(const void* rows, int W, int voff,
                                     int bpc, int packed, int F, int B,
                                     int f_begin, const void* win,
                                     long long bound, int seg_cap,
                                     void* partial, void* out,
                                     void* stream) {
  const int* wn = static_cast<const int*>(win);
  lgbt::HistArgs a = lgbt::hist_args_one(
      static_cast<const uint8_t*>(rows), W, voff, bpc, packed, F, B, f_begin,
      0, 0, wn, 1);
  a.partial = static_cast<double*>(partial);
  a.dyn_wc = wn + 1;
  a.seg_cap = seg_cap;
  return (int)lgbt::launch_hist_window(a, bound, static_cast<float*>(out),
                                       static_cast<cudaStream_t>(stream));
}
