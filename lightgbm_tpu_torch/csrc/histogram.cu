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
