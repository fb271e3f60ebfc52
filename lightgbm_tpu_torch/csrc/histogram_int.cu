// Root histogram over a window of the row store under quantized gradients:
// exact integer sums of the integer-valued f32 grad/hess at `voff`.
//
// Replaces the quantized form of lightgbm_tpu/core/histogram.py
// `histogram_pallas_rows` (pallas_call at histogram.py:743 with
// quantized=True).  The kernels, what bounds them on the card (device-memory
// bytes: 64 B per row) and the design against that bound are described in
// hist_int.cuh, which partition.cu and partition_level.cu share.
//
// Plain C interface for ctypes: pointers and the stream as void*, the CUDA
// error of the launches returned as an int.
#include "hist_int.cuh"

extern "C" int lgbt_hist_rows_int(const void* rows, int W, int voff, int bpc,
                                  int packed, int F, int B, int f_begin,
                                  long long start, long long count, int nseg,
                                  void* partial, void* out, void* stream) {
  lgbt::HistArgs a = lgbt::hist_args_one(
      static_cast<const uint8_t*>(rows), W, voff, bpc, packed, F, B, f_begin,
      start, count, nullptr, nseg);
  a.ipartial = static_cast<int*>(partial);
  return (int)lgbt::launch_hist_int(a, static_cast<float*>(out),
                                    static_cast<cudaStream_t>(stream));
}
