// Integer histogram for quantized gradients, shared by histogram_int.cu (root
// histograms), partition.cu and partition_level.cu (the children's
// histograms after a split pass).
//
// Replaces the quantized operand of lightgbm_tpu/core/histogram.py
// `histogram_pallas_rows` (pallas_call at histogram.py:743 with
// quantized=True: the 2-row integer operand of `_hist_channels`,
// histogram.py:343-347) and the quantized child histogram of the fused split
// kernels (partition.py:1080, `_partition_call(quantized=True)`).  Under
// hist_precision=quantized the row store holds integer-valued f32 at `voff`:
// q_g in [-127, 127], q_h in [0, 255] (core/quant.py).
//
// What bounds it on the card: device-memory bytes, as for the exact kernel:
// the 32-byte sectors of a row's bins and the one of its g/h, 64 bytes a
// row at F = 28 (about 20 us per million rows at 3.35 TB/s), 2,048 at
// F = 2000.
//
// Design, and what it does about that bound:
// - Integer addition is exact and associative, so shared-memory atomicAdd on
//   int32 gives the same bits whatever order the threads add in.  Every
//   thread of a 256-thread block takes whole rows and adds both channels of
//   every feature of its tile into the block's [tile, 2, B] int32
//   histogram; this lifts the exact kernel's limit of one thread per
//   (feature, channel).
// - For one-byte, unpacked bins with 16-byte aligned rows (the row store),
//   a thread reads each 32-byte window of the tile's columns as two 16-byte
//   vectors and takes each bin from registers, so a row costs two loads per
//   bin sector instead of one load per feature: one window at 28 features,
//   two or three for a 48-feature tile at F = 2000.  Other layouts decode
//   each bin from memory (decode_bin).
// - Overflow: a block's partial is int32, so a segment of at most
//   (2^31 - 1) / 255 rows (the wrapper checks it; segments are ~2048 rows,
//   longer where the partial budget caps their count at wide F).
//   Pass 2 sums the partials of a window in int64 and converts to f32 once:
//   a root hess bin of 10.5M rows can reach 255 * 10.5M > 2^31.
// - The segmentation and window axis are the exact kernel's (HistArgs in
//   hist_common.cuh), so one launch also serves a whole level's windows.
#pragma once

#include "hist_common.cuh"

namespace lgbt {

constexpr int kHistIntThreads = 256;

__device__ __forceinline__ void add_row(int* __restrict__ h, int B, int f,
                                        int bn, int qg, int qh) {
  if (bin_ok(bn, B)) {
    if (qg != 0) atomicAdd(h + (2 * f) * B + bn, qg);
    if (qh != 0) atomicAdd(h + (2 * f + 1) * B + bn, qh);
  }
}

__global__ void hist_int_seg_kernel(HistArgs a) {
  extern __shared__ int shi[];  // [nf, 2, B]
  const SegPos p = seg_pos(a);
  const int f0 = blockIdx.x * a.ft;
  const int nf = min(a.ft, a.F - f0);
  const int B = a.B;
  for (int i = threadIdx.x; i < nf * 2 * B; i += blockDim.x) shi[i] = 0;
  __syncthreads();

  const long long seglen = (p.count + p.nseg - 1) / p.nseg;
  const long long r0 = p.start + (long long)p.seg * seglen;
  const long long r1 = min(r0 + seglen, p.start + p.count);
  const int c0 = a.f_begin + f0;
  // the 32-byte windows [w0, w1) covering the tile's columns lie in the row
  const int w0 = c0 & ~31;
  const int w1 = (c0 + nf + 31) & ~31;
  const bool vec = !a.packed && a.bpc == 1 && a.bstride % 16 == 0 &&
                   w1 <= a.bstride &&
                   reinterpret_cast<uintptr_t>(a.bins) % 16 == 0;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const uint8_t* row = a.bins + (size_t)r * a.bstride;
    const int qg = __float2int_rn(row_value(a, r, 0));
    const int qh = __float2int_rn(row_value(a, r, 1));
    if (vec) {
      for (int base = w0; base < w1; base += 32) {
        const uint4 v0 = reinterpret_cast<const uint4*>(row + base)[0];
        const uint4 v1 = reinterpret_cast<const uint4*>(row + base)[1];
        const unsigned w[8] = {v0.x, v0.y, v0.z, v0.w,
                               v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const int col = base + c;
          if (col >= c0 && col < c0 + nf)
            add_row(shi, B, col - c0, (w[c >> 2] >> ((c & 3) * 8)) & 255, qg,
                    qh);
        }
      }
    } else {
      for (int f = 0; f < nf; ++f)
        add_row(shi, B, f, decode_bin(row, c0 + f, a.bpc, a.packed), qg, qh);
    }
  }
  __syncthreads();
  int* out = a.ipartial + (size_t)p.prow * a.F * 2 * B + (size_t)f0 * 2 * B;
  for (int i = threadIdx.x; i < nf * 2 * B; i += blockDim.x) out[i] = shi[i];
}

// out[g] = the window's int32 partials summed in int64, converted to f32
// once (a window with no segments gets zeros).
__global__ void hist_int_reduce_kernel(const int* __restrict__ partial,
                                       const int* __restrict__ seg_info,
                                       int nseg, int total,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int n;
  size_t p0;
  window_segments(seg_info, nseg, &n, &p0);
  long long s = 0;
  for (int k = 0; k < n; ++k) s += partial[(p0 + k) * total + i];
  out[(size_t)blockIdx.y * total + i] = __ll2float_rn(s);
}

// Launch both passes on `stream`; `ipartial` holds grid_y * F * 2 * B int32
// and `out` nwin * F * 2 * B floats.
inline cudaError_t launch_hist_int(HistArgs a, float* out,
                                   cudaStream_t stream) {
  const int per_feature = 2 * a.B * (int)sizeof(int);
  const int ntiles = hist_tiles(&a, per_feature, 1 << 30);
  if (ntiles == 0) return cudaErrorInvalidValue;
  const int smem = a.ft * per_feature;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_int_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  if (a.grid_y > 0) {
    hist_int_seg_kernel<<<dim3(ntiles, a.grid_y), kHistIntThreads, smem,
                          stream>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int total = a.F * 2 * a.B;
  hist_int_reduce_kernel<<<dim3((total + 255) / 256, a.nwin), 256, 0,
                           stream>>>(a.ipartial, a.seg_info, a.nseg, total,
                                     out);
  return cudaGetLastError();
}

}  // namespace lgbt
