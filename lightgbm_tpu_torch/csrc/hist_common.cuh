// Row-store histogram kernels shared by histogram.cu (root histograms) and
// partition.cu (the smaller child's histogram after a split's partition).
//
// Replaces lightgbm_tpu/core/histogram.py `histogram_pallas_rows`: the
// factored kernel `_hist_kernel_rows_fac` (pallas_call at histogram.py:743)
// and, as the same function, the classic `_hist_kernel_rows`
// (histogram.py:774).  The TPU built the histogram as a one-hot contraction
// on the MXU with a bf16 hi/lo split of the values because it has no fast
// scatter; Hopper does, so this is a plain f32 scatter-add into shared memory.
//
// What bounds it on the card: device-memory bytes.  Each row contributes the
// 32-byte sector that holds its bin bytes and the one that holds its f32
// grad/hess (row-store layout: bins at byte 0, g/h at `voff`), so a window of
// `count` rows needs count * 64 bytes, about 20 us per million rows at
// 3.35 TB/s.  The output [F, 2, B] f32 is tiny next to that.
//
// Design, and what it does about that bound, determinism and accuracy:
// - The reference's contract is that the same input gives the same bits on
//   every run, so there are no floating-point atomics.  Pass 1 gives each
//   block one contiguous segment of rows and one tile of features; inside
//   the block each thread OWNS one (feature, channel) pair and walks the
//   segment's rows in order, so no two threads ever write the same bin and
//   each bin's sum has a fixed order.  The block writes its partial
//   [tile, 2, B] to device memory; pass 2 sums the partials over segments in
//   segment order, one thread per output element.  The segmentation depends
//   only on the row count, so the result is bitwise reproducible.
// - Sums are kept in f64 (shared-memory accumulators, partials and pass 2)
//   and rounded to f32 once, so the histogram is the correctly rounded sum
//   up to f64 error whatever the segmentation.  An f32 running sum over a
//   million rows drifts by ~1e-5 relative, enough to flip near-equal leaf
//   gains between this kernel and the plain version (which also sums in f64).
// - Feature tiles are balanced (equal features per tile) and the tile is
//   the fast grid axis, so the tiles of one segment run together and the
//   second tile reads the segment's rows from L2.
// - Rows are read 4 at a time per thread before the 4 shared-memory updates,
//   so the loads of a batch are in flight together.
// - Known limit (later work): one thread per (feature, channel) gives a block
//   only 2 * tile threads, so occupancy, not bandwidth, bounds it today.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbt {

// Shared memory one block may hold for its feature tile's f64 histogram.
constexpr int kHistSmemBudget = 96 * 1024;

__device__ __forceinline__ int decode_bin(const uint8_t* __restrict__ row,
                                          int col, int bpc, int packed) {
  if (packed) {
    int byte = row[col >> 1];
    return (byte >> ((col & 1) * 4)) & 15;
  }
  if (bpc == 2) return row[2 * col] | (row[2 * col + 1] << 8);
  return row[col];
}

struct HistArgs {
  const uint8_t* rows;   // [R, W] u8 row store
  int W, voff, bpc, packed;
  int F, B, f_begin;     // histogram features [f_begin, f_begin + F)
  long long start, count;
  const int* win;        // optional device {start, count}; overrides the above
  int nseg, ft;          // row segments, features per tile
  double* partial;       // [nseg, F, 2, B]
};

__global__ void hist_seg_kernel(HistArgs a) {
  extern __shared__ double sh[];  // [nf, 2, B]
  const int seg = blockIdx.y;
  const int f0 = blockIdx.x * a.ft;
  const int nf = min(a.ft, a.F - f0);
  const int B = a.B;
  for (int i = threadIdx.x; i < nf * 2 * B; i += blockDim.x) sh[i] = 0.0;
  __syncthreads();

  long long start = a.start, count = a.count;
  if (a.win != nullptr) {
    start = a.win[0];
    count = a.win[1];
  }
  const long long seglen = (count + a.nseg - 1) / a.nseg;
  const long long r0 = start + (long long)seg * seglen;
  const long long r1 = min(r0 + seglen, start + count);

  const int t = threadIdx.x;
  if (t < 2 * nf) {
    const int f = t % nf;
    const int c = t / nf;
    const int col = a.f_begin + f0 + f;
    double* h = sh + (f * 2 + c) * B;
    const uint8_t* base = a.rows + (size_t)a.voff + 4 * c;
    long long r = r0;
    for (; r + 4 <= r1; r += 4) {
      int bn[4];
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* row = a.rows + (size_t)(r + j) * a.W;
        bn[j] = decode_bin(row, col, a.bpc, a.packed);
        v[j] = *reinterpret_cast<const float*>(base + (size_t)(r + j) * a.W);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (bn[j] < B) h[bn[j]] += v[j];
    }
    for (; r < r1; ++r) {
      const uint8_t* row = a.rows + (size_t)r * a.W;
      int bn = decode_bin(row, col, a.bpc, a.packed);
      float v = *reinterpret_cast<const float*>(base + (size_t)r * a.W);
      if (bn < B) h[bn] += v;
    }
  }
  __syncthreads();
  double* out = a.partial + (size_t)seg * a.F * 2 * B + (size_t)f0 * 2 * B;
  for (int i = threadIdx.x; i < nf * 2 * B; i += blockDim.x) out[i] = sh[i];
}

__global__ void hist_reduce_kernel(const double* __restrict__ partial,
                                   int nseg, int total,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  double s = 0.0;
  for (int k = 0; k < nseg; ++k) s += partial[(size_t)k * total + i];
  out[i] = static_cast<float>(s);
}

// Launch both passes on `stream`; `partial` holds nseg * F * 2 * B doubles.
inline cudaError_t launch_hist(HistArgs a, float* out, cudaStream_t stream) {
  const int per_feature = 2 * a.B * (int)sizeof(double);
  int ft_max = kHistSmemBudget / per_feature;
  if (ft_max < 1 || a.F < 1) return cudaErrorInvalidValue;
  if (ft_max > 512) ft_max = 512;  // 2 * ft threads per block
  const int ntiles = (a.F + ft_max - 1) / ft_max;
  const int ft = (a.F + ntiles - 1) / ntiles;  // balanced tiles
  a.ft = ft;
  const int smem = ft * per_feature;
  const int threads = ((2 * ft + 31) / 32) * 32;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  hist_seg_kernel<<<dim3(ntiles, a.nseg), threads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int total = a.F * 2 * a.B;
  hist_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      a.partial, a.nseg, total, out);
  return cudaGetLastError();
}

}  // namespace lgbt
