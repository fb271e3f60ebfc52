// Histogram kernels shared by histogram.cu (root histograms), partition.cu
// and partition_level.cu (the smaller child's histogram after a split's
// partition) and histogram_masked.cu (separate bins and values).
//
// Replaces lightgbm_tpu/core/histogram.py `histogram_pallas_rows`: the
// factored kernel `_hist_kernel_rows_fac` (pallas_call at histogram.py:743)
// and the classic `_hist_kernel_rows` (histogram.py:774), which the TPU takes
// past its 4 MiB accumulator gate (wide F, e.g. F = 2000 at B = 256), and the
// classic `_hist_tile` branch of the fused split kernels (partition.py:281).
// The two TPU layouts compute one function; here one kernel serves both.
// Through the bins/values addressing of HistArgs it also replaces
// `_hist_kernel_mxu` (pallas_call at histogram.py:303, histogram_masked.cu).
// The TPU built the histogram as a one-hot contraction on the MXU with a
// bf16 hi/lo split of the values because it has no fast scatter; Hopper
// does, so this is a plain scatter-add into shared memory.
//
// What bounds it on the card: device-memory bytes.  Each row contributes the
// 32-byte sectors that hold its bin bytes (ceil(F * bpc / 32) of them) and
// the one that holds its f32 grad/hess (row-store layout: bins at byte 0,
// g/h at `voff`): 64 B per row at F = 28, 2,048 B at F = 2000.  The output
// [F, 2, B] f32 is small next to that.
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
//   only on (row count, F, B) (core/histogram.py `_segments`: about 2048 rows
//   a segment, at most 528 segments, and at most 256 MiB of f64 partials, so
//   a root histogram at F = 2000, B = 256 takes 32 segments), so the result
//   is bitwise reproducible.
// - Sums are kept in f64 (shared-memory accumulators, partials and pass 2)
//   and rounded to f32 once, so the histogram is the correctly rounded sum
//   up to f64 error whatever the segmentation.  An f32 running sum over a
//   million rows drifts by ~1e-5 relative, enough to flip near-equal leaf
//   gains between this kernel and the plain version (which also sums in f64).
// - Feature tiles are balanced (equal features per tile) and the tile is
//   the fast grid axis, so the tiles of one segment run together and the
//   later tiles read the segment's rows from L2.
// - Rows are read kRowBatch at a time per thread before the shared-memory
//   updates, so the loads of a batch are in flight together.
// - Known limit (later work): one thread per (feature, channel) gives a block
//   only 2 * tile threads (48 at F = 2000, B = 256: 24 features of 4 KB of
//   f64 accumulators fill the 96 KB budget), so occupancy and load latency,
//   not bandwidth, bound it.
// - A window axis (HistArgs::seg_map) lets one launch cover many windows
//   (the level pass, partition_level.cu).  Each window keeps the segment
//   count its single-window call would use, so its sums are those of that
//   call bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbt {

// Shared memory one block may hold for its feature tile's f64 histogram.
constexpr int kHistSmemBudget = 96 * 1024;
constexpr int kRowBatch = 8;

// Bin code of column `col` of one row's bin bytes: nibble-packed, or `bpc`
// little-endian bytes (1: u8, 2: u16/i16, 4: i32).
__device__ __forceinline__ int decode_bin(const uint8_t* __restrict__ row,
                                          int col, int bpc, int packed) {
  if (packed) {
    int byte = row[col >> 1];
    return (byte >> ((col & 1) * 4)) & 15;
  }
  if (bpc == 2) return row[2 * col] | (row[2 * col + 1] << 8);
  if (bpc == 4)
    return (int)((unsigned)row[4 * col] | ((unsigned)row[4 * col + 1] << 8) |
                 ((unsigned)row[4 * col + 2] << 16) |
                 ((unsigned)row[4 * col + 3] << 24));
  return row[col];
}

// A bin code outside [0, B) adds nothing (a segment sum drops it).
__device__ __forceinline__ bool bin_ok(int bn, int B) {
  return (unsigned)bn < (unsigned)B;
}

struct HistArgs {
  // Row r's bin bytes start at bins + r * bstride; its f32 grad at
  // vals + r * vstride and its hess `vchan` bytes further.  The row store
  // [R, W] is bins = rows, bstride = W, vals = rows + voff, vstride = W,
  // vchan = 4; separate bins [R, F] and values [2, R] are bstride = F * bpc,
  // vstride = 4, vchan = 4 * R.
  const uint8_t* bins;
  long long bstride;
  const uint8_t* vals;
  long long vstride, vchan;
  int bpc, packed;
  int F, B, f_begin;     // histogram features [f_begin, f_begin + F)
  long long start, count;
  const int* win;        // optional device {start, count} per window ([G, 2]);
                         // overrides start/count
  int nseg, ft;          // row segments (one window), features per tile
  // Window axis (the level pass): grid row y covers window seg_map[2y] and
  // its segment seg_map[2y + 1]; window g has seg_info[2g] segments whose
  // partials start at row seg_info[2g + 1].  nullptr: one window, grid row
  // y = segment y, partial row y.
  const int* seg_map;
  const int* seg_info;
  int grid_y;            // grid rows: nseg, or the length of seg_map
  int nwin;              // windows of the output [nwin, F, 2, B]
  double* partial;       // [rows of partials, F, 2, B] (exact kernel)
  int* ipartial;         // the same in int32 (integer kernel, hist_int.cuh)
};

// Window, segment, segment count and partial row of grid row blockIdx.y.
struct SegPos {
  int g, seg, nseg;
  long long prow, start, count;
};

__device__ __forceinline__ SegPos seg_pos(const HistArgs& a) {
  SegPos p;
  p.g = 0;
  p.seg = blockIdx.y;
  p.nseg = a.nseg;
  p.prow = blockIdx.y;
  if (a.seg_map != nullptr) {
    p.g = a.seg_map[2 * blockIdx.y];
    p.seg = a.seg_map[2 * blockIdx.y + 1];
    p.nseg = a.seg_info[2 * p.g];
    p.prow = (long long)a.seg_info[2 * p.g + 1] + p.seg;
  }
  p.start = a.start;
  p.count = a.count;
  if (a.win != nullptr) {
    p.start = a.win[2 * p.g];
    p.count = a.win[2 * p.g + 1];
  }
  return p;
}

__device__ __forceinline__ float row_value(const HistArgs& a, long long r,
                                           int c) {
  return *reinterpret_cast<const float*>(a.vals + (size_t)c * a.vchan +
                                         (size_t)r * a.vstride);
}

__global__ void hist_seg_kernel(HistArgs a) {
  extern __shared__ double sh[];  // [nf, 2, B]
  const SegPos p = seg_pos(a);
  const int f0 = blockIdx.x * a.ft;
  const int nf = min(a.ft, a.F - f0);
  const int B = a.B;
  for (int i = threadIdx.x; i < nf * 2 * B; i += blockDim.x) sh[i] = 0.0;
  __syncthreads();

  const long long seglen = (p.count + p.nseg - 1) / p.nseg;
  const long long r0 = p.start + (long long)p.seg * seglen;
  const long long r1 = min(r0 + seglen, p.start + p.count);

  const int t = threadIdx.x;
  if (t < 2 * nf) {
    const int f = t % nf;
    const int c = t / nf;
    const int col = a.f_begin + f0 + f;
    double* h = sh + (f * 2 + c) * B;
    long long r = r0;
    for (; r + kRowBatch <= r1; r += kRowBatch) {
      int bn[kRowBatch];
      float v[kRowBatch];
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        bn[j] = decode_bin(a.bins + (size_t)(r + j) * a.bstride, col, a.bpc,
                           a.packed);
        v[j] = row_value(a, r + j, c);
      }
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j)
        if (bin_ok(bn[j], B)) h[bn[j]] += v[j];
    }
    for (; r < r1; ++r) {
      const int bn = decode_bin(a.bins + (size_t)r * a.bstride, col, a.bpc,
                                a.packed);
      const float v = row_value(a, r, c);
      if (bin_ok(bn, B)) h[bn] += v;
    }
  }
  __syncthreads();
  double* out = a.partial + (size_t)p.prow * a.F * 2 * B + (size_t)f0 * 2 * B;
  for (int i = threadIdx.x; i < nf * 2 * B; i += blockDim.x) out[i] = sh[i];
}

// Segments of window g = blockIdx.y, and the row of its first partial.
__device__ __forceinline__ void window_segments(const int* seg_info, int nseg,
                                                int* n, size_t* p0) {
  *n = nseg;
  *p0 = 0;
  if (seg_info != nullptr) {
    *n = seg_info[2 * blockIdx.y];
    *p0 = seg_info[2 * blockIdx.y + 1];
  }
}

// out[g] = the window's partials summed in segment order (a window with no
// segments gets zeros).
__global__ void hist_reduce_kernel(const double* __restrict__ partial,
                                   const int* __restrict__ seg_info,
                                   int nseg, int total,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int n;
  size_t p0;
  window_segments(seg_info, nseg, &n, &p0);
  double s = 0.0;
  for (int k = 0; k < n; ++k) s += partial[(p0 + k) * total + i];
  out[(size_t)blockIdx.y * total + i] = static_cast<float>(s);
}

// Feature tiling shared by both histogram kernels: balanced tiles of at most
// kHistSmemBudget / per_feature features; returns the tile count (0 when one
// feature does not fit) and sets a->ft.
inline int hist_tiles(HistArgs* a, int per_feature, int max_ft) {
  int ft_max = kHistSmemBudget / per_feature;
  if (ft_max < 1 || a->F < 1) return 0;
  if (ft_max > max_ft) ft_max = max_ft;
  const int ntiles = (a->F + ft_max - 1) / ft_max;
  a->ft = (a->F + ntiles - 1) / ntiles;
  return ntiles;
}

// Launch both passes on `stream`; `partial` holds grid_y * F * 2 * B
// doubles and `out` nwin * F * 2 * B floats.
inline cudaError_t launch_hist(HistArgs a, float* out, cudaStream_t stream) {
  const int per_feature = 2 * a.B * (int)sizeof(double);
  const int ntiles = hist_tiles(&a, per_feature, 512);  // 2 * ft threads
  if (ntiles == 0) return cudaErrorInvalidValue;
  const int smem = a.ft * per_feature;
  const int threads = ((2 * a.ft + 31) / 32) * 32;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (a.grid_y > 0) {
    hist_seg_kernel<<<dim3(ntiles, a.grid_y), threads, smem, stream>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int total = a.F * 2 * a.B;
  hist_reduce_kernel<<<dim3((total + 255) / 256, a.nwin), 256, 0, stream>>>(
      a.partial, a.seg_info, a.nseg, total, out);
  return cudaGetLastError();
}

// HistArgs with no rows, one window [start, start + count) (or the window
// that `win` holds on the device) in `nseg` segments.
inline HistArgs hist_args_window(int bpc, int packed, int F, int B,
                                 int f_begin, long long start,
                                 long long count, const int* win, int nseg) {
  HistArgs a;
  a.bins = nullptr;
  a.bstride = 0;
  a.vals = nullptr;
  a.vstride = 0;
  a.vchan = 0;
  a.bpc = bpc;
  a.packed = packed;
  a.F = F;
  a.B = B;
  a.f_begin = f_begin;
  a.start = start;
  a.count = count;
  a.win = win;
  a.nseg = nseg;
  a.ft = 0;
  a.seg_map = nullptr;
  a.seg_info = nullptr;
  a.grid_y = nseg;
  a.nwin = 1;
  a.partial = nullptr;
  a.ipartial = nullptr;
  return a;
}

// The same over the row store [R, W] (bins at byte 0, f32 g/h at `voff`).
inline HistArgs hist_args_one(const uint8_t* rows, int W, int voff, int bpc,
                              int packed, int F, int B, int f_begin,
                              long long start, long long count,
                              const int* win, int nseg) {
  HistArgs a = hist_args_window(bpc, packed, F, B, f_begin, start, count,
                                win, nseg);
  a.bins = rows;
  a.bstride = W;
  a.vals = rows + voff;
  a.vstride = W;
  a.vchan = 4;
  return a;
}

}  // namespace lgbt
