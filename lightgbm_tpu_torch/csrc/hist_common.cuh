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
// does, so this is a scatter-add into shared memory.
//
// What bounds it on the card: device-memory bytes.  Each row contributes the
// 32-byte sectors that hold its bin bytes (ceil(F * bpc / 32) of them) and
// the one that holds its f32 grad/hess (row-store layout: bins at byte 0,
// g/h at `voff`): 64 B per row at F = 28, 2,048 B at F = 2000.  The output
// [F, 2, B] f32 is small next to that.  What keeps it from that bound is the
// shared-memory work of adding each (row, feature) into an f64 accumulator
// in a fixed order: about 20-25 shared-memory accesses (bank conflicts
// included) per 32 (row, feature) pairs.
//
// Design, and what it does about that bound, determinism and accuracy:
// - The reference's contract is that the same input gives the same bits on
//   every run, so there are no floating-point atomics.  Pass 1 gives each
//   block one contiguous segment of rows and one tile of features and sums
//   the segment into the tile's f64 [nf, B] (grad, hess) accumulators in
//   shared memory; the block writes its partial [tile, 2, B] to device
//   memory, and pass 2 sums the partials over segments in segment order, one
//   thread per output element.  The segmentation depends only on
//   (row count, F, B) (core/histogram.py `_segments`: about 2048 rows a
//   segment, at most 528 segments, and at most 256 MiB of f64 partials), so
//   the result is bitwise reproducible.
// - Rows are staged through shared memory: all threads of the block copy a
//   chunk of rows (the 16-byte units that hold the tile's bin
//   bytes, and each row's grad and hess) with cp.async into one of two
//   buffers while the block sums the other, so device-memory latency is out
//   of the add chain and every load is coalesced.
// - Warps over rows, not threads over features: warp w owns features w,
//   w + 8, ... of the tile, both channels, so no two warps touch one
//   accumulator.  For each 32-row step of one feature, lane i takes row i's
//   bin from shared memory; the lanes with equal bins find each other
//   through lane masks in shared memory, and the group's lowest lane adds
//   its peers' grad and hess (f32 widened to f64) to the bin's accumulator
//   in ascending lane order, which is row order.  So each bin's sum within a
//   segment is the same sequence of f64 additions as a serial walk over the
//   segment's rows: the kernel's bits do not depend on its tiling, its block
//   size or its chunking, and equal those of the one-thread-per-(feature,
//   channel) kernel it replaced.
// - Occupancy: the feature tile is sized so that its accumulators, its
//   warps' lane masks and both staging buffers fit kHistSmemBudget, which
//   lets two blocks (16 warps) share an SM: 22 features a tile at B = 256
//   (91 tiles at F = 2000), or two balanced tiles of 14 at F = 28.  A grid
//   of few segments (a child's window) gets narrower tiles, down to one
//   feature a block, so that it still has kHistFillBlocks blocks.
// - Sums are kept in f64 (shared-memory accumulators, partials and pass 2)
//   and rounded to f32 once, so the histogram is the correctly rounded sum
//   up to f64 error whatever the segmentation.  An f32 running sum over a
//   million rows drifts by ~1e-5 relative, enough to flip near-equal leaf
//   gains between this kernel and the plain version (which also sums in f64).
// - Feature tiles are the fast grid axis, so the tiles of one segment run
//   together and the later tiles read the segment's rows from L2.
// - A window axis (HistArgs::seg_map) lets one launch cover many windows
//   (the level pass, partition_level.cu).  Each window keeps the segment
//   count its single-window call would use, so its sums are those of that
//   call bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbt {

constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one block of the exact kernel: its feature tile's f64
// accumulators, its warps' lane masks and two staging buffers.  Two such
// blocks share an SM (2 x (110 KB + 1 KB reserved) <= 228 KB).
constexpr int kHistSmemBudget = 110 * 1024;
// What one block may use at all: a single feature of many bins
// (core/histogram.py `_MAX_BINS`) takes up to this, one block an SM.
constexpr int kHistSmemMax = 227 * 1024;
constexpr int kHistWarps = 8;    // warps per block at most: one a feature
constexpr int kHistThreads = 32 * kHistWarps;
// rows per staging buffer: at least kHistChunk (the tiling's reckoning),
// grown into what the budget leaves, up to kHistMaxChunk
constexpr int kHistChunk = 128;
constexpr int kHistMaxChunk = 512;
constexpr int kHistFillBlocks = 2 * 132;  // blocks that fill an H100
// rows a segment (core/histogram.py `_SEG_ROWS`)
constexpr int kHistSegRows = 2048;

// Bin code of column `col` of one row's bin bytes, whose byte `off` is at
// `row`: nibble-packed, or `bpc` little-endian bytes (1: u8, 2: u16/i16,
// 4: i32).
__device__ __forceinline__ int decode_bin(const uint8_t* __restrict__ row,
                                          int col, int bpc, int packed,
                                          int off = 0) {
  if (packed) {
    int byte = row[(col >> 1) - off];
    return (byte >> ((col & 1) * 4)) & 15;
  }
  const uint8_t* p = row + col * bpc - off;
  if (bpc == 2) return p[0] | (p[1] << 8);
  if (bpc == 4)
    return (int)((unsigned)p[0] | ((unsigned)p[1] << 8) |
                  ((unsigned)p[2] << 16) | ((unsigned)p[3] << 24));
  return p[0];
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
  int unit, sstride;     // exact kernel: bytes per staged copy (16, 4 or 1),
  int chunk;             // bytes per staged row, rows per staging buffer
  float* out;            // exact kernel, one segment of one window: the f32
                         // histogram itself, written without pass 2
  // Window axis (the level pass): grid row y covers window seg_map[2y] and
  // its segment seg_map[2y + 1]; window g has seg_info[2g] segments whose
  // partials start at row seg_info[2g + 1].  nullptr: one window, grid row
  // y = segment y, partial row y.
  const int* seg_map;
  const int* seg_info;
  int grid_y;            // grid rows: nseg, or the length of seg_map
  int nwin;              // windows of the output [nwin, F, 2, B]
  double* partial;       // [rows of partials, F, 2, B] (exact kernel)
  // The split pass's device window (launch_hist_window): the parent
  // window's row count in device memory, from which every block derives
  // the child's segments (at most seg_cap) and its feature tile (the
  // widest is ft_wide); nullptr otherwise.
  const int* dyn_wc;
  int seg_cap, ft_wide;
  // The feature window's first column in device memory (the split pass's
  // scal row's trailing hist_feature_begin), read by every block in place
  // of f_begin; nullptr: f_begin.
  const int* dyn_fbegin;
};

// Window, segment, segment count and partial row of grid row blockIdx.y;
// g = -1 for a grid row past the map's segments (the level pass's
// device-window launch, partition_level.cu, sizes its grid for a bound).
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
    // past the level's segments (a device-built map sized for a bound)
    if (p.g < 0) return p;
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

// ---- asynchronous copies into shared memory (sm_80 and later) ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the exact kernel ----

// One staging buffer: [chunk][sstride] bin bytes, then [chunk] (grad,
// hess) f32 pairs.
__host__ __device__ __forceinline__ int hist_stage_bytes(int sstride,
                                                         int chunk) {
  return chunk * (sstride + 8);
}

// Bytes per staged row for a tile of `ft` features: the tile's bin bytes
// plus the slack of aligning their start to 16, rounded to an odd multiple
// of 16 so that the 32 rows a warp reads spread over eight banks.
__host__ __device__ __forceinline__ int hist_stage_stride(int ft, int bpc,
                                                          int packed) {
  const int bytes = packed ? (ft >> 1) + 1 : ft * bpc;
  int s = (bytes + 30) & ~15;
  if ((s >> 4) % 2 == 0) s += 16;
  return s;
}

// A block's shared memory: the tile's accumulators [ft, B] (grad, hess)
// f64, one warp's lane masks [B] for each of its min(ft, kHistWarps) warps,
// then the two staging buffers.
__host__ __device__ __forceinline__ int hist_stage_offset(int ft, int B) {
  const int nw = ft < kHistWarps ? ft : kHistWarps;
  return ft * B * (int)sizeof(double2) + ((nw * B * 4 + 15) & ~15);
}

inline int hist_block_smem(int ft, int B, int bpc, int packed) {
  return hist_stage_offset(ft, B) +
         2 * hist_stage_bytes(hist_stage_stride(ft, bpc, packed),
                              kHistChunk);
}

// Start copying rows [rb, rb + nrows) into `buf`: `nunits` units of
// a.unit bytes from byte b0 of each row's bins, and its grad and hess.
__device__ __forceinline__ void stage_rows(const HistArgs& a, uint8_t* buf,
                                           long long rb, int nrows, int b0,
                                           int nunits) {
  const int u = a.unit;
  for (int i = threadIdx.x; i < nrows * nunits; i += blockDim.x) {
    const int row = i / nunits, k = i - row * nunits;
    const uint8_t* src = a.bins + (size_t)(rb + row) * a.bstride + b0 + k * u;
    uint8_t* dst = buf + row * a.sstride + k * u;
    if (u == 16)
      cp_async16(dst, src);
    else if (u == 4)
      cp_async4(dst, src);
    else
      *dst = *src;
  }
  float* v = reinterpret_cast<float*>(buf + a.chunk * a.sstride);
  for (int i = threadIdx.x; i < 2 * nrows; i += blockDim.x)
    cp_async4(v + i, a.vals + (size_t)(i & 1) * a.vchan +
                         (size_t)(rb + (i >> 1)) * a.vstride);
  cp_async_commit();
}

// Add the `nrows` staged rows of `buf` to the tile's accumulators `acc`
// [nf, B]: warp w of nw takes features w, w + nw, ...; for each 32 rows the
// lanes with equal bins find each other through the warp's B lane masks in
// shared memory (`mask`, all zero between steps: each lane ORs its bit into
// its bin's mask and reads the mask back), and the lowest lane of each group
// adds the group's values in lane (= row) order and clears the mask.  (It
// finds the groups __match_any_sync finds, at about half the cost here.)
// kU8: one byte a bin, unpacked (the row store's layout), read without
// decode_bin's layout branches: 10% faster at 400,000 x 2000 (5.25 against
// 5.77 ms on an H100, chip_smoke.py phase 5), no change seen at 28 features.
template <bool kU8>
__device__ __forceinline__ void add_staged(const HistArgs& a,
                                           const uint8_t* buf, int nrows,
                                           int c0, int nf, int b0,
                                           double2* acc, unsigned* mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned me = 1u << lane;
  const float2* vals =
      reinterpret_cast<const float2*>(buf + a.chunk * a.sstride);
  for (int rg = 0; rg < nrows; rg += 32) {
    const int row = rg + lane;
    const bool ok = row < nrows;
    const float2 mine = vals[ok ? row : rg];
    const uint8_t* srow = buf + row * a.sstride;
    for (int f = warp; f < nf; f += nw) {
      int bn = -1;
      if (ok) {
        bn = kU8 ? srow[c0 + f - b0]
                 : decode_bin(srow, c0 + f, a.bpc, a.packed, b0);
        if (!bin_ok(bn, a.B)) bn = -1;
      }
      if (bn >= 0) atomicOr(mask + bn, me);
      __syncwarp();
      const unsigned peers = bn >= 0 ? mask[bn] : 0u;
      __syncwarp();
      if ((peers & (me - 1u)) == 0u && bn >= 0) {
        mask[bn] = 0u;
        // the leader's own row first, then its peers' in lane order
        double2* h = acc + f * a.B + bn;
        double2 s = *h;
        s.x += mine.x;
        s.y += mine.y;
        for (unsigned m = peers & (peers - 1u); m != 0u; m &= m - 1u) {
          const float2 v = vals[rg + __ffs(m) - 1];
          s.x += v.x;
          s.y += v.y;
        }
        *h = s;
      }
      __syncwarp();
    }
  }
}

// Bytes per staging buffer's rows for a tile of `ft` features: what the
// budget leaves after the accumulators and lane masks, within
// [kHistChunk, kHistMaxChunk] rows.
__host__ __device__ __forceinline__ int hist_chunk_rows(int ft, int B,
                                                       int sstride) {
  int c = (kHistSmemBudget - hist_stage_offset(ft, B)) / (2 * (sstride + 8)) /
          32 * 32;
  if (c < kHistChunk) c = kHistChunk;
  if (c > kHistMaxChunk) c = kHistMaxChunk;
  return c;
}

// Row segments of a split pass's child histogram: core/histogram.py
// `_segments` of the parent window's `wc` rows, at most `cap`.
__host__ __device__ __forceinline__ int hist_window_segments(long long wc,
                                                            int cap) {
  long long s = (wc + kHistSegRows - 1) / kHistSegRows;
  if (s > cap) s = cap;
  return s < 1 ? 1 : (int)s;
}

// launch_hist's feature tile for a grid of `nseg` segments: the widest tile
// `ft_wide`, narrowed until the grid has kHistFillBlocks blocks.  Returns
// the tile's features; *ntiles is the tile count.
__host__ __device__ __forceinline__ int hist_fill_tile(int F, int ft_wide,
                                                      int nseg, int* ntiles) {
  int nt = (F + ft_wide - 1) / ft_wide;
  const int fill = (kHistFillBlocks + nseg - 1) / nseg;
  if (nt < fill) nt = fill < F ? fill : F;
  const int ft = (F + nt - 1) / nt;
  *ntiles = (F + ft - 1) / ft;
  return ft;
}

// kDyn: the split pass's device window (HistArgs::dyn_wc).  The grid is one
// row of blocks sized for the largest window; each block derives the
// window's segments and feature tile from the row count it reads, takes
// (tile, segment) = (x % tiles, x / tiles), and a block past them exits.
// A window of one segment is written by its blocks, as launch_hist writes
// it: each bin's sum is the same sequence of f64 additions as a launch of
// the host-sized grid, so the two give the same bits.
template <bool kU8, bool kDyn>
__global__ void __launch_bounds__(kHistThreads, 2)
    hist_seg_kernel(HistArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (a.dyn_fbegin != nullptr) a.f_begin = *a.dyn_fbegin;
  SegPos p;
  int tile = blockIdx.x;
  if (kDyn) {
    int ntiles;
    p.nseg = hist_window_segments(*a.dyn_wc, a.seg_cap);
    a.ft = hist_fill_tile(a.F, a.ft_wide, p.nseg, &ntiles);
    if ((int)blockIdx.x >= ntiles * p.nseg) return;
    tile = blockIdx.x % ntiles;
    p.g = 0;
    p.seg = blockIdx.x / ntiles;
    p.prow = p.seg;
    p.start = a.win[0];
    p.count = a.win[1];
    a.sstride = hist_stage_stride(a.ft, a.bpc, a.packed);
    a.chunk = hist_chunk_rows(a.ft, a.B, a.sstride);
  } else {
    p = seg_pos(a);
    if (p.g < 0) return;
  }
  double2* acc = reinterpret_cast<double2*>(smem);  // [nf, B] (grad, hess)
  unsigned* masks = reinterpret_cast<unsigned*>(acc + a.ft * a.B);  // [nw, B]
  uint8_t* stage = smem + hist_stage_offset(a.ft, a.B);
  const int bufsz = hist_stage_bytes(a.sstride, a.chunk);
  const long long chunk = a.chunk;
  const int f0 = tile * a.ft;
  const int nf = min(a.ft, a.F - f0);
  const int B = a.B;
  // the lane masks of the tile's warps (a kDyn block may have more warps
  // than its tile has features; the others never touch a mask)
  const int nmask = kDyn ? min(a.ft, kHistWarps) : (int)(blockDim.x >> 5);
  for (int i = threadIdx.x; i < nf * B; i += blockDim.x)
    acc[i] = make_double2(0.0, 0.0);
  for (int i = threadIdx.x; i < nmask * B; i += blockDim.x)
    masks[i] = 0u;

  const long long seglen = (p.count + p.nseg - 1) / p.nseg;
  const long long r0 = p.start + (long long)p.seg * seglen;
  const long long r1 = min(r0 + seglen, p.start + p.count);
  const int nchunks =
      r1 > r0 ? (int)((r1 - r0 + chunk - 1) / chunk) : 0;
  // the tile's bin bytes [b0, b1) of each row, b0 aligned to the copy unit
  const int c0 = a.f_begin + f0;
  const int b0 = (a.packed ? c0 >> 1 : c0 * a.bpc) & ~(a.unit - 1);
  const int b1 = a.packed ? ((c0 + nf - 1) >> 1) + 1 : (c0 + nf) * a.bpc;
  const int nunits = (b1 - b0 + a.unit - 1) / a.unit;

  if (nchunks > 0)
    stage_rows(a, stage, r0, (int)min(chunk, r1 - r0), b0, nunits);
  for (int c = 0; c < nchunks; ++c) {
    const long long rb = r0 + c * chunk;
    if (c + 1 < nchunks) {
      const long long rn = rb + chunk;
      stage_rows(a, stage + ((c + 1) & 1) * bufsz, rn,
                 (int)min(chunk, r1 - rn), b0, nunits);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    add_staged<kU8>(a, stage + (c & 1) * bufsz,
                    (int)min(chunk, r1 - rb), c0, nf, b0,
                    acc, masks + (threadIdx.x >> 5) * B);
    __syncthreads();  // the buffer is refilled two chunks on
  }
  __syncthreads();
  // the partial [tile, 2, B], or with one segment the histogram itself
  // (pass 2 would round 0.0 + the partial: the same f32)
  double* part = a.partial + (size_t)p.prow * a.F * 2 * B + (size_t)f0 * 2 * B;
  float* out = a.out + (size_t)f0 * 2 * B;
  const bool direct = kDyn ? p.nseg == 1 : a.out != nullptr;
  for (int i = threadIdx.x; i < nf * 2 * B; i += blockDim.x) {
    const int f = i / (2 * B), c = (i / B) & 1, b = i % B;
    const double2 v = acc[f * B + b];
    if (direct)
      out[i] = static_cast<float>(c ? v.y : v.x);
    else
      part[i] = c ? v.y : v.x;
  }
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

// hist_reduce_kernel for the device window: the segments come from the
// parent's row count; a window of one segment was written by its blocks.
__global__ void hist_reduce_window_kernel(const double* __restrict__ partial,
                                          const int* __restrict__ dyn_wc,
                                          int seg_cap, int total,
                                          float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = hist_window_segments(*dyn_wc, seg_cap);
  if (i >= total || n == 1) return;
  double s = 0.0;
  for (int k = 0; k < n; ++k) s += partial[(size_t)k * total + i];
  out[i] = static_cast<float>(s);
}

// Let `kernel` take up to kHistSmemMax of shared memory.
static inline cudaError_t hist_configure(void (*kernel)(HistArgs)) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHistSmemMax);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The widest feature tile whose block fits kHistSmemBudget (one feature at
// least).
inline int hist_wide_tile(const HistArgs& a) {
  int ft = kHistSmemBudget / (a.B * (int)sizeof(double2));
  if (ft > a.F) ft = a.F;
  while (ft > 1 && hist_block_smem(ft, a.B, a.bpc, a.packed) > kHistSmemBudget)
    --ft;
  return ft;
}

// Bytes per staged copy: 16, 4 or 1, as the bins' base and stride allow.
inline int hist_copy_unit(const HistArgs& a) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.bins);
  return (base % 16 == 0 && a.bstride % 16 == 0)  ? 16
         : (base % 4 == 0 && a.bstride % 4 == 0) ? 4
                                                 : 1;
}

// Set the kernels' shared-memory attributes once per device and process
// (`configured`: one bit a device, each library its own).
static inline cudaError_t hist_configure_once(unsigned long long* configured,
                                              void (*k0)(HistArgs),
                                              void (*k1)(HistArgs)) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(*configured >> dev & 1ull)) {
    if ((e = hist_configure(k0)) != cudaSuccess ||
        (e = hist_configure(k1)) != cudaSuccess)
      return e;
    *configured |= 1ull << dev;
  }
  return cudaSuccess;
}

// Launch both passes on `stream`; `partial` holds grid_y * F * 2 * B
// doubles (unused, and may be null, for one segment of one window) and `out`
// nwin * F * 2 * B floats.  `static`: each library keeps
// its own copy, and with it its own record of the devices whose kernel
// attributes it has set (an inline function's static is one object across
// the libraries a process loads).
static inline cudaError_t launch_hist(HistArgs a, float* out,
                                      cudaStream_t stream) {
  if (a.F < 1 || a.B < 1 ||
      hist_block_smem(1, a.B, a.bpc, a.packed) > kHistSmemMax)
    return cudaErrorInvalidValue;
  // the widest tile within the budget (one feature at least), then balanced
  // tiles; a grid of few segments (a small window) gets narrower tiles,
  // down to one feature a block, so that it still fills the card (a
  // feature's sums do not depend on its tile)
  const int ft = hist_wide_tile(a);
  int ntiles = (a.F + ft - 1) / ft;
  a.ft = ft;
  if (a.grid_y > 0) a.ft = hist_fill_tile(a.F, ft, a.grid_y, &ntiles);
  // one warp per feature of the tile, at most kHistWarps
  const int threads = 32 * (a.ft < kHistWarps ? a.ft : kHistWarps);
  const bool u8 = a.bpc == 1 && !a.packed;
  a.sstride = hist_stage_stride(a.ft, a.bpc, a.packed);
  a.unit = hist_copy_unit(a);
  // staging buffers grown into what the budget leaves (a small tile's
  // segment then takes few round trips to device memory)
  a.chunk = hist_chunk_rows(a.ft, a.B, a.sstride);
  const int smem = hist_stage_offset(a.ft, a.B) +
                   2 * hist_stage_bytes(a.sstride, a.chunk);
  // one segment of one window: the kernel writes the histogram
  const bool direct = a.nseg == 1 && a.seg_map == nullptr;
  a.out = direct ? out : nullptr;
  static unsigned long long configured = 0;
  cudaError_t e = hist_configure_once(&configured,
                                      hist_seg_kernel<true, false>,
                                      hist_seg_kernel<false, false>);
  if (e != cudaSuccess) return e;
  if (a.grid_y > 0) {
    const dim3 grid(ntiles, a.grid_y);
    if (u8)
      hist_seg_kernel<true, false><<<grid, threads, smem, stream>>>(a);
    else
      hist_seg_kernel<false, false><<<grid, threads, smem, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (direct) return cudaSuccess;
  const int total = a.F * 2 * a.B;
  hist_reduce_kernel<<<dim3((total + 255) / 256, a.nwin), 256, 0, stream>>>(
      a.partial, a.seg_info, a.nseg, total, out);
  return cudaGetLastError();
}

// The child histogram of the split pass's device window: `a.win` holds the
// child's {start, count} and `a.dyn_wc` the parent's row count, both in
// device memory, and no window holds more than `bound` rows.  The grid,
// the threads and the shared memory are sized for the largest window; the
// blocks size themselves (hist_seg_kernel<., true>).  `a.partial` holds
// the segments of a `bound`-row window, `a.seg_cap` is `_segments`' cap;
// `out` F * 2 * B floats.
static inline cudaError_t launch_hist_window(HistArgs a, long long bound,
                                             float* out,
                                             cudaStream_t stream) {
  if (a.F < 1 || a.B < 1 || a.dyn_wc == nullptr || a.win == nullptr ||
      hist_block_smem(1, a.B, a.bpc, a.packed) > kHistSmemMax)
    return cudaErrorInvalidValue;
  a.ft_wide = hist_wide_tile(a);
  a.unit = hist_copy_unit(a);
  a.out = out;
  // The launch's shape depends on (bound, F, B, bpc, packed, seg_cap)
  // only, which a tree's launches share: found for the first of them and
  // kept, one entry a host thread.
  struct Shape {
    long long bound;
    int F, B, bpc, packed, seg_cap, nseg_max, blocks, threads, smem;
  };
  static thread_local Shape k = {-1, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (k.bound != bound || k.F != a.F || k.B != a.B || k.bpc != a.bpc ||
      k.packed != a.packed || k.seg_cap != a.seg_cap) {
    const int nseg_max = hist_window_segments(bound, a.seg_cap);
    int blocks = 1, ft_max = 1, smem = 0;
    for (int s = 1; s <= nseg_max; ++s) {
      int ntiles;
      const int ft = hist_fill_tile(a.F, a.ft_wide, s, &ntiles);
      const int ss = hist_stage_stride(ft, a.bpc, a.packed);
      const int need = hist_stage_offset(ft, a.B) +
                       2 * hist_stage_bytes(ss, hist_chunk_rows(ft, a.B, ss));
      if (ntiles * s > blocks) blocks = ntiles * s;
      if (ft > ft_max) ft_max = ft;
      if (need > smem) smem = need;
    }
    if (smem > kHistSmemMax) return cudaErrorInvalidValue;
    k = {bound, a.F, a.B, a.bpc, a.packed, a.seg_cap, nseg_max, blocks,
         32 * (ft_max < kHistWarps ? ft_max : kHistWarps), smem};
  }
  const int nseg_max = k.nseg_max, blocks = k.blocks, threads = k.threads,
            smem = k.smem;
  static unsigned long long configured = 0;
  cudaError_t e = hist_configure_once(&configured,
                                      hist_seg_kernel<true, true>,
                                      hist_seg_kernel<false, true>);
  if (e != cudaSuccess) return e;
  if (a.bpc == 1 && !a.packed)
    hist_seg_kernel<true, true><<<blocks, threads, smem, stream>>>(a);
  else
    hist_seg_kernel<false, true><<<blocks, threads, smem, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (nseg_max == 1) return cudaSuccess;
  const int total = a.F * 2 * a.B;
  hist_reduce_window_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      a.partial, a.dyn_wc, a.seg_cap, total, out);
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
  a.unit = 1;
  a.sstride = 0;
  a.chunk = kHistChunk;
  a.out = nullptr;
  a.seg_map = nullptr;
  a.seg_info = nullptr;
  a.grid_y = nseg;
  a.nwin = 1;
  a.partial = nullptr;
  a.dyn_wc = nullptr;
  a.dyn_fbegin = nullptr;
  a.seg_cap = 1;
  a.ft_wide = 1;
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
