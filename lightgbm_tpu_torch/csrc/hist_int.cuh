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
// F = 2000.  On a child window of a few thousand rows the bound is a few
// nanoseconds, and what counts is the launch: how many blocks, how many
// launches, how much each block zeroes and writes besides its rows.
//
// Design:
// - Integer addition is exact and associative, so the bits do not depend on
//   the order of the adds, the segmentation or the tiling: the kernel picks
//   its own grid (core/histogram.py `int_hist_grid`, from the window's rows,
//   F and B; in a level launch the windows share the 264 blocks by rows).
//   A small window gets narrow feature tiles first (down to two features a
//   block, or one when its rows make one segment), a large one more row
//   segments of the widest tile.  Narrow tiles re-read the rows' sectors,
//   mostly from L2; segments must be summed across blocks.
// - Rows are staged through shared memory with cp.async, double-buffered
//   (`stage_rows` of hist_common.cuh, up to kIntMaxChunk rows a buffer, so
//   a child window of 1,000 rows takes one round trip): each row's tile
//   bytes and its g/h.  Thread t then takes feature t % nf of every
//   (blockDim / nf)-th staged row, feature fastest, so a warp's lanes hit
//   different features' histograms, with no division per pair.
// - Two int32 shared atomics per (row, feature), grad and hess.  Each warp
//   adds into one of `ncopy` private copies of the tile's histogram, as
//   many as kIntHistSmem gives a narrow tile (up to kIntMaxCopies), so hot
//   bins do not serialize the block's warps.  A block sums at most
//   2^31 / 255 rows (the wrapper checks it), so int32 does not overflow.
//   (One packed 64-bit atomic, q_g * 2^32 + q_h, was slower at every size
//   measured: probes/hist_int_designs.py.)
// - A window of one segment (every small child) is written by its blocks
//   themselves, f32 from the copies' int64 sums, in one launch.  The blocks
//   of a window of several segments add their sums with int64 global
//   atomics into the window's accumulator row (zeroed by a memset in the
//   launch), and pass 2 rounds each sum to f32 once: the bits of one int64
//   sum.  (int32 partials of each segment summed by pass 2 lost at the root
//   and won by about a microsecond at 20,000 rows: the same probe.)
#pragma once

#include "hist_common.cuh"

namespace lgbt {

constexpr int kHistIntThreads = 512;
// Shared memory of one copy of a tile's sums [ft, 2, B] int32: the widest
// tile is kIntHistSmem / (8 B) features (core/histogram.py _INT_HIST_SMEM).
constexpr int kIntHistSmem = 64 * 1024;
// Both staging buffers of a block at most.
constexpr int kIntStageSmem = 48 * 1024;
constexpr int kIntMaxChunk = 1024;  // rows per staging buffer at most
constexpr int kIntMaxCopies = 8;
constexpr int kIntInfo = 4;  // per window: segments, accumulator row, ft,
                             // first block (level launches)

// How a launch cuts its windows.  One window (map == nullptr): blockIdx.x
// is the feature tile of `ft` features, blockIdx.y the segment of `nseg`.
// A level launch: block b works on window map[b] (-1: past the level's
// blocks, when the device-window level pass sizes the grid for a bound,
// partition_level.cu), whose info row holds its
// segment count (0 for an empty window, which pass 2 zeroes), its
// accumulator row (when it has several segments), its tile width and its
// first block; the window's blocks are (segment, tile) in order, tiles
// fastest.
struct IntGrid {
  const int* map;
  const int* info;
  int nseg, ft;
  int ft_max;   // the widest tile of the launch (shared memory)
  int ncopy;    // warp-private copies of a tile's histogram
  unsigned long long* acc;  // [nacc, F, 2, B] int64: a row for each window
  int nacc;                 // of several segments, zeroed by the launch
};

__host__ __device__ __forceinline__ int int_hist_offset(int ft, int B,
                                                        int ncopy) {
  return (ncopy * ft * B * 8 + 15) & ~15;
}

// Add (row, feature) pair (row, f) of the staged rows `buf` to this warp's
// copy `hist` [nf, 2, B] of the tile's histogram.
template <bool kU8>
__device__ __forceinline__ void int_add(const HistArgs& a, const uint8_t* buf,
                                        int row, int f, int c0, int b0,
                                        int* hist) {
  const uint8_t* srow = buf + row * a.sstride;
  const int bn = kU8 ? srow[c0 + f - b0]
                     : decode_bin(srow, c0 + f, a.bpc, a.packed, b0);
  if (!bin_ok(bn, a.B)) return;
  const float2 v =
      reinterpret_cast<const float2*>(buf + a.chunk * a.sstride)[row];
  const int qg = __float2int_rn(v.x), qh = __float2int_rn(v.y);
  int* h = hist + 2 * f * a.B + bn;
  if (qg != 0) atomicAdd(h, qg);
  if (qh != 0) atomicAdd(h + a.B, qh);
}

// Add the `nrows` staged rows of `buf`.  A tile of nf <= blockDim features:
// thread t takes feature t % nf of rows t / nf, t / nf + rstep, ... (rstep =
// blockDim / nf rows at a time, feature fastest, so a warp's lanes hit
// different features' histograms); a wider tile: every thread walks every
// row over features t, t + blockDim, ...
template <bool kU8>
__device__ __forceinline__ void int_add_staged(const HistArgs& a,
                                               const uint8_t* buf, int nrows,
                                               int c0, int nf, int b0,
                                               int* hist) {
  const int t = threadIdx.x;
  if (nf <= (int)blockDim.x) {
    const int rstep = blockDim.x / nf;
    const int f = t % nf;
    for (int row = t / nf; row < nrows && t < rstep * nf; row += rstep)
      int_add<kU8>(a, buf, row, f, c0, b0, hist);
  } else {
    for (int row = 0; row < nrows; ++row)
      for (int f = t; f < nf; f += blockDim.x)
        int_add<kU8>(a, buf, row, f, c0, b0, hist);
  }
}

template <bool kU8>
__global__ void __launch_bounds__(kHistIntThreads)
    hist_int_kernel(HistArgs a, IntGrid q, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (a.dyn_fbegin != nullptr) a.f_begin = *a.dyn_fbegin;
  // this block's window, segment and feature tile
  int g = 0, nseg = q.nseg, ft = q.ft, tile = blockIdx.x, seg = blockIdx.y;
  long long arow = 0;  // the window's accumulator row
  if (q.map != nullptr) {
    g = q.map[blockIdx.x];
    if (g < 0) return;  // past the level's blocks (a bound-sized grid)
    const int* in = q.info + kIntInfo * g;
    nseg = in[0];
    ft = in[2];
    const int local = blockIdx.x - in[3];
    const int ntiles = (a.F + ft - 1) / ft;
    tile = local % ntiles;
    seg = local / ntiles;
    arow = in[1];
  }
  long long start = a.start, count = a.count;
  if (a.win != nullptr) {
    start = a.win[2 * g];
    count = a.win[2 * g + 1];
  }
  const int B = a.B;
  const int f0 = tile * ft;
  const int nf = min(ft, a.F - f0);
  const int hsz = nf * B;  // (feature, bin) pairs of one copy
  int* hist = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < q.ncopy * 2 * hsz; i += blockDim.x)
    hist[i] = 0;
  uint8_t* stage = smem + int_hist_offset(q.ft_max, B, q.ncopy);
  const int bufsz = hist_stage_bytes(a.sstride, a.chunk);
  const long long chunk = a.chunk;

  const long long seglen = (count + nseg - 1) / nseg;
  const long long r0 = start + (long long)seg * seglen;
  const long long r1 = min(r0 + seglen, start + count);
  const int nchunks = r1 > r0 ? (int)((r1 - r0 + chunk - 1) / chunk) : 0;
  const int c0 = a.f_begin + f0;
  const int b0 = (a.packed ? c0 >> 1 : c0 * a.bpc) & ~(a.unit - 1);
  const int b1 = a.packed ? ((c0 + nf - 1) >> 1) + 1 : (c0 + nf) * a.bpc;
  const int nunits = (b1 - b0 + a.unit - 1) / a.unit;
  int* mine = hist + (size_t)((threadIdx.x >> 5) % q.ncopy) * 2 * hsz;
  __syncthreads();  // zeroed before any add

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
    int_add_staged<kU8>(a, stage + (c & 1) * bufsz,
                               (int)min(chunk, r1 - rb), c0, nf, b0, mine);
    __syncthreads();  // the buffer is refilled two chunks on
  }
  __syncthreads();

  // the copies' sums: the f32 histogram itself (one segment), or int64
  // global atomics into the window's accumulator
  const size_t total = (size_t)a.F * 2 * B;
  for (int i = threadIdx.x; i < hsz; i += blockDim.x) {
    const int f = i / B, b = i - f * B;
    long long sg = 0, sh = 0;
    for (int k = 0; k < q.ncopy; ++k) {
      sg += hist[(size_t)k * 2 * hsz + 2 * f * B + b];
      sh += hist[(size_t)k * 2 * hsz + (2 * f + 1) * B + b];
    }
    const size_t o = (size_t)(f0 + f) * 2 * B + b;
    if (nseg == 1) {
      float* dst = out + (size_t)g * total + o;
      dst[0] = __ll2float_rn(sg);
      dst[B] = __ll2float_rn(sh);
    } else {
      unsigned long long* dst = q.acc + (size_t)arow * total + o;
      if (sg != 0) atomicAdd(dst, (unsigned long long)sg);
      if (sh != 0) atomicAdd(dst + B, (unsigned long long)sh);
    }
  }
}

// Pass 2, for window g = blockIdx.y: its accumulator rounded to f32 once,
// or zeros for a window of no segments (a window of one segment was written
// by its blocks).
__global__ void hist_int_reduce_kernel(IntGrid q, int total,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t o = (size_t)blockIdx.y * total + i;
  int n = q.nseg;
  size_t arow = 0;
  if (q.info != nullptr) {
    n = q.info[kIntInfo * blockIdx.y];
    arow = q.info[kIntInfo * blockIdx.y + 1];
  }
  if (n == 1) return;
  out[o] = n > 1 ? __ll2float_rn((long long)q.acc[arow * total + i]) : 0.0f;
}

template <bool kU8>
static inline cudaError_t int_configure() {
  cudaError_t e = cudaFuncSetAttribute(
      hist_int_kernel<kU8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kHistSmemMax);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(hist_int_kernel<kU8>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launch on `stream`: the zeroing of q.acc's q.nacc rows, `nblocks` blocks
// over q.map (a level launch) or the (tiles, q.nseg) grid of one window,
// then pass 2 where `reduce` (one window: when it has several segments).
// `out` holds nwin * F * 2 * B floats.  q.ft_max, q.nseg, q.ft and the
// accumulator come from the host; the rest is set here.  `static`: each
// library keeps its own record of the devices whose kernel attributes it
// has set.
static inline cudaError_t launch_hist_int(HistArgs a, IntGrid q, int nblocks,
                                          bool reduce, float* out,
                                          cudaStream_t stream) {
  if (a.F < 1 || a.B < 1 || q.ft_max < 1) return cudaErrorInvalidValue;
  const bool u8 = a.bpc == 1 && !a.packed;
  a.sstride = hist_stage_stride(q.ft_max, a.bpc, a.packed);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.bins);
  a.unit = (base % 16 == 0 && a.bstride % 16 == 0)  ? 16
           : (base % 4 == 0 && a.bstride % 4 == 0) ? 4
                                                   : 1;
  a.chunk = kIntStageSmem / (2 * (a.sstride + 8)) / 32 * 32;
  if (a.chunk < 64) a.chunk = 64;
  if (a.chunk > kIntMaxChunk) a.chunk = kIntMaxChunk;
  const int one = q.ft_max * a.B * 8;
  q.ncopy = kIntHistSmem / one;
  if (q.ncopy > kIntMaxCopies) q.ncopy = kIntMaxCopies;
  if (q.ncopy < 1) q.ncopy = 1;
  const int smem = int_hist_offset(q.ft_max, a.B, q.ncopy) +
                   2 * hist_stage_bytes(a.sstride, a.chunk);
  if (smem > kHistSmemMax) return cudaErrorInvalidValue;
  // once per device and process
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1ull)) {
    if ((e = int_configure<true>()) != cudaSuccess ||
        (e = int_configure<false>()) != cudaSuccess)
      return e;
    configured |= 1ull << dev;
  }
  const size_t total = (size_t)a.F * 2 * a.B;
  if (q.nacc > 0) {
    e = cudaMemsetAsync(q.acc, 0, total * q.nacc * 8, stream);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(nblocks);
  if (q.map == nullptr) grid = dim3((a.F + q.ft - 1) / q.ft, q.nseg);
  if (grid.x > 0 && grid.y > 0) {
    if (u8)
      hist_int_kernel<true><<<grid, kHistIntThreads, smem, stream>>>(a, q,
                                                                     out);
    else
      hist_int_kernel<false><<<grid, kHistIntThreads, smem, stream>>>(a, q,
                                                                      out);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (!reduce) return cudaSuccess;
  hist_int_reduce_kernel<<<dim3((unsigned)((total + 255) / 256), a.nwin), 256,
                           0, stream>>>(q, (int)total, out);
  return cudaGetLastError();
}

// An IntGrid of one window in `nseg` segments of `ft`-feature tiles.
inline IntGrid int_grid_one(int nseg, int ft) {
  IntGrid q;
  q.map = nullptr;
  q.info = nullptr;
  q.nseg = nseg;
  q.ft = ft;
  q.ft_max = ft;
  q.ncopy = 1;
  q.acc = nullptr;
  q.nacc = nseg > 1 ? 1 : 0;
  return q;
}

}  // namespace lgbt
