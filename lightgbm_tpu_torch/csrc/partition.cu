// Fused split pass: route every row of one leaf's window, stably partition
// the window (left rows first, each side in its original order), and build
// the smaller child's histogram.
//
// Replaces lightgbm_tpu/core/partition.py `partition_hist_pallas`, both its
// small-window kernel `_make_small_partition_kernel` (pallas_call at
// partition.py:1090, windows of <= 992 rows) and its pipelined kernel
// `_make_partition_kernel` (pallas_call at partition.py:1130).  The TPU's size
// buckets existed to amortise its per-chunk fixed cost; here one
// implementation serves every window size.
//
// What bounds it on the card: device-memory bytes.  Every row of the window
// is read once and written once at least (2 * wc * W bytes); this version
// moves about 4.8 * wc * W: a routing read of the split column's sector, the
// full-row scatter into a scratch window (read + write), the copy back (read
// + write), and the child histogram's two sectors per child row.
//
// Design:
// - Hopper blocks run in no order, so the TPU's in-order streaming compaction
//   becomes count, scan, scatter over tiles of `tile` rows, a function of
//   the row width (core/partition.py `part_tile_rows`: about 128 KB of row
//   bytes a block, so 1,024 rows at W = 128 and 64 at W = 2048).  (1)
//   part_count_kernel routes the rows of each tile and writes its left
//   count.  (2) One block scans the counts: exclusive prefixes, the left
//   total `nl`, and the smaller child's window for the histogram.  (3)
//   part_scatter_kernel routes again, ranks rows inside the tile with warp
//   ballots and a shared-memory prefix, keeps each row's destination in
//   shared memory, and then copies the tile with every thread of the block,
//   eight 16-byte loads in flight per thread, to scratch[left_off + rank] or
//   scratch[nl + right_off + rank].  Tiles sized by bytes keep every SM busy
//   on a small leaf of wide rows (a 10,000-row leaf at W = 2048 is 157
//   blocks; with a fixed 2,048-row tile it was 5 blocks on 132 SMs, and
//   one 16-byte load in flight per lane left the copy latency-bound).
//   The scratch window is then copied back over the window with
//   cudaMemcpyAsync: the partition is in place in `rows` through a scratch
//   window, as the TPU kernel aliased `rows` (input_output_aliases).  Rows
//   outside the window are never written.
// - The smaller child is one contiguous window after the partition, so its
//   histogram is the shared row-store histogram kernel (hist_common.cuh) on
//   that window, whose start and count it reads from device memory: the host
//   never waits for `nl` inside the pass.  Fusing the histogram into the
//   scatter is later work.
// - Routing follows lightgbm_tpu/core/partition.py `_route_tile` exactly:
//   EFB unfold, NaN bin = nb - 1, zero bin = default_bin, categorical bitset
//   words in scal[12:].
// - The feature window (the scal row's optional trailing element
//   hist_feature_begin, partition.py:1030-1036): a feature-parallel rank
//   histograms only the columns [f_begin, f_begin + F) of the child while
//   the rows are routed and partitioned on the whole store.  The host holds
//   the scal row, so it passes f_begin as an argument to the histogram
//   launch (HistArgs.f_begin, whose column offset the row-store kernels
//   already take); the route, count, scan and scatter kernels are the same
//   with or without it, and f_begin = 0 is the launch without a window.
//   The device-window launch never reads the scal row on the host, so
//   there the child histogram's blocks read f_begin from the row on the
//   device (HistArgs.dyn_fbegin), as they read wb and wc.
// - Under hist_precision=quantized (`quantized` = 1) the child histogram is
//   the integer kernel of hist_int.cuh (exact integer sums, on a grid of its
//   own from the parent window's size) instead of the f64 one; it replaces
//   the quantized child histogram of `_partition_call(quantized=True)`
//   (partition.py:1080).
// - The device window (lgbt_partition_window, the leaf-wise build of
//   core/tree_learner.py): the TPU kernel takes its window through scalar
//   prefetch and the host never learns it.  Here too: every launch is sized
//   once for the largest window (the store's rows), so nothing the host
//   passes depends on wb or wc.  Tiles past wc return at once, the copy
//   back is a kernel that reads wb and wc from the scal row, and the exact
//   child histogram's blocks derive from wc the segments (and feature tile)
//   the host-window launch gives the same window, so the f64 sums are
//   added in the same order and the two launches agree bit for bit.  A dead
//   step (wc = 0) moves no row, writes a zero histogram and nl = 0.
// - The steps are device functions in part_common.cuh, which the level pass
//   (partition_level.cu) runs over every window of a tree level at once.
#include "hist_int.cuh"
#include "part_common.cuh"

namespace lgbt {

// A tile past the window's end (a device-window launch is sized for the
// largest window) counts no row and returns at once.
__global__ void part_count_kernel(const uint8_t* __restrict__ rows, int W,
                                  const int* __restrict__ scal, int bpc,
                                  int packed, int nw, int tile,
                                  int* __restrict__ blk) {
  const long long r0 = (long long)blockIdx.x * tile;
  if (r0 >= scal[1]) {
    if (threadIdx.x == 0) blk[blockIdx.x] = 0;
    return;
  }
  const int s = count_tile(rows, W, scal, bpc, packed, nw, r0, tile);
  if (threadIdx.x == 0) blk[blockIdx.x] = s;
}

// One block: blk[] counts -> exclusive prefixes in place, nl = the total,
// win = the smaller child's {start, count}.  `routes` (the device-window
// launch, else null): a live window adds one to routes[0] when it unfolds
// a group column, to routes[1] when it routes by a bitset and, when the
// scal row has a feature window (`fwin`), to routes[2]: the counts that
// device.route_launches reports.
__global__ void part_scan_kernel(const int* __restrict__ scal, int nblk,
                                 int* __restrict__ blk, int* __restrict__ nl,
                                 int* __restrict__ win,
                                 long long* __restrict__ routes, int fwin) {
  scan_window(scal, nblk, blk, nl, win);
  if (routes != nullptr && threadIdx.x == 0 && scal[1] > 0) {
    routes[0] += scal[10] == 1;
    routes[1] += scal[8] == 1;
    routes[2] += fwin != 0;
  }
}

__global__ void part_scatter_kernel(const uint8_t* __restrict__ rows,
                                    uint8_t* __restrict__ scratch, int W,
                                    const int* __restrict__ scal, int bpc,
                                    int packed, int nw, int tile,
                                    const int* __restrict__ blk,
                                    const int* __restrict__ nl_ptr) {
  const long long r0 = (long long)blockIdx.x * tile;
  if (r0 >= scal[1]) return;
  scatter_tile(rows, scratch, W, scal, bpc, packed, nw, r0, tile,
               blk[blockIdx.x], nl_ptr[0]);
}

// The device window's copy back: tile x of the scratch window over rows
// [wb + x * tile, ...) of the store, wb and wc read from the scal row (the
// host-window launch copies with cudaMemcpyAsync, whose size it knows).
__global__ void part_copyback_kernel(uint8_t* __restrict__ rows,
                                     const uint8_t* __restrict__ scratch,
                                     int W, const int* __restrict__ scal,
                                     int tile) {
  const long long wb = scal[0], wc = scal[1];
  const long long r0 = (long long)blockIdx.x * tile;
  if (r0 >= wc) return;
  const int n16 = (int)min((long long)tile, wc - r0) * (W / 16);
  const uint4* src = reinterpret_cast<const uint4*>(scratch + (size_t)r0 * W);
  uint4* dst = reinterpret_cast<uint4*>(rows + (size_t)(wb + r0) * W);
  for (int i0 = threadIdx.x; i0 < n16; i0 += kPartThreads * kCopyUnroll) {
    uint4 v[kCopyUnroll];
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const int i = i0 + k * kPartThreads;
      if (i < n16) v[k] = src[i];
    }
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const int i = i0 + k * kPartThreads;
      if (i < n16) dst[i] = v[k];
    }
  }
}

}  // namespace lgbt

// `nblk` tiles of `tile` rows; the histogram covers columns
// [f_begin, f_begin + F) (0 without a feature window); `partial` holds nseg * F * 2 * B doubles (or
// is null for one segment), or when `quantized`, whose kernel cuts the
// child's window in `nseg` segments of `ft`-feature tiles, F * 2 * B int64
// (or null for one segment).
extern "C" int lgbt_partition_hist(void* rows, void* scratch, int W,
                                   const void* scal, long long wb,
                                   long long wc, int bpc, int packed, int nw,
                                   int F, int B, int f_begin, int voff,
                                   int nblk,
                                   int tile, void* blk, void* win, void* nl,
                                   int nseg, int ft, int quantized,
                                   void* partial, void* hist,
                                   void* stream) {
  using namespace lgbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* r = static_cast<uint8_t*>(rows);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  const int* sc = static_cast<const int*>(scal);
  int* bk = static_cast<int*>(blk);
  int* wn = static_cast<int*>(win);
  int* nlp = static_cast<int*>(nl);
  part_count_kernel<<<nblk, kPartThreads, 0, st>>>(r, W, sc, bpc, packed, nw,
                                                   tile, bk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  part_scan_kernel<<<1, kScanThreads, 0, st>>>(sc, nblk, bk, nlp, wn, nullptr,
                                              0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  part_scatter_kernel<<<nblk, kPartThreads, 0, st>>>(r, s, W, sc, bpc, packed,
                                                     nw, tile, bk, nlp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(r + (size_t)wb * W, s, (size_t)wc * W,
                      cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  HistArgs a = hist_args_one(r, W, voff, bpc, packed, F, B, f_begin, 0, 0, wn,
                             nseg);
  if (quantized) {
    IntGrid q = int_grid_one(nseg, ft);
    q.acc = static_cast<unsigned long long*>(partial);
    return (int)launch_hist_int(a, q, 0, nseg > 1, static_cast<float*>(hist),
                                st);
  }
  a.partial = static_cast<double*>(partial);
  return (int)launch_hist(a, static_cast<float*>(hist), st);
}

// The split pass with its window in device memory: the scal row's wb and
// wc are never read on the host, so the host can queue the pass before the
// step that writes its scal row has run.  Every launch is sized for the
// largest window, `bound` rows: `nblk` tiles of `tile` rows (tiles past
// wc return at once), `scratch` bound * W bytes, and the child histogram's
// grid (launch_hist_window, whose blocks take the segments `_segments`
// gives the parent's wc, at most `seg_cap`; or, when `quantized`, the
// integer kernel's grid of the bound, `nseg` segments of `ft` features,
// since integer sums do not depend on the grid).  `partial`: the exact
// kernel's f64 partials of a bound-row window, or the integer kernel's
// int64 accumulator row.  wc = 0 leaves the store as it is, writes a zero
// histogram and nl = 0.  `fwin` = 1: the scal row carries the feature
// window's first column after its bitset words (scal[12 + nw], the
// trailing hist_feature_begin), which the child histogram's blocks read
// on the device, so the histogram covers columns [f_begin, f_begin + F)
// (not checked here, as the window is not); 0: columns [0, F).  `routes`:
// three int64 counters (part_scan_kernel).
extern "C" int lgbt_partition_window(void* rows, void* scratch, int W,
                                     const void* scal, long long bound,
                                     int bpc, int packed, int nw, int F,
                                     int B, int voff, int fwin, int nblk,
                                     int tile,
                                     void* blk, void* win, void* nl,
                                     int seg_cap, int nseg, int ft,
                                     int quantized, void* partial,
                                     void* hist, void* routes, void* stream) {
  using namespace lgbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* r = static_cast<uint8_t*>(rows);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  const int* sc = static_cast<const int*>(scal);
  int* bk = static_cast<int*>(blk);
  int* wn = static_cast<int*>(win);
  int* nlp = static_cast<int*>(nl);
  part_count_kernel<<<nblk, kPartThreads, 0, st>>>(r, W, sc, bpc, packed, nw,
                                                   tile, bk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  part_scan_kernel<<<1, kScanThreads, 0, st>>>(
      sc, nblk, bk, nlp, wn, static_cast<long long*>(routes), fwin);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  part_scatter_kernel<<<nblk, kPartThreads, 0, st>>>(r, s, W, sc, bpc, packed,
                                                     nw, tile, bk, nlp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  part_copyback_kernel<<<nblk, kPartThreads, 0, st>>>(r, s, W, sc, tile);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  HistArgs a = hist_args_one(r, W, voff, bpc, packed, F, B, 0, 0, 0, wn,
                             nseg);
  if (fwin) a.dyn_fbegin = sc + 12 + nw;
  if (quantized) {
    IntGrid q = int_grid_one(nseg, ft);
    q.acc = static_cast<unsigned long long*>(partial);
    return (int)launch_hist_int(a, q, 0, nseg > 1, static_cast<float*>(hist),
                                st);
  }
  a.partial = static_cast<double*>(partial);
  a.dyn_wc = sc + 1;
  a.seg_cap = seg_cap;
  return (int)launch_hist_window(a, bound, static_cast<float*>(hist), st);
}
