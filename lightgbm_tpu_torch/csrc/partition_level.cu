// Level-batched split pass: partition every window of one tree level and
// build each window's smaller-child histogram in one call.
//
// Replaces lightgbm_tpu/core/partition.py `partition_hist_level_pallas`
// (partition.py:1191): the multi-window grid (`scal` [G, S], grid (G,)) of
// `_partition_call` over the small-window and pipelined kernels
// (pallas_call at partition.py:1090 and :1130), exact and quantized.  The
// TPU's per-class launches (`level_plan`, tree_learner.py:1176-1202) were a
// TPU cost model; here one call serves a level whatever its window sizes.
//
// What bounds it on the card: device-memory bytes.  Every row of every
// window is read once and written once at least: 2 * sum(wc) * W bytes.
// Like the single-window pass (partition.cu) this version moves about 4.8
// times that: a routing read, the scatter into scratch rows, the copy back
// and the children's histograms.
//
// Design:
// - The host knows every window's (wb, wc) before the call, so it builds the
//   block map (block -> (window, tile), ceil(wc / tile) blocks per window,
//   `tile` rows from the row width as in partition.cu), each window's first
//   block, block count and scratch offset, and the histogram's segment map,
//   and sends them with the [G, S] scal rows in one host-to-device copy
//   (`meta`).  One count kernel and one scatter kernel then cover every tile
//   of every window, so a level of 127 windows of ~8k rows at W = 128 is
//   eight blocks each in one launch, not 127 launches.
// - The scan runs one block per window: each window's tile counts become
//   exclusive prefixes, `nl[g]` and the child's window `win[g]`.
// - The scatter writes each window into its own stretch of one scratch
//   buffer (sum(wc) rows); one copy-back kernel returns every window to its
//   place in `rows`, a tile a block with eight 16-byte loads in flight per
//   thread.  Rows outside the windows are never written.
// - The children's histograms are one launch of the histogram kernel (the
//   f64 one, or the integer one when quantized) with a window axis: grid
//   row y is (window, segment) from the segment map, and the kernel reads
//   the child's window from `win` on the device.  Each window keeps the
//   segment count of its single-window call (`_segments(wc, F, B)` of the
//   parent window, core/histogram.py), so its histogram equals that call's
//   bit for bit.
// - A window with wc = 0 gets no count, scatter, copy-back or histogram
//   block: the scan writes nl = 0 for it and the reduction zeros.
// - Windows must be disjoint and inside the store; the wrapper
//   (core/partition.py `partition_hist_level_cuda`) checks it.
#include "hist_int.cuh"
#include "part_common.cuh"

namespace lgbt {

constexpr int kWinMeta = 4;  // per window: first block, blocks, scratch row, 0

struct LevelMeta {
  const int* scal;      // [G, S] scal rows
  const int* wmeta;     // [G, kWinMeta]
  const int* seg_info;  // [G, 2] histogram segments, first partial row
  const int* blkmap;    // [NB, 2] (window, tile)
  const int* segmap;    // [NS, 2] (window, segment)
  int S;
};

__device__ __forceinline__ const int* window_scal(const LevelMeta& m, int g) {
  return m.scal + (size_t)g * m.S;
}

__global__ void lvl_count_kernel(const uint8_t* __restrict__ rows, int W,
                                 LevelMeta m, int bpc, int packed, int nw,
                                 int tile, int* __restrict__ blk) {
  const int g = m.blkmap[2 * blockIdx.x], t = m.blkmap[2 * blockIdx.x + 1];
  const int s = count_tile(rows, W, window_scal(m, g), bpc, packed, nw,
                           (long long)t * tile, tile);
  if (threadIdx.x == 0) blk[blockIdx.x] = s;
}

__global__ void lvl_scan_kernel(LevelMeta m, int* __restrict__ blk,
                                int* __restrict__ nl, int* __restrict__ win) {
  const int g = blockIdx.x;
  const int* wm = m.wmeta + g * kWinMeta;
  scan_window(window_scal(m, g), wm[1], blk + wm[0], nl + g, win + 2 * g);
}

__global__ void lvl_scatter_kernel(const uint8_t* __restrict__ rows,
                                   uint8_t* __restrict__ scratch, int W,
                                   LevelMeta m, int bpc, int packed, int nw,
                                   int tile, const int* __restrict__ blk,
                                   const int* __restrict__ nl) {
  const int g = m.blkmap[2 * blockIdx.x], t = m.blkmap[2 * blockIdx.x + 1];
  const int* wm = m.wmeta + g * kWinMeta;
  scatter_tile(rows, scratch + (size_t)wm[2] * W, W, window_scal(m, g), bpc,
               packed, nw, (long long)t * tile, tile, blk[blockIdx.x], nl[g]);
}

// Copy one tile of a window back from its scratch rows (the tile's rows are
// contiguous on both sides).
__global__ void lvl_copyback_kernel(uint8_t* __restrict__ rows,
                                    const uint8_t* __restrict__ scratch,
                                    int W, LevelMeta m, int tile) {
  const int g = m.blkmap[2 * blockIdx.x], t = m.blkmap[2 * blockIdx.x + 1];
  const int* sc = window_scal(m, g);
  const long long wb = sc[0], wc = sc[1];
  const long long r0 = (long long)t * tile;
  const int nr = (int)min((long long)tile, wc - r0);
  copy_block16(reinterpret_cast<uint4*>(rows + (size_t)(wb + r0) * W),
               reinterpret_cast<const uint4*>(
                   scratch + ((size_t)m.wmeta[g * kWinMeta + 2] + r0) * W),
               nr * (W / 16));
}

}  // namespace lgbt

// meta (int32): scal [G, S], window rows [G, 4], histogram segments [G, 2],
// block map [NB, 2], segment map [NS, 2].  work (int32): tile prefixes [NB],
// nl [G], child windows [G, 2].  `partial` holds NS * F * 2 * B doubles, or
// int32 when `quantized`; `hist` is [G, F, 2, B] f32.
extern "C" int lgbt_partition_level(void* rows, void* scratch, int W,
                                    const void* meta, int G, int S, int NB,
                                    int NS, int tile, int bpc, int packed,
                                    int nw, int F, int B, int voff,
                                    int quantized,
                                    void* work, void* partial, void* hist,
                                    void* stream) {
  using namespace lgbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* r = static_cast<uint8_t*>(rows);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  LevelMeta m;
  m.scal = static_cast<const int*>(meta);
  m.wmeta = m.scal + (size_t)G * S;
  m.seg_info = m.wmeta + (size_t)G * kWinMeta;
  m.blkmap = m.seg_info + (size_t)G * 2;
  m.segmap = m.blkmap + (size_t)NB * 2;
  m.S = S;
  int* blk = static_cast<int*>(work);
  int* nl = blk + NB;
  int* win = nl + G;
  cudaError_t e;
  if (NB > 0) {
    lvl_count_kernel<<<NB, kPartThreads, 0, st>>>(r, W, m, bpc, packed, nw,
                                                  tile, blk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  lvl_scan_kernel<<<G, kScanThreads, 0, st>>>(m, blk, nl, win);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (NB > 0) {
    lvl_scatter_kernel<<<NB, kPartThreads, 0, st>>>(r, s, W, m, bpc, packed,
                                                    nw, tile, blk, nl);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    lvl_copyback_kernel<<<NB, kPartThreads, 0, st>>>(r, s, W, m, tile);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  HistArgs a = hist_args_one(r, W, voff, bpc, packed, F, B, 0, 0, 0, win, 1);
  a.seg_map = m.segmap;
  a.seg_info = m.seg_info;
  a.grid_y = NS;
  a.nwin = G;
  if (quantized) {
    a.ipartial = static_cast<int*>(partial);
    return (int)launch_hist_int(a, static_cast<float*>(hist), st);
  }
  a.partial = static_cast<double*>(partial);
  return (int)launch_hist(a, static_cast<float*>(hist), st);
}
