// Level-batched split pass: partition every window of one tree level from
// one row store into another and build each window's smaller-child
// histogram in one call.
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
// This version moves about 2.6 times that: a routing read of the split
// column's sector, the full-row scatter (read + write) and the children's
// histograms.
//
// Design:
// - Two row stores, `src` and `dst` of one shape.  Every window of one
//   level holds leaves of one depth, so the learner reads level d from
//   store d % 2 and writes store 1 - d % 2 (core/tree_learner.py): each
//   window's rows are stably partitioned from src[wb, wb + wc) straight
//   into dst[wb, wb + wc), left rows first, and never copied back.  Rows
//   outside the windows are written in neither store.
// - The host knows every window's (wb, wc) before the call, so it builds the
//   block map (block -> (window, tile), ceil(wc / tile) blocks per window,
//   `tile` rows from the row width as in partition.cu), each window's first
//   block and block count, and the histogram's map, and sends them with the
//   [G, S] scal rows in one host-to-device copy (`meta`).  One count kernel
//   and one scatter kernel then cover every tile of every window, so a level
//   of 127 windows of ~8k rows at W = 128 is eight blocks each in one
//   launch, not 127 launches.
// - The scan runs one block per window: each window's tile counts become
//   exclusive prefixes, `nl[g]` and the child's window `win[g]`.
// - The scatter is part_common.cuh's `scatter_tile` with dst + wb * W as
//   the window's base.
// - The children's histograms are one launch of the histogram kernel over
//   `dst` with a window axis; the kernel reads each child's window from
//   `win` on the device.  Exact: grid row y is (window, segment) from the
//   segment map, and each window keeps the segment count of its
//   single-window call (`_segments(wc, F, B)` of the parent window,
//   core/histogram.py), so its histogram equals that call's bit for bit.
//   Quantized: the integer kernel's block map (core/histogram.py
//   `int_hist_grid`, the level's windows sharing 264 blocks by rows); its
//   sums are exact, so any grid gives the single-window call's bits.
// - A window with wc = 0 gets no count, scatter or histogram block: the
//   scan writes nl = 0 for it and pass 2 zeros its histogram.
// - Windows must be disjoint and inside the stores, and the stores distinct
//   and of one shape; the wrapper (core/partition.py
//   `partition_hist_level_cuda`) checks it.
#include "hist_int.cuh"
#include "part_common.cuh"

namespace lgbt {

constexpr int kWinMeta = 2;  // per window: first block, blocks

struct LevelMeta {
  const int* scal;    // [G, S] scal rows
  const int* wmeta;   // [G, kWinMeta]
  const int* blkmap;  // [NB, 2] (window, tile)
  int S;
};

__device__ __forceinline__ const int* window_scal(const LevelMeta& m, int g) {
  return m.scal + (size_t)g * m.S;
}

__global__ void lvl_count_kernel(const uint8_t* __restrict__ src, int W,
                                 LevelMeta m, int bpc, int packed, int nw,
                                 int tile, int* __restrict__ blk) {
  const int g = m.blkmap[2 * blockIdx.x], t = m.blkmap[2 * blockIdx.x + 1];
  const int s = count_tile(src, W, window_scal(m, g), bpc, packed, nw,
                           (long long)t * tile, tile);
  if (threadIdx.x == 0) blk[blockIdx.x] = s;
}

__global__ void lvl_scan_kernel(LevelMeta m, int* __restrict__ blk,
                                int* __restrict__ nl, int* __restrict__ win) {
  const int g = blockIdx.x;
  const int* wm = m.wmeta + g * kWinMeta;
  scan_window(window_scal(m, g), wm[1], blk + wm[0], nl + g, win + 2 * g);
}

__global__ void lvl_scatter_kernel(const uint8_t* __restrict__ src,
                                   uint8_t* __restrict__ dst, int W,
                                   LevelMeta m, int bpc, int packed, int nw,
                                   int tile, const int* __restrict__ blk,
                                   const int* __restrict__ nl) {
  const int g = m.blkmap[2 * blockIdx.x], t = m.blkmap[2 * blockIdx.x + 1];
  const int* sc = window_scal(m, g);
  scatter_tile(src, dst + (size_t)sc[0] * W, W, sc, bpc, packed, nw,
               (long long)t * tile, tile, blk[blockIdx.x], nl[g]);
}

}  // namespace lgbt

// meta (int32): scal [G, S], window rows [G, 2], block map [NB, 2] (the
// LevelMeta), then the histogram's map (core/partition.py).  Exact:
// segments and first partial row [G, 2], (window, segment) [NH, 2] of each
// of the NH grid rows, and `partial` holds NH * F * 2 * B doubles.
// Quantized: the integer kernel's window rows [G, kIntInfo] and the window
// [NH] of each of its NH blocks, tiles of at most `ft_max` features,
// `partial` `nacc` int64 accumulator rows [F, 2, B] (one for each window of
// several segments), and pass 2 when `reduce`.  work (int32): tile prefixes
// [NB], nl [G], child windows [G, 2].  `hist` is [G, F, 2, B] f32.
extern "C" int lgbt_partition_level(const void* src, void* dst, int W,
                                    const void* meta, int G, int S, int NB,
                                    int NH, int tile, int bpc, int packed,
                                    int nw, int F, int B, int voff,
                                    int quantized, int ft_max, int nacc,
                                    int reduce,
                                    void* work, void* partial, void* hist,
                                    void* stream) {
  using namespace lgbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  LevelMeta m;
  m.scal = static_cast<const int*>(meta);
  m.wmeta = m.scal + (size_t)G * S;
  m.blkmap = m.wmeta + (size_t)G * kWinMeta;
  m.S = S;
  const int* hmeta = m.blkmap + (size_t)NB * 2;
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
    lvl_scatter_kernel<<<NB, kPartThreads, 0, st>>>(r, d, W, m, bpc, packed,
                                                    nw, tile, blk, nl);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  HistArgs a = hist_args_one(d, W, voff, bpc, packed, F, B, 0, 0, 0, win, 1);
  a.nwin = G;
  if (quantized) {
    IntGrid q = int_grid_one(1, ft_max);
    q.info = hmeta;
    q.map = hmeta + (size_t)G * kIntInfo;
    q.acc = static_cast<unsigned long long*>(partial);
    q.nacc = nacc;
    return (int)launch_hist_int(a, q, NH, reduce != 0,
                                static_cast<float*>(hist), st);
  }
  a.seg_info = hmeta;
  a.seg_map = hmeta + (size_t)G * 2;
  a.grid_y = NH;
  a.partial = static_cast<double*>(partial);
  return (int)launch_hist(a, static_cast<float*>(hist), st);
}
