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
// - Under hist_precision=quantized (`quantized` = 1) the child histogram is
//   the integer kernel of hist_int.cuh (exact integer sums, on a grid of its
//   own from the parent window's size) instead of the f64 one; it replaces
//   the quantized child histogram of `_partition_call(quantized=True)`
//   (partition.py:1080).
// - The steps are device functions in part_common.cuh, which the level pass
//   (partition_level.cu) runs over every window of a tree level at once.
#include "hist_int.cuh"
#include "part_common.cuh"

namespace lgbt {

__global__ void part_count_kernel(const uint8_t* __restrict__ rows, int W,
                                  const int* __restrict__ scal, int bpc,
                                  int packed, int nw, int tile,
                                  int* __restrict__ blk) {
  const int s = count_tile(rows, W, scal, bpc, packed, nw,
                           (long long)blockIdx.x * tile, tile);
  if (threadIdx.x == 0) blk[blockIdx.x] = s;
}

// One block: blk[] counts -> exclusive prefixes in place, nl = the total,
// win = the smaller child's {start, count}.
__global__ void part_scan_kernel(const int* __restrict__ scal, int nblk,
                                 int* __restrict__ blk, int* __restrict__ nl,
                                 int* __restrict__ win) {
  scan_window(scal, nblk, blk, nl, win);
}

__global__ void part_scatter_kernel(const uint8_t* __restrict__ rows,
                                    uint8_t* __restrict__ scratch, int W,
                                    const int* __restrict__ scal, int bpc,
                                    int packed, int nw, int tile,
                                    const int* __restrict__ blk,
                                    const int* __restrict__ nl_ptr) {
  scatter_tile(rows, scratch, W, scal, bpc, packed, nw,
               (long long)blockIdx.x * tile, tile, blk[blockIdx.x], nl_ptr[0]);
}

}  // namespace lgbt

// `nblk` tiles of `tile` rows; `partial` holds nseg * F * 2 * B doubles (or
// is null for one segment), or when `quantized`, whose kernel cuts the
// child's window in `nseg` segments of `ft`-feature tiles, F * 2 * B int64
// (or null for one segment).
extern "C" int lgbt_partition_hist(void* rows, void* scratch, int W,
                                   const void* scal, long long wb,
                                   long long wc, int bpc, int packed, int nw,
                                   int F, int B, int voff, int nblk,
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
  part_scan_kernel<<<1, kScanThreads, 0, st>>>(sc, nblk, bk, nlp, wn);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  part_scatter_kernel<<<nblk, kPartThreads, 0, st>>>(r, s, W, sc, bpc, packed,
                                                     nw, tile, bk, nlp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(r + (size_t)wb * W, s, (size_t)wc * W,
                      cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  HistArgs a = hist_args_one(r, W, voff, bpc, packed, F, B, 0, 0, 0, wn, nseg);
  if (quantized) {
    IntGrid q = int_grid_one(nseg, ft);
    q.acc = static_cast<unsigned long long*>(partial);
    return (int)launch_hist_int(a, q, 0, nseg > 1, static_cast<float*>(hist),
                                st);
  }
  a.partial = static_cast<double*>(partial);
  return (int)launch_hist(a, static_cast<float*>(hist), st);
}
