// The split pass's steps for one window, as device functions shared by
// partition.cu (one window per call) and partition_level.cu (every window of
// a tree level in one call): routing, the left count of a tile of rows, the
// scan of a window's tile counts and the stable scatter of a tile into the
// window's destination rows (partition.cu's scratch window, or the level
// pass's second row store).  What the pass replaces, what bounds it and why
// it is built this way is described in partition.cu.
//
// A tile is `tile` rows, a function of the row width W (core/partition.py
// `part_tile_rows`: about 128 KB of row bytes a block, clamped to
// [32, kPartMaxTile]), so a block moves about the same bytes at any W and a
// leaf of 10,000 rows of 2 KB is 157 blocks, not 5.
#pragma once

#include "hist_common.cuh"

namespace lgbt {

constexpr int kPartMaxTile = 2048;  // rows per block at most
constexpr int kPartThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kCopyUnroll = 8;      // 16-byte loads in flight per thread

// scal: (window_begin, window_count, group_col, threshold_bin, default_left,
// missing_type, num_bin_f, default_bin, is_cat, hist_left_side, use_unfold,
// efb_offset, *cat_bitset_words) — the layout of partition.py:1030-1037.
// missing_type is the scal row's code: 1 = the NaN bin (nb - 1) is missing,
// 2 = the default bin is, as _route_tile reads it.
__device__ __forceinline__ int route_left(const uint8_t* __restrict__ row,
                                          const int* __restrict__ scal,
                                          int bpc, int packed, int nw) {
  const int thr = scal[3], dleft = scal[4], mt = scal[5], nb = scal[6];
  const int dbin = scal[7], is_cat = scal[8], unf = scal[10], eoff = scal[11];
  int col = decode_bin(row, scal[2], bpc, packed);
  if (unf == 1) col = (col >= eoff && col <= eoff + nb - 2) ? col - eoff + 1 : 0;
  const bool miss = mt == 1 ? (col == nb - 1) : (mt == 2 ? (col == dbin) : false);
  const bool num_left = miss ? (dleft == 1) : (col <= thr);
  int wi = col >> 5;
  wi = wi < 0 ? 0 : (wi > nw - 1 ? nw - 1 : wi);
  const unsigned word = static_cast<unsigned>(scal[12 + wi]);
  const bool cat_left = ((word >> (col & 31)) & 1u) != 0;
  return (is_cat == 1 ? cat_left : num_left) ? 1 : 0;
}

// Left rows among window rows [r0, r0 + tile) of the window `scal` names;
// the total is valid in thread 0.  kPartThreads threads.
__device__ __forceinline__ int count_tile(const uint8_t* __restrict__ rows,
                                          int W, const int* __restrict__ scal,
                                          int bpc, int packed, int nw,
                                          long long r0, int tile) {
  __shared__ int warp_sum[kPartThreads / 32];
  const long long wb = scal[0], wc = scal[1];
  int cnt = 0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long r = r0 + i;
    if (r < wc) cnt += route_left(rows + (size_t)(wb + r) * W, scal, bpc, packed, nw);
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kPartThreads / 32; ++w) s += warp_sum[w];
  return s;
}

// kScanThreads threads: a window's tile counts blk[0, nblk) -> exclusive
// prefixes in place, *nl = the total, win = the histogrammed child's
// {start, count} (scal[9] = 1: the left child).
__device__ __forceinline__ void scan_window(const int* __restrict__ scal,
                                            int nblk, int* __restrict__ blk,
                                            int* __restrict__ nl,
                                            int* __restrict__ win) {
  __shared__ int sums[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nblk + kScanThreads - 1) / kScanThreads;
  const int b0 = t * per;
  const int b1 = min(b0 + per, nblk);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += blk[b];
  sums[t] = s;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {  // inclusive Hillis-Steele scan
    const int v = t >= o ? sums[t - o] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = t > 0 ? sums[t - 1] : 0;
  for (int b = b0; b < b1; ++b) {
    const int c = blk[b];
    blk[b] = run;
    run += c;
  }
  if (t == kScanThreads - 1) {
    const int total = sums[kScanThreads - 1];
    const int wb = scal[0], wc = scal[1];
    nl[0] = total;
    if (scal[9] == 1) {
      win[0] = wb;
      win[1] = total;
    } else {
      win[0] = wb + total;
      win[1] = wc - total;
    }
  }
}

// Stable scatter of window rows [r0, r0 + tile): left rows to
// dst[loff + rank], right rows to dst[nl + (r0 - loff) + rank], where
// loff is the count of left rows before the tile.  kPartThreads threads:
// one thread per row routes and ranks (warp ballots and a shared-memory
// prefix) and keeps the row's destination in shared memory; then every
// thread of the block copies the tile's rows in 16-byte vectors, kCopyUnroll
// loads in flight each (the tile's rows are contiguous in `rows`, so the
// loads are one coalesced stream; each row lands as one contiguous run).
__device__ __forceinline__ void scatter_tile(const uint8_t* __restrict__ rows,
                                             uint8_t* __restrict__ dst,
                                             int W,
                                             const int* __restrict__ scal,
                                             int bpc, int packed, int nw,
                                             long long r0, int tile, int loff,
                                             int nl) {
  __shared__ int s_l[kPartThreads / 32], s_r[kPartThreads / 32];
  __shared__ int s_dest[kPartMaxTile];
  const long long wb = scal[0], wc = scal[1];
  // rows of the tile in the window: > 0 for a launched tile
  const int nr = (int)min((long long)tile, wc - r0);
  int roff = (int)r0 - loff;                  // right rows before this tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < nr; base += kPartThreads) {
    const int i = base + threadIdx.x;
    const bool valid = i < nr;
    const int gl = valid ? route_left(rows + (size_t)(wb + r0 + i) * W, scal,
                                      bpc, packed, nw) : 0;
    const bool gr = valid && !gl;
    const unsigned ml = __ballot_sync(kFull, gl);
    const unsigned mr = __ballot_sync(kFull, gr);
    if (lane == 0) {
      s_l[warp] = __popc(ml);
      s_r[warp] = __popc(mr);
    }
    __syncthreads();
    int lp = 0, rp = 0, tl = 0, tr = 0;
    for (int w = 0; w < kPartThreads / 32; ++w) {
      if (w < warp) {
        lp += s_l[w];
        rp += s_r[w];
      }
      tl += s_l[w];
      tr += s_r[w];
    }
    if (gl) s_dest[i] = loff + lp + __popc(ml & below);
    else if (gr) s_dest[i] = nl + roff + rp + __popc(mr & below);
    __syncthreads();                          // s_l/s_r are reused next round
    loff += tl;
    roff += tr;
  }
  const int cpr = W / 16;                     // 16-byte vectors per row
  const int n16 = nr * cpr;
  const uint4* src =
      reinterpret_cast<const uint4*>(rows + (size_t)(wb + r0) * W);
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
      if (i < n16) {
        const int row = i / cpr;
        uint4* to =
            reinterpret_cast<uint4*>(dst + (size_t)s_dest[row] * W);
        to[i - row * cpr] = v[k];
      }
    }
  }
}

}  // namespace lgbt
