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
//   becomes count, scan, scatter.  (1) part_count_kernel routes the rows of
//   each 2048-row block and writes the block's left count.  (2) One block
//   scans the counts: exclusive prefixes, the left total `nl`, and the
//   smaller child's window for the histogram.  (3) part_scatter_kernel
//   routes again, ranks rows inside the block with warp ballots and a
//   shared-memory prefix, and copies each row (W bytes in 16-byte vectors,
//   one warp per 32 rows, W/16 lanes per row so each row is one coalesced
//   burst) to scratch[left_off + rank] or scratch[nl + right_off + rank].
//   The scratch window is then copied back over the window: the partition is
//   in place in `rows` through a scratch window, as the TPU kernel aliased
//   `rows` (input_output_aliases).  Rows outside the window are never
//   written.
// - The smaller child is one contiguous window after the partition, so its
//   histogram is the shared row-store histogram kernel (hist_common.cuh) on
//   that window, whose start and count it reads from device memory: the host
//   never waits for `nl` inside the pass.  Fusing the histogram into the
//   scatter is later work.
// - Routing follows lightgbm_tpu/core/partition.py `_route_tile` exactly:
//   EFB unfold, NaN bin = nb - 1, zero bin = default_bin, categorical bitset
//   words in scal[12:].
#include "hist_common.cuh"

namespace lgbt {

constexpr int kPartTile = 2048;    // rows per block
constexpr int kPartThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

__global__ void part_count_kernel(const uint8_t* __restrict__ rows, int W,
                                  const int* __restrict__ scal, int bpc,
                                  int packed, int nw, int* __restrict__ blk) {
  __shared__ int warp_sum[kPartThreads / 32];
  const long long wb = scal[0], wc = scal[1];
  const long long r0 = (long long)blockIdx.x * kPartTile;
  int cnt = 0;
  for (int i = threadIdx.x; i < kPartTile; i += blockDim.x) {
    const long long r = r0 + i;
    if (r < wc) cnt += route_left(rows + (size_t)(wb + r) * W, scal, bpc, packed, nw);
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kPartThreads / 32; ++w) s += warp_sum[w];
    blk[blockIdx.x] = s;
  }
}

// One block of 1024 threads: blk[] counts -> exclusive prefixes in place,
// nl = the total, win = the smaller child's {start, count}.
__global__ void part_scan_kernel(const int* __restrict__ scal, int nblk,
                                 int* __restrict__ blk, int* __restrict__ nl,
                                 int* __restrict__ win) {
  __shared__ int sums[1024];
  const int t = threadIdx.x;
  const int per = (nblk + 1023) / 1024;
  const int b0 = t * per;
  const int b1 = min(b0 + per, nblk);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += blk[b];
  sums[t] = s;
  __syncthreads();
  for (int o = 1; o < 1024; o <<= 1) {  // inclusive Hillis-Steele scan
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
  if (t == 1023) {
    const int total = sums[1023];
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

__global__ void part_scatter_kernel(const uint8_t* __restrict__ rows,
                                    uint8_t* __restrict__ scratch, int W,
                                    const int* __restrict__ scal, int bpc,
                                    int packed, int nw,
                                    const int* __restrict__ blk,
                                    const int* __restrict__ nl_ptr) {
  __shared__ int s_l[kPartThreads / 32], s_r[kPartThreads / 32];
  const long long wb = scal[0], wc = scal[1];
  const int nl = nl_ptr[0];
  const long long r0 = (long long)blockIdx.x * kPartTile;
  int loff = blk[blockIdx.x];                 // left rows before this block
  int roff = (int)r0 - loff;                  // right rows before this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int cpr = W / 16;                     // 16-byte chunks per row
  for (int base = 0; base < kPartTile; base += kPartThreads) {
    if (r0 + base >= wc) break;               // uniform across the block
    const long long r = r0 + base + threadIdx.x;
    const bool valid = r < wc;
    const int gl = valid ? route_left(rows + (size_t)(wb + r) * W, scal, bpc,
                                      packed, nw) : 0;
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
    long long dest = -1;
    if (gl) dest = loff + lp + __popc(ml & below);
    else if (gr) dest = (long long)nl + roff + rp + __popc(mr & below);
    __syncthreads();                          // s_l/s_r are reused next round
    loff += tl;
    roff += tr;
    // warp-cooperative copy of this warp's 32 rows
    const long long wrow0 = r0 + base + warp * 32;
    for (int c = lane; c < 32 * cpr; c += 32) {
      const int j = c / cpr, part = c % cpr;
      const long long d = __shfl_sync(kFull, dest, j);
      if (d >= 0) {
        const uint4* src = reinterpret_cast<const uint4*>(
            rows + (size_t)(wb + wrow0 + j) * W) + part;
        uint4* dst = reinterpret_cast<uint4*>(scratch + (size_t)d * W) + part;
        *dst = *src;
      }
    }
  }
}

}  // namespace lgbt

extern "C" int lgbt_partition_hist(void* rows, void* scratch, int W,
                                   const void* scal, long long wb,
                                   long long wc, int bpc, int packed, int nw,
                                   int F, int B, int voff, int nblk,
                                   void* blk, void* win, void* nl, int nseg,
                                   void* partial, void* hist, void* stream) {
  using namespace lgbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* r = static_cast<uint8_t*>(rows);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  const int* sc = static_cast<const int*>(scal);
  int* bk = static_cast<int*>(blk);
  int* wn = static_cast<int*>(win);
  int* nlp = static_cast<int*>(nl);
  part_count_kernel<<<nblk, kPartThreads, 0, st>>>(r, W, sc, bpc, packed, nw, bk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  part_scan_kernel<<<1, 1024, 0, st>>>(sc, nblk, bk, nlp, wn);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  part_scatter_kernel<<<nblk, kPartThreads, 0, st>>>(r, s, W, sc, bpc, packed,
                                                     nw, bk, nlp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(r + (size_t)wb * W, s, (size_t)wc * W,
                      cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  HistArgs a;
  a.rows = r;
  a.W = W;
  a.voff = voff;
  a.bpc = bpc;
  a.packed = packed;
  a.F = F;
  a.B = B;
  a.f_begin = 0;
  a.start = 0;
  a.count = 0;
  a.win = wn;
  a.nseg = nseg;
  a.ft = 0;
  a.partial = static_cast<double*>(partial);
  return (int)launch_hist(a, static_cast<float*>(hist), st);
}
