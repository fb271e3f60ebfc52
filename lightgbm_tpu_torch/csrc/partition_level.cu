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
// - The device-window form (lgbt_partition_level_window, level growth on
//   the device, core/tree_learner.py `_DeviceGrowth.level_step`): the TPU
//   kernel takes its windows through scalar prefetch and the host never
//   learns them; here too.  The G scal rows stay in device memory, and a
//   first one-block kernel (lvl_meta_kernel) reads each window's wc and
//   writes the maps the host builds above: first blocks and block counts,
//   the exact kernel's segments (hist_window_segments, `_segments` of the
//   window, so its f64 partials add in the host-map launch's order and the
//   two agree bit for bit) or the integer kernel's grid (int_hist_grids of
//   each window, ported as int_window_grid, or one fixed grid for the
//   bound).  Every launch is sized once for a bound of G windows of at most
//   n rows in all (core/partition.py `level_bounds`); blocks past the
//   level's maps (entry -1) return at once.  The integer accumulator is
//   kept zero between launches by the pass that reads it, so no memset of
//   the bound's rows runs.  What bounds it is what bounds the host-map form;
//   the map kernel is one block of a few microseconds.
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

// A block whose map entry is -1 lies past the level's tiles (the
// device-window launch sizes its grid for a bound) and returns at once.
__global__ void lvl_count_kernel(const uint8_t* __restrict__ src, int W,
                                 LevelMeta m, int bpc, int packed, int nw,
                                 int tile, int* __restrict__ blk) {
  const int g = m.blkmap[2 * blockIdx.x], t = m.blkmap[2 * blockIdx.x + 1];
  if (g < 0) return;
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
  if (g < 0) return;
  const int* sc = window_scal(m, g);
  scatter_tile(src, dst + (size_t)sc[0] * W, W, sc, bpc, packed, nw,
               (long long)t * tile, tile, blk[blockIdx.x], nl[g]);
}

// ---- the device-window form: the maps built on the card ----

constexpr int kMetaThreads = 1024;
// core/histogram.py's integer grid constants (int_hist_grids): the shared
// memory of one copy of a tile's sums is kIntHistSmem (hist_int.cuh)
constexpr long long kIntSegRows = 1024;
constexpr long long kIntSmallRows = 1 << 16;
constexpr long long kIntSmallSegRows = 4096;
constexpr long long kIntBlockRows = 2147483647LL / 255;

// core/histogram.py `int_hist_grids` of one window of `count` rows aiming
// at `blocks` blocks: its feature tile *ft and its row segments *nseg.
__device__ __forceinline__ void int_window_grid(long long count, int F, int B,
                                                long long blocks, int* ft,
                                                int* nseg) {
  long long ft_max = kIntHistSmem / (8LL * B);
  if (ft_max > F) ft_max = F;
  if (ft_max < 1) ft_max = 1;
  const long long wide = (F + ft_max - 1) / ft_max;
  const long long row_segs = (count + kIntSegRows - 1) / kIntSegRows;
  const bool small = count <= kIntSmallRows;
  long long need = 1;
  if (small) {
    need = (count + kIntSmallSegRows - 1) / kIntSmallSegRows;
    if (need < 1) need = 1;
  }
  const long long narrowest = row_segs <= 1 ? F : (F + 1) / 2;
  long long narrow = (blocks + need - 1) / need;
  if (narrow > narrowest) narrow = narrowest;
  if (narrow < wide) narrow = wide;
  const long long ntiles = small ? narrow : wide;
  long long ns = blocks / ntiles;
  if (ns > row_segs) ns = row_segs;
  if (ns < need) ns = need;
  const long long over = (count + kIntBlockRows - 1) / kIntBlockRows;
  if (ns < over) ns = over;
  *ft = (int)((F + ntiles - 1) / ntiles);
  *nseg = (int)ns;
}

// The largest g < G with a[g * stride] <= v, for a nondecreasing column
// whose entry 0 is 0 <= v (a window's first block or segment): the window
// that holds block v, past the empty windows that share its first block.
__device__ __forceinline__ int last_le(const int* a, int stride, int G,
                                       int v) {
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a[(size_t)mid * stride] <= v) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

struct LevelMaps {
  const int* scal;     // [G, S] scal rows, on the card
  int G, S;
  int tile;            // rows a count/scatter tile
  int NB, NH;          // blocks of the count/scatter launches, grid rows
                       // (exact) or blocks (quantized) of the histogram
  int quantized, F, B, seg_cap;
  int igrid;           // quantized: 0 = int_hist_grids of each window,
  int fill;            // aiming at its share of `fill` blocks by rows;
  int ft_b, nseg_b;    // 1 = the fixed grid (ft_b, nseg_b) every window
  int* wmeta;          // [G, kWinMeta] first block, blocks
  int* blkmap;         // [NB, 2] (window, tile), -1 past the level's tiles
  int* hinfo;          // exact [G, 2] (segments, first partial row);
                       // quantized [G, kIntInfo]
  int* hmap;           // exact [NH, 2] (window, segment); quantized [NH]
                       // window; -1 past the level's
  long long* routes;   // [4]: launches and windows that unfold a group
                       // column, launches and windows that route by a bitset
};

// One block: what level_meta (core/partition.py) builds on the host, from
// the windows' row counts in device memory.  Each chunk of kMetaThreads
// windows is scanned in shared memory (tiles, histogram segments or
// blocks, accumulator rows) and carried into the next; then every thread
// fills map entries, finding each entry's window by binary search over the
// prefixes it has just written.
__global__ void __launch_bounds__(kMetaThreads) lvl_meta_kernel(LevelMaps m) {
  __shared__ int s_sum[3][kMetaThreads];
  __shared__ int s_carry[3];
  __shared__ long long s_part[kMetaThreads / 32];
  __shared__ long long s_total;
  __shared__ int s_unfold, s_cat;
  const int t = threadIdx.x;
  // the level's rows, which the integer grid shares its blocks by
  long long tot = 0;
  for (int g = t; g < m.G; g += kMetaThreads) {
    const int wc = m.scal[(size_t)g * m.S + 1];
    tot += wc > 0 ? wc : 0;
  }
  for (int o = 16; o > 0; o >>= 1) tot += __shfl_down_sync(kFull, tot, o);
  if ((t & 31) == 0) s_part[t >> 5] = tot;
  if (t < 3) s_carry[t] = 0;
  if (t == 0) s_unfold = s_cat = 0;
  __syncthreads();
  if (t == 0) {
    long long sum = 0;
    for (int w = 0; w < kMetaThreads / 32; ++w) sum += s_part[w];
    s_total = sum > 0 ? sum : 1;
  }
  __syncthreads();
  const int hstride = m.quantized ? kIntInfo : 2;
  for (int base = 0; base < m.G; base += kMetaThreads) {
    const int g = base + t;
    int v[3] = {0, 0, 0};  // tiles, histogram segments or blocks, acc rows
    int ft = m.F, nseg = 0;
    if (g < m.G) {
      const int* sc = m.scal + (size_t)g * m.S;
      const long long wc = sc[1];
      if (wc > 0) {
        v[0] = (int)((wc + m.tile - 1) / m.tile);
        if (!m.quantized) {
          nseg = hist_window_segments(wc, m.seg_cap);
          v[1] = nseg;
        } else {
          if (m.igrid) {
            ft = m.ft_b;
            nseg = m.nseg_b;
          } else {
            const long long share = (m.fill * wc + s_total - 1) / s_total;
            int_window_grid(wc, m.F, m.B, share, &ft, &nseg);
          }
          v[1] = nseg * ((m.F + ft - 1) / ft);
          v[2] = nseg > 1;
        }
        if (sc[10] == 1) atomicAdd(&s_unfold, 1);
        if (sc[8] == 1) atomicAdd(&s_cat, 1);
      }
    }
    for (int k = 0; k < 3; ++k) s_sum[k][t] = v[k];
    __syncthreads();
    for (int o = 1; o < kMetaThreads; o <<= 1) {  // inclusive scan
      int a[3];
      for (int k = 0; k < 3; ++k) a[k] = t >= o ? s_sum[k][t - o] : 0;
      __syncthreads();
      for (int k = 0; k < 3; ++k) s_sum[k][t] += a[k];
      __syncthreads();
    }
    if (g < m.G) {
      const int off0 = s_carry[0] + s_sum[0][t] - v[0];
      const int off1 = s_carry[1] + s_sum[1][t] - v[1];
      m.wmeta[kWinMeta * g] = off0;
      m.wmeta[kWinMeta * g + 1] = v[0];
      int* hi = m.hinfo + (size_t)hstride * g;
      hi[0] = nseg;
      if (m.quantized) {
        hi[1] = s_carry[2] + s_sum[2][t] - v[2];
        hi[2] = ft;
        hi[3] = off1;
      } else {
        hi[1] = off1;
      }
    }
    __syncthreads();
    if (t == kMetaThreads - 1)
      for (int k = 0; k < 3; ++k) s_carry[k] += s_sum[k][t];
    __syncthreads();
  }
  // the maps (the prefixes above are visible to the whole block now)
  const int nb = s_carry[0], nh = s_carry[1];
  for (int b = t; b < m.NB; b += kMetaThreads) {
    int g = -1, tl = -1;
    if (b < nb) {
      g = last_le(m.wmeta, kWinMeta, m.G, b);
      tl = b - m.wmeta[kWinMeta * g];
    }
    m.blkmap[2 * b] = g;
    m.blkmap[2 * b + 1] = tl;
  }
  for (int y = t; y < m.NH; y += kMetaThreads) {
    int g = -1;
    if (y < nh) g = last_le(m.hinfo + (m.quantized ? 3 : 1), hstride, m.G, y);
    if (m.quantized) {
      m.hmap[y] = g;
    } else {
      m.hmap[2 * y] = g;
      m.hmap[2 * y + 1] = g < 0 ? -1 : y - m.hinfo[2 * g + 1];
    }
  }
  if (t == 0 && m.routes != nullptr) {
    m.routes[0] += s_unfold > 0;
    m.routes[1] += s_unfold;
    m.routes[2] += s_cat > 0;
    m.routes[3] += s_cat;
  }
}

// The integer histogram's pass 2 for the device-window launch: a window
// of several segments takes its int64 accumulator row rounded to f32 once
// and clears the row (so the accumulator is zero at every launch without
// a memset of the bound's rows); a window of no segments gets zeros; a
// window of one segment was written by its blocks.
__global__ void lvl_int_reduce_kernel(const int* __restrict__ info,
                                      unsigned long long* __restrict__ acc,
                                      int total, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int* in = info + (size_t)kIntInfo * blockIdx.y;
  const int n = in[0];
  if (n == 1) return;
  float v = 0.0f;
  if (n > 1) {
    unsigned long long* p = acc + (size_t)in[1] * total + i;
    v = __ll2float_rn((long long)*p);
    *p = 0ull;
  }
  out[(size_t)blockIdx.y * total + i] = v;
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

// The level pass with its windows in device memory: the host never reads
// the G scal rows [G, S] (`scal`, on the card), so it can queue the pass
// before the step that writes them has run, and a CUDA graph can capture
// it.  Every launch is sized once for a bound, whatever the windows:
// `NB` count and scatter blocks (ceil(n / tile) + G for windows of at most
// n rows in all), `NH` histogram grid rows (exact: min(G * seg_cap,
// ceil(n / 2048) + G)) or blocks (quantized, core/partition.py
// `level_bounds`).  lvl_meta_kernel first writes the maps that level_meta
// builds on the host into `maps` (int32: window rows [G, 2], block map
// [NB, 2], the histogram's window rows and map; entries past the level's
// blocks are -1, and those blocks return at once).  Exact: each window's
// segments are hist_window_segments(wc, seg_cap), _segments of its rows,
// so its f64 partials are added in the host-map launch's order and the
// two launches agree bit for bit; `partial` holds NH f64 rows [F, 2, B].
// Quantized: `igrid` 0 gives each window int_hist_grids' grid aiming at its
// share of `fill` blocks by rows (the host map's grid), 1 the fixed grid
// (ft_b, nseg_b) of an n-row window; `ft_max` is the widest tile either
// gives; `partial` holds G int64 accumulator rows [F, 2, B], zero at the
// call and left zero (pass 2 clears what it reads).  work (int32): tile
// prefixes [NB], nl [G], child windows [G, 2].  `routes`: four int64
// counters (lvl_meta_kernel).  A window of wc = 0 moves no row, has nl = 0
// and a zero histogram.
extern "C" int lgbt_partition_level_window(
    const void* src, void* dst, int W, const void* scal, int G, int S,
    int NB, int NH, int tile, int bpc, int packed, int nw, int F, int B,
    int voff, int seg_cap, int quantized, int igrid, int fill, int ft_b,
    int nseg_b, int ft_max, void* maps, void* work, void* partial,
    void* hist, void* routes, void* stream) {
  using namespace lgbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  int* mp = static_cast<int*>(maps);
  LevelMaps lm;
  lm.scal = static_cast<const int*>(scal);
  lm.G = G;
  lm.S = S;
  lm.tile = tile;
  lm.NB = NB;
  lm.NH = NH;
  lm.quantized = quantized;
  lm.F = F;
  lm.B = B;
  lm.seg_cap = seg_cap;
  lm.igrid = igrid;
  lm.fill = fill;
  lm.ft_b = ft_b;
  lm.nseg_b = nseg_b;
  lm.wmeta = mp;
  lm.blkmap = lm.wmeta + (size_t)G * kWinMeta;
  lm.hinfo = lm.blkmap + (size_t)NB * 2;
  lm.hmap = lm.hinfo + (size_t)G * (quantized ? kIntInfo : 2);
  lm.routes = static_cast<long long*>(routes);
  LevelMeta m;
  m.scal = lm.scal;
  m.wmeta = lm.wmeta;
  m.blkmap = lm.blkmap;
  m.S = S;
  int* blk = static_cast<int*>(work);
  int* nl = blk + NB;
  int* win = nl + G;
  cudaError_t e;
  lvl_meta_kernel<<<1, kMetaThreads, 0, st>>>(lm);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  lvl_count_kernel<<<NB, kPartThreads, 0, st>>>(r, W, m, bpc, packed, nw,
                                                tile, blk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  lvl_scan_kernel<<<G, kScanThreads, 0, st>>>(m, blk, nl, win);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  lvl_scatter_kernel<<<NB, kPartThreads, 0, st>>>(r, d, W, m, bpc, packed,
                                                  nw, tile, blk, nl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  HistArgs a = hist_args_one(d, W, voff, bpc, packed, F, B, 0, 0, 0, win, 1);
  a.nwin = G;
  float* out = static_cast<float*>(hist);
  if (quantized) {
    IntGrid q = int_grid_one(1, ft_max);
    q.info = lm.hinfo;
    q.map = lm.hmap;
    q.acc = static_cast<unsigned long long*>(partial);
    q.nacc = 0;  // kept zero by lvl_int_reduce_kernel
    if ((e = launch_hist_int(a, q, NH, false, out, st)) != cudaSuccess)
      return (int)e;
    const int total = F * 2 * B;
    lvl_int_reduce_kernel<<<dim3((total + 255) / 256, G), 256, 0, st>>>(
        lm.hinfo, q.acc, total, out);
    return (int)cudaGetLastError();
  }
  a.seg_info = lm.hinfo;
  a.seg_map = lm.hmap;
  a.grid_y = NH;
  a.partial = static_cast<double*>(partial);
  return (int)launch_hist(a, out, st);
}
