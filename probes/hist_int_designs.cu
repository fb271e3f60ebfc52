// Scratch probe, not part of the library: two designs of the integer
// histogram kernel (lightgbm_tpu_torch/csrc/hist_int.cuh) that lost to it on
// an H100, kept so that their times can be taken again beside it.  Built and
// run by probes/hist_int_designs.py (nvcc -I lightgbm_tpu_torch/csrc).
//
// - pack: one packed 64-bit shared atomic per (row, feature),
//   q_g * 2^32 + q_h, instead of two int32 ones.  q_h >= 0, so the low word
//   is the hess sum with no borrow into the grad sum (up to 2^32 / 255 rows
//   a block).
// - partials: a window of several segments writes each segment's int32 sums
//   [F, 2, B] to a partial of its own, and pass 2 sums them in int64, instead
//   of int64 global atomics into a zeroed accumulator.
//
// Both keep the library kernel's grid (core/histogram.py `int_hist_grid`),
// staging and warp-private copies, over one window of a u8 row store; their
// bits equal the library kernel's.
#include "hist_int.cuh"

namespace probe {
using namespace lgbt;

template <bool kPack>
__device__ __forceinline__ void add_pair(const HistArgs& a,
                                         const uint8_t* buf, int row, int f,
                                         int c0, int b0, void* hist) {
  const int bn = buf[row * a.sstride + c0 + f - b0];
  if (!bin_ok(bn, a.B)) return;
  const float2 v =
      reinterpret_cast<const float2*>(buf + a.chunk * a.sstride)[row];
  const int qg = __float2int_rn(v.x), qh = __float2int_rn(v.y);
  if (kPack) {
    const unsigned long long w =
        ((unsigned long long)(long long)qg << 32) + (unsigned)qh;
    if (w != 0ull)
      atomicAdd(static_cast<unsigned long long*>(hist) + f * a.B + bn, w);
  } else {
    int* h = static_cast<int*>(hist) + 2 * f * a.B + bn;
    if (qg != 0) atomicAdd(h, qg);
    if (qh != 0) atomicAdd(h + a.B, qh);
  }
}

// Grid (tiles of q.ft features, q.nseg segments) over rows [0, a.count).
template <bool kPack>
__global__ void __launch_bounds__(kHistIntThreads)
    probe_kernel(HistArgs a, IntGrid q, int* partial, float* out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int B = a.B, seg = blockIdx.y, t = threadIdx.x;
  const int f0 = blockIdx.x * q.ft, nf = min(q.ft, a.F - f0);
  const int hsz = nf * B;  // one copy, in u64 (or int32 pairs)
  unsigned long long* hist = reinterpret_cast<unsigned long long*>(smem);
  for (int i = t; i < q.ncopy * hsz; i += blockDim.x) hist[i] = 0ull;
  uint8_t* stage = smem + int_hist_offset(q.ft_max, B, q.ncopy);
  const int bufsz = hist_stage_bytes(a.sstride, a.chunk);
  const long long chunk = a.chunk;
  const long long seglen = (a.count + q.nseg - 1) / q.nseg;
  const long long r0 = (long long)seg * seglen;
  const long long r1 = min(r0 + seglen, a.count);
  const int nchunks = r1 > r0 ? (int)((r1 - r0 + chunk - 1) / chunk) : 0;
  const int b0 = f0 & ~(a.unit - 1);
  const int nunits = (f0 + nf - b0 + a.unit - 1) / a.unit;
  void* mine = hist + (size_t)((t >> 5) % q.ncopy) * hsz;
  const int rstep = blockDim.x / nf, f = t % nf;
  __syncthreads();

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
    const int n = (int)min(chunk, r1 - rb);
    for (int row = t / nf; row < n && t < rstep * nf; row += rstep)
      add_pair<kPack>(a, stage + (c & 1) * bufsz, row, f, f0, b0, mine);
    __syncthreads();
  }
  __syncthreads();

  const size_t total = (size_t)a.F * 2 * B;
  for (int i = t; i < hsz; i += blockDim.x) {
    const int ff = i / B, b = i - ff * B;
    long long sg = 0, sh = 0;
    if (kPack) {
      unsigned long long s = 0ull;
      for (int k = 0; k < q.ncopy; ++k) s += hist[(size_t)k * hsz + i];
      sh = (long long)(s & 0xffffffffull);
      sg = (long long)(int)(unsigned)(s >> 32);
    } else {
      const int* h = reinterpret_cast<const int*>(hist);
      for (int k = 0; k < q.ncopy; ++k) {
        sg += h[(size_t)k * 2 * hsz + 2 * ff * B + b];
        sh += h[(size_t)k * 2 * hsz + (2 * ff + 1) * B + b];
      }
    }
    const size_t o = (size_t)(f0 + ff) * 2 * B + b;
    if (q.nseg == 1) {
      out[o] = __ll2float_rn(sg);
      out[o + B] = __ll2float_rn(sh);
    } else if (partial != nullptr) {
      partial[(size_t)seg * total + o] = (int)sg;
      partial[(size_t)seg * total + o + B] = (int)sh;
    } else {
      if (sg != 0) atomicAdd(q.acc + o, (unsigned long long)sg);
      if (sh != 0) atomicAdd(q.acc + o + B, (unsigned long long)sh);
    }
  }
}

// Pass 2: the int32 partials summed in int64, or the accumulator, rounded to
// f32 once.
__global__ void probe_reduce(const int* __restrict__ partial, IntGrid q,
                             int total, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long s = 0;
  if (partial != nullptr) {
    for (int k = 0; k < q.nseg; ++k) s += partial[(size_t)k * total + i];
  } else {
    s = (long long)q.acc[i];
  }
  out[i] = __ll2float_rn(s);
}

template <bool kPack>
static cudaError_t configure() {
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel<kPack>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kHistSmemMax);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(probe_kernel<kPack>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace probe

// Rows [0, count) of a u8 row store [R, W] (F <= kHistIntThreads bin columns
// from byte 0, f32 g/h at `voff`) in `nseg` segments of `ft`-feature tiles.
// `pack` selects the packed atomic; `partial` (nseg * F * 2 * B int32, or
// null) the partials, else `acc` (F * 2 * B int64) takes the segments' sums.
extern "C" int probe_hist_int(const void* rows, int W, int voff, int F, int B,
                              long long count, int nseg, int ft, int pack,
                              void* partial, void* acc, void* out,
                              void* stream) {
  using namespace lgbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F < 1 || F > kHistIntThreads || B < 1 || ft < 1 || nseg < 1)
    return (int)cudaErrorInvalidValue;
  HistArgs a = hist_args_one(static_cast<const uint8_t*>(rows), W, voff, 1,
                             0, F, B, 0, 0, count, nullptr, nseg);
  IntGrid q = int_grid_one(nseg, ft);
  q.acc = static_cast<unsigned long long*>(acc);
  int* part = static_cast<int*>(partial);
  float* o = static_cast<float*>(out);
  // the library launch's set-up (launch_hist_int)
  a.sstride = hist_stage_stride(ft, 1, 0);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.bins);
  a.unit = (base % 16 == 0 && W % 16 == 0) ? 16
           : (base % 4 == 0 && W % 4 == 0) ? 4
                                           : 1;
  a.chunk = kIntStageSmem / (2 * (a.sstride + 8)) / 32 * 32;
  if (a.chunk < 64) a.chunk = 64;
  if (a.chunk > kIntMaxChunk) a.chunk = kIntMaxChunk;
  q.ncopy = kIntHistSmem / (ft * B * 8);
  if (q.ncopy > kIntMaxCopies) q.ncopy = kIntMaxCopies;
  if (q.ncopy < 1) q.ncopy = 1;
  const int smem = int_hist_offset(ft, B, q.ncopy) +
                   2 * hist_stage_bytes(a.sstride, a.chunk);
  if (smem > kHistSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = probe::configure<true>()) != cudaSuccess ||
      (e = probe::configure<false>()) != cudaSuccess)
    return (int)e;
  const size_t total = (size_t)F * 2 * B;
  if (nseg > 1 && part == nullptr &&
      (e = cudaMemsetAsync(q.acc, 0, total * 8, st)) != cudaSuccess)
    return (int)e;
  const dim3 grid((F + ft - 1) / ft, nseg);
  if (pack)
    probe::probe_kernel<true><<<grid, kHistIntThreads, smem, st>>>(a, q, part,
                                                                   o);
  else
    probe::probe_kernel<false><<<grid, kHistIntThreads, smem, st>>>(a, q,
                                                                    part, o);
  if ((e = cudaGetLastError()) != cudaSuccess || nseg == 1) return (int)e;
  probe::probe_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, q, (int)total, o);
  return (int)cudaGetLastError();
}
