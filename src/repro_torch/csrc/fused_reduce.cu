// Compensated fused row reduction for Hopper (sm_90a), in one launch.
//
// Replaces the TPU reduction engine: repro/kernels/engine.py,
// `_engine_kernel` launched by `fused_reduce_rows` (batched) and
// `fused_reduce_flat` (one row). One pass over B rows of N f32 values
// emits any subset of
//   dot    sum x*y   (compensated)      max     max x   (plain)
//   sum    sum x     (compensated)      maxabs  max |x| (plain)
//   sumsq  sum x*x   (compensated)
// or, with compensated == 0, plain f32 sums (the paper's naive baseline)
// from the same kernel.
//
// Bound: bytes. Each input value is read once (4 B per element per
// operand) and a handful of flops ride on it, far below the card's
// ~295 flop/byte ridge, so the kernel targets HBM bandwidth. At the
// served shapes the data is a few MB, a microsecond or two at 3.35 TB/s,
// so fixed costs decide: one launch, every load of a turn issued before
// the first compensated step that needs it, and short folds.
//
// Design: grid (S, B), S = ceil(N / seg). The split length `seg` is set
// by N alone (kernels/engine.py `splits`: 4096 elements, doubled until a
// row has at most 256 splits; tools/reduce_split_sizes.py), so a row's
// CTAs and their arithmetic are the same whatever the batch: a row's bits
// do not depend on B.
// * Streaming: in each turn a thread issues kU 16-byte loads per operand
//   (consecutive threads on consecutive 16-byte chunks), then runs the
//   steps on them as kU independent Neumaier (sum, carry) streams per
//   compensated output, the paper's mod-U unrolling at thread granularity.
//   Element e of the split belongs to stream u of thread t in turn j
//   where e / 4 = j * kThreads * kU + u * kThreads + t; rows that are not
//   16-byte aligned take scalar loads with the same mapping, so the
//   alignment changes no bit. Elements past the split are zeros and never
//   reach a max. The kernel is a template on the compensated outputs a
//   call asks for, so it keeps registers for those streams only.
// * compensated == 0 runs the same loads and folds with one plain sum
//   per thread instead of kU Neumaier streams (see `step`).
// * Folds: a thread's streams pairwise, then each warp by five xor
//   shuffles of TwoSum `combine` in registers, then the eight warp states
//   in warp 0 by three more.
// * One launch: thread 0 writes the CTA's (sum, carry) partial and adds
//   one to the row's arrival counter with an acq_rel atomic. The CTA that
//   arrives last folds the row's S partials in warp 0 in a fixed order
//   (lane l takes splits l, l + 32, ... in turn, then five shuffles),
//   writes the row's outputs and sets the counter back to 0. The order
//   does not depend on which CTA arrives last, so a result is bitwise the
//   same from run to run. The wrapper allocates the counters once per
//   device and stream, zeroed; every call leaves them zero.
//
// Where the time goes at [8, 151936], one turn per thread: the loads
// (DRAM latency, and behind the times phase's flushed L2 each cold read
// also evicts a dirty line), then in series the CTA fold, the arrival
// atomic and the last CTA's fold (per-CTA clock stamps of a bring-up
// copy, not committed). PERF.md has the times.
//
// ptxas (sm_90a, -O3, CUDA 12.8): 40-80 registers over the 16 builds
// (compensated outputs x compensated or naive), no spills.
//
// The compensated chains use __fadd_rn / __fmul_rn so the compiler can
// neither contract x*y into the following add (the carry would then
// measure the wrong rounding) nor reassociate. Non-finite semantics
// follow the reference: a compensated sum over +-inf is NaN (TwoSum
// inf - inf), max propagates NaN, the masked tail never contributes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpLevels = 3;     // log2(kWarps): warp 0's second fold
static_assert(kWarps == 1 << kWarpLevels, "kWarpLevels is log2(kWarps)");
constexpr int kU = 4;     // 16-byte loads per operand per turn
constexpr int kTurn = 4 * kThreads * kU;   // elements per turn of a CTA
enum : int { F_DOT = 1, F_SUM = 2, F_SUMSQ = 4, F_MAX = 8, F_MAXABS = 16 };

struct Pair { float s, c; };

__device__ __forceinline__ Pair twosum(float a, float b) {
  float s = __fadd_rn(a, b);
  float ap = __fsub_rn(s, b);
  float bp = __fsub_rn(s, ap);
  float da = __fsub_rn(a, ap);
  float db = __fsub_rn(b, bp);
  return {s, __fadd_rn(da, db)};
}

// Kahan-Babuska-Neumaier step: (s, c) += x
__device__ __forceinline__ void neumaier(float& s, float& c, float x) {
  Pair t = twosum(s, x);
  s = t.s;
  c = __fadd_rn(c, t.c);
}

// merge (s2, c2) into (s1, c1): TwoSum of the sums, carries added
// as in repro.core.kahan.combine: c1 + c2 + e
__device__ __forceinline__ void combine(float& s1, float& c1, float s2,
                                        float c2) {
  Pair t = twosum(s1, s2);
  s1 = t.s;
  c1 = __fadd_rn(__fadd_rn(c1, c2), t.c);
}

// Count one arrival at a row's counter and return the count before it:
// a release of this thread's partial to the CTA that arrives last, and an
// acquire of every earlier CTA's partial (the CTA's barrier then orders
// them before its warp 0's reads).
__device__ __forceinline__ unsigned arrive(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// NaN-propagating max (jnp.maximum semantics)
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// One thread's (or one fold's) state: a (sum, carry) per compensated
// output (dot, sum, sumsq) and the two maxima.
struct Acc {
  float s[3], c[3];
  float mx, mabs;
};

__device__ __forceinline__ void init(Acc& a) {
#pragma unroll
  for (int k = 0; k < 3; ++k) a.s[k] = a.c[k] = 0.0f;
  a.mx = -INFINITY;
  a.mabs = 0.0f;
}

template <bool COMP, int CMASK>
__device__ __forceinline__ void merge(Acc& a, float s, float c, int k) {
  if (!(CMASK & (1 << k))) return;
  if (COMP) {
    combine(a.s[k], a.c[k], s, c);
  } else {
    a.s[k] = __fadd_rn(a.s[k], s);
  }
}

// Fold the states of 2^LEVELS neighbouring lanes by xor shuffles: lane 0
// ends with the fold of lanes 0 .. 2^LEVELS - 1 (every lane with its
// group's: TwoSum is symmetric in its operands). Only the compensated
// outputs of CMASK and the maxima of `flags` move.
template <bool COMP, int CMASK, int LEVELS>
__device__ __forceinline__ void warp_fold(Acc& a, int flags) {
#pragma unroll
  for (int off = 1 << (LEVELS - 1); off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (!(CMASK & (1 << k))) continue;
      const float s = __shfl_xor_sync(0xffffffffu, a.s[k], off);
      const float c = COMP ? __shfl_xor_sync(0xffffffffu, a.c[k], off) : 0;
      merge<COMP, CMASK>(a, s, c, k);
    }
    if (flags & F_MAX)
      a.mx = pmax(a.mx, __shfl_xor_sync(0xffffffffu, a.mx, off));
    if (flags & F_MAXABS)
      a.mabs = pmax(a.mabs, __shfl_xor_sync(0xffffffffu, a.mabs, off));
  }
}

// Fold the CTA's states into thread 0: each warp, then the kWarps warp
// states in warp 0.
template <bool COMP, int CMASK>
__device__ __forceinline__ void block_fold(Acc& a, int flags) {
  __shared__ Acc sh[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_fold<COMP, CMASK, 5>(a, flags);
  if (lane == 0) sh[warp] = a;
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) a = sh[lane];
    warp_fold<COMP, CMASK, kWarpLevels>(a, flags);
  }
}

// One turn's loads of a thread: kU 16-byte chunks per operand (scalar
// loads with the same element mapping where a row is not 16-byte aligned,
// zeros past the split).
template <bool DOT>
__device__ __forceinline__ void load_turn(const float* xr, const float* yr,
                                          long long base, long long end,
                                          int vec, float (&xv)[kU][4],
                                          float (&yv)[kU][4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long e = base + 4LL * (u * kThreads + t);
    if (vec && e + 4 <= end) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(xr + e));
      xv[u][0] = a.x, xv[u][1] = a.y, xv[u][2] = a.z, xv[u][3] = a.w;
      if (DOT) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(yr + e));
        yv[u][0] = b.x, yv[u][1] = b.y, yv[u][2] = b.z, yv[u][3] = b.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = e + q < end;
        xv[u][q] = ok ? __ldg(xr + e + q) : 0.0f;
        if (DOT) yv[u][q] = ok ? __ldg(yr + e + q) : 0.0f;
      }
    }
  }
}

// One element into stream u: the compensated outputs of CMASK (bit k:
// dot, sum, sumsq), then the maxima that `flags` asks for. The naive
// mode keeps one plain sum per thread (stream 0), as the reference's
// naive mode keeps one accumulator per lane: the paper's baseline loop.
template <bool COMP, int CMASK>
__device__ __forceinline__ void step(float (&s)[3][kU], float (&c)[3][kU],
                                     float& mx, float& mabs, int flags,
                                     int u, float x, float y) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!(CMASK & (1 << k))) continue;
    const float v = k == 0 ? __fmul_rn(x, y) : k == 1 ? x : __fmul_rn(x, x);
    if (COMP) {
      neumaier(s[k][u], c[k][u], v);
    } else {
      s[k][0] = __fadd_rn(s[k][0], v);
    }
  }
  if (flags & F_MAX) mx = pmax(mx, x);
  if (flags & F_MAXABS) mabs = pmax(mabs, fabsf(x));
}

// part layout: [B][S][8], per split the (sum, carry) of dot, sum and
// sumsq, then max and maxabs: 32 bytes, one sector; out: [5][B]; count:
// [B] arrival counters. CMASK is
// `flags`' compensated outputs (bits 0-2), so a call keeps registers for
// those streams only.
template <bool COMP, int CMASK>
__global__ void __launch_bounds__(kThreads)
fused_reduce_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    long long n, int nsplit, long long seg, int flags,
                    int vec, float* __restrict__ part,
                    unsigned* __restrict__ count, float* __restrict__ out) {
  constexpr bool kDot = CMASK & F_DOT;
  const int b = blockIdx.y;
  const int nb = gridDim.y;
  const int sp = blockIdx.x;
  const int t = threadIdx.x;
  const long long start = (long long)sp * seg;
  const long long end = start + seg < n ? start + seg : n;
  const float* xr = x + (long long)b * n;
  const float* yr = kDot ? y + (long long)b * n : xr;

  float s[3][kU], c[3][kU];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int u = 0; u < kU; ++u) s[k][u] = c[k][u] = 0.0f;
  float mx = -INFINITY, mabs = 0.0f;

  for (long long base = start; base < end; base += kTurn) {
    // every load of the turn first ...
    float xv[kU][4], yv[kU][4];
    load_turn<kDot>(xr, yr, base, end, vec, xv, yv);
    if (!kDot) {
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) yv[u][q] = xv[u][q];
    }
    // ... then the kU independent chains; only a turn that reaches the
    // split's end tests indices
    if (base + kTurn <= end) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          step<COMP, CMASK>(s, c, mx, mabs, flags, u, xv[u][q], yv[u][q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (base + 4LL * (u * kThreads + t) + q < end)
            step<COMP, CMASK>(s, c, mx, mabs, flags, u, xv[u][q], yv[u][q]);
    }
  }

  // the thread's streams pairwise (the naive mode has one), then the CTA
  Acc a;
  init(a);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!(CMASK & (1 << k))) continue;
#pragma unroll
    for (int h = kU / 2; h > 0 && COMP; h >>= 1)
#pragma unroll
      for (int u = 0; u < h; ++u)
        combine(s[k][u], c[k][u], s[k][u + h], c[k][u + h]);
    a.s[k] = s[k][0];
    a.c[k] = c[k][0];
  }
  a.mx = mx;
  a.mabs = mabs;
  block_fold<COMP, CMASK>(a, flags);

  __shared__ int last;
  float4* row_part = reinterpret_cast<float4*>(part) + 2LL * b * nsplit;
  if (t == 0) {
    row_part[2 * sp] = make_float4(a.s[0], a.c[0], a.s[1], a.c[1]);
    row_part[2 * sp + 1] = make_float4(a.s[2], a.c[2], a.mx, a.mabs);
    last = arrive(count + b) == (unsigned)(nsplit - 1);
  }
  __syncthreads();
  if (!last) return;

  // the last CTA of row b: warp 0 folds every partial of the row in a
  // fixed order, lane l taking splits l, l + 32, ... in turn
  if (t >= 32) return;
  init(a);
  for (int i = t; i < nsplit; i += 32) {
    const float4 p = __ldcg(row_part + 2 * i);
    const float4 q = __ldcg(row_part + 2 * i + 1);
    merge<COMP, CMASK>(a, p.x, p.y, 0);
    merge<COMP, CMASK>(a, p.z, p.w, 1);
    merge<COMP, CMASK>(a, q.x, q.y, 2);
    a.mx = pmax(a.mx, q.z);
    a.mabs = pmax(a.mabs, q.w);
  }
  warp_fold<COMP, CMASK, 5>(a, flags);
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[(long long)k * nb + b] = COMP ? __fadd_rn(a.s[k], a.c[k]) : a.s[k];
    out[(long long)3 * nb + b] = a.mx;
    out[(long long)4 * nb + b] = a.mabs;
    count[b] = 0u;               // ready for the next call on the stream
  }
}

template <bool COMP>
int launch(dim3 grid, cudaStream_t st, const float* x, const float* y,
           long long n, int nsplit, long long seg, int flags, int vec,
           float* part, unsigned* count, float* out) {
#define REPRO_REDUCE_CASE(M)                                              \
  case M:                                                                 \
    fused_reduce_kernel<COMP, M><<<grid, kThreads, 0, st>>>(              \
        x, y, n, nsplit, seg, flags, vec, part, count, out);              \
    break;
  switch (flags & 7) {
    REPRO_REDUCE_CASE(0)
    REPRO_REDUCE_CASE(1)
    REPRO_REDUCE_CASE(2)
    REPRO_REDUCE_CASE(3)
    REPRO_REDUCE_CASE(4)
    REPRO_REDUCE_CASE(5)
    REPRO_REDUCE_CASE(6)
    REPRO_REDUCE_CASE(7)
  }
#undef REPRO_REDUCE_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: [B, N] f32 row-major (y may be null unless flags has F_DOT);
// seg: split length, a multiple of 4; nsplit = ceil(N / seg); part:
// scratch of repro_fused_reduce_scratch(B, nsplit) floats; count: B
// unsigned zeros (left zero); out: [5, B] f32 rows in the order dot,
// sum, sumsq, max, maxabs (rows not in `flags` are unspecified).
// Launches one kernel; returns cudaGetLastError().
int repro_fused_reduce_rows(const void* x, const void* y, int rows,
                            long long n, int nsplit, long long seg,
                            int flags, int compensated, void* part,
                            void* count, void* out, void* stream) {
  if (seg < 4 || seg % 4 || (long long)(nsplit - 1) * seg >= n ||
      (long long)nsplit * seg < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // 16-byte loads where every row starts 16-byte aligned
  const int vec = (rows == 1 || n % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (!(flags & F_DOT) ||
                   reinterpret_cast<uintptr_t>(y) % 16 == 0);
  dim3 grid(nsplit, rows);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* pf = static_cast<float*>(part);
  unsigned* cf = static_cast<unsigned*>(count);
  float* of = static_cast<float*>(out);
  return compensated
             ? launch<true>(grid, st, xf, yf, n, nsplit, seg, flags, vec, pf,
                            cf, of)
             : launch<false>(grid, st, xf, yf, n, nsplit, seg, flags, vec,
                             pf, cf, of);
}

// Floats of scratch one call needs: a (sum, carry) per compensated
// output and a value per maximum, per split of every row.
long long repro_fused_reduce_scratch(int rows, int nsplit) {
  return 8LL * rows * nsplit;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
