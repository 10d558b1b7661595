// Compensated fused row reduction for Hopper (sm_90a).
//
// Replaces the TPU reduction engine: repro/kernels/engine.py,
// `_engine_kernel` launched by `fused_reduce_rows` (batched) and
// `fused_reduce_flat` (one row). One pass over B rows of N f32 values
// emits any subset of
//   dot    sum x*y   (compensated)      max     max x   (plain)
//   sum    sum x     (compensated)      maxabs  max |x| (plain)
//   sumsq  sum x*x   (compensated)
// or, with compensated == 0, plain f32 sums (the paper's naive baseline).
//
// Bound: bytes. Each input value is read once (4 B per element per
// operand) and a handful of flops ride on it, far below the card's
// ~295 flop/byte ridge, so the kernel targets HBM bandwidth:
//   pass 1, grid (S, B): split s of row b streams a contiguous segment
//     with 16-byte vector loads (scalar loads when the row is not 16-byte
//     aligned); every thread keeps its own Neumaier (sum, carry) stream
//     per compensated output -- the paper's U-stream unrolling at thread
//     granularity, so no dependency chain is longer than the thread's
//     share. The block folds its streams with TwoSum `combine` in shared
//     memory and writes one (sum, carry) partial per split.
//   pass 2, grid (B): one block per row folds the S partials with TwoSum
//     and writes sum + carry.
// S depends only on (B, N), so the result is deterministic.
//
// The compensated chains use __fadd_rn / __fmul_rn so the compiler can
// neither contract x*y into the following add (the carry would then
// measure the wrong rounding) nor reassociate. Non-finite semantics
// follow the reference: a compensated sum over +-inf is NaN (TwoSum
// inf - inf), max propagates NaN, the masked tail never contributes.
//
// ptxas (sm_90a, -O3, CUDA 12.8): reduce_pass1 and reduce_pass2, each
// compensated and naive, 32 registers and 8192 bytes of static shared
// memory each; no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum : int { F_DOT = 1, F_SUM = 2, F_SUMSQ = 4, F_MAX = 8, F_MAXABS = 16 };
constexpr int kOut = 5;   // output slots: dot, sum, sumsq, max, maxabs

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

// NaN-propagating max (jnp.maximum semantics)
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Acc {
  float s[3], c[3];
  float mx, mabs;
};

template <bool COMP>
__device__ __forceinline__ void add(Acc& a, int k, float v) {
  if (COMP) {
    neumaier(a.s[k], a.c[k], v);
  } else {
    a.s[k] = __fadd_rn(a.s[k], v);
  }
}

template <bool COMP>
__device__ __forceinline__ void step(Acc& a, int flags, float x, float y) {
  if (flags & F_DOT) add<COMP>(a, 0, __fmul_rn(x, y));
  if (flags & F_SUM) add<COMP>(a, 1, x);
  if (flags & F_SUMSQ) add<COMP>(a, 2, __fmul_rn(x, x));
  if (flags & F_MAX) a.mx = pmax(a.mx, x);
  if (flags & F_MAXABS) a.mabs = pmax(a.mabs, fabsf(x));
}

// Fold the block's per-thread accumulators into thread 0.
template <bool COMP>
__device__ void block_fold(Acc& a, int flags) {
  __shared__ float sh_s[3][kThreads];
  __shared__ float sh_c[3][kThreads];
  __shared__ float sh_m[2][kThreads];
  const int t = threadIdx.x;
  for (int k = 0; k < 3; ++k) {
    sh_s[k][t] = a.s[k];
    sh_c[k][t] = a.c[k];
  }
  sh_m[0][t] = a.mx;
  sh_m[1][t] = a.mabs;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      for (int k = 0; k < 3; ++k) {
        if (!(flags & (1 << k))) continue;
        float s = sh_s[k][t], c = sh_c[k][t];
        if (COMP) {
          combine(s, c, sh_s[k][t + stride], sh_c[k][t + stride]);
        } else {
          s = __fadd_rn(s, sh_s[k][t + stride]);
        }
        sh_s[k][t] = s;
        sh_c[k][t] = c;
      }
      sh_m[0][t] = pmax(sh_m[0][t], sh_m[0][t + stride]);
      sh_m[1][t] = pmax(sh_m[1][t], sh_m[1][t + stride]);
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int k = 0; k < 3; ++k) {
      a.s[k] = sh_s[k][0];
      a.c[k] = sh_c[k][0];
    }
    a.mx = sh_m[0][0];
    a.mabs = sh_m[1][0];
  }
}

__device__ __forceinline__ void init(Acc& a) {
  for (int k = 0; k < 3; ++k) a.s[k] = a.c[k] = 0.0f;
  a.mx = -INFINITY;
  a.mabs = 0.0f;
}

// part layout: [kOut][B][S][2] (sum, carry); max slots use [..][0]
template <bool COMP>
__global__ void __launch_bounds__(kThreads)
reduce_pass1(const float* __restrict__ x, const float* __restrict__ y,
             long long n, int nsplit, long long seg, int flags, int vec,
             float* __restrict__ part) {
  const int b = blockIdx.y;
  const int sp = blockIdx.x;
  const long long start = (long long)sp * seg;
  const long long end = start + seg < n ? start + seg : n;
  const float* xr = x + (long long)b * n;
  const float* yr = (flags & F_DOT) ? y + (long long)b * n : xr;
  Acc a;
  init(a);
  if (vec) {
    // n and seg are multiples of 4 here, so [start, end) is whole float4s
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    for (long long i = start / 4 + threadIdx.x; i < end / 4;
         i += kThreads) {
      float4 xv = __ldg(x4 + i);
      float4 yv = (flags & F_DOT) ? __ldg(y4 + i) : xv;
      step<COMP>(a, flags, xv.x, yv.x);
      step<COMP>(a, flags, xv.y, yv.y);
      step<COMP>(a, flags, xv.z, yv.z);
      step<COMP>(a, flags, xv.w, yv.w);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      float xv = __ldg(xr + i);
      float yv = (flags & F_DOT) ? __ldg(yr + i) : xv;
      step<COMP>(a, flags, xv, yv);
    }
  }
  block_fold<COMP>(a, flags);
  if (threadIdx.x == 0) {
    const int nb = gridDim.y;
    for (int k = 0; k < 3; ++k) {
      float* p = part + (((long long)k * nb + b) * nsplit + sp) * 2;
      p[0] = a.s[k];
      p[1] = a.c[k];
    }
    part[(((long long)3 * nb + b) * nsplit + sp) * 2] = a.mx;
    part[(((long long)4 * nb + b) * nsplit + sp) * 2] = a.mabs;
  }
}

// out layout: [kOut][B]
template <bool COMP>
__global__ void __launch_bounds__(kThreads)
reduce_pass2(const float* __restrict__ part, int nsplit, int flags,
             float* __restrict__ out) {
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  Acc a;
  init(a);
  for (int sp = threadIdx.x; sp < nsplit; sp += kThreads) {
    for (int k = 0; k < 3; ++k) {
      if (!(flags & (1 << k))) continue;
      const float* p = part + (((long long)k * nb + b) * nsplit + sp) * 2;
      if (COMP) {
        combine(a.s[k], a.c[k], p[0], p[1]);
      } else {
        a.s[k] = __fadd_rn(a.s[k], p[0]);
      }
    }
    a.mx = pmax(a.mx, part[(((long long)3 * nb + b) * nsplit + sp) * 2]);
    a.mabs = pmax(a.mabs, part[(((long long)4 * nb + b) * nsplit + sp) * 2]);
  }
  block_fold<COMP>(a, flags);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) {
      out[(long long)k * nb + b] = COMP ? __fadd_rn(a.s[k], a.c[k]) : a.s[k];
    }
    out[(long long)3 * nb + b] = a.mx;
    out[(long long)4 * nb + b] = a.mabs;
  }
}

}  // namespace

extern "C" {

// x, y: [B, N] f32 row-major (y may be null unless flags has F_DOT);
// part: scratch [5, B, nsplit, 2] f32; out: [5, B] f32 rows in the order
// dot, sum, sumsq, max, maxabs (rows not in `flags` are unspecified).
// Returns cudaGetLastError() after both launches.
int repro_fused_reduce_rows(const void* x, const void* y, int rows,
                            long long n, int nsplit, long long seg,
                            int flags, int compensated, void* part,
                            void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int vec = (n % 4 == 0) && (seg % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (!(flags & F_DOT) ||
                   reinterpret_cast<uintptr_t>(y) % 16 == 0);
  dim3 g1(nsplit, rows);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  if (compensated) {
    reduce_pass1<true><<<g1, kThreads, 0, st>>>(xf, yf, n, nsplit, seg,
                                                flags, vec, pf);
    reduce_pass2<true><<<rows, kThreads, 0, st>>>(pf, nsplit, flags, of);
  } else {
    reduce_pass1<false><<<g1, kThreads, 0, st>>>(xf, yf, n, nsplit, seg,
                                                 flags, vec, pf);
    reduce_pass2<false><<<rows, kThreads, 0, st>>>(pf, nsplit, flags, of);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
