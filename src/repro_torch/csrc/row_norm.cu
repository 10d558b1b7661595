// The row norms of the served paths for Hopper (sm_90a): RMS norm and
// layer norm of each row of x [M, d], with each row's bits independent
// of how many rows share the call.
//
// Not a port of a TPU kernel: the reference computes these norms with
// XLA (repro/models/common.py `rms_norm`, `layer_norm`), and the port
// first ran them as eager PyTorch ops. torch's CUDA row mean lays out
// its sum by the number of rows, so a row normalised at M = 8 (a decode
// step of 8 slots) and at M = 40 (the speculative verify window) got
// different bits: layer 18's `ln_attn` of qwen1.5-0.5b was the first op
// of the decode step whose rows differed (tools/verify_m_ops.py, ROADMAP
// queue C item 2).
//
// Computes, in f32 from x widened exactly (bf16 or f32), as the
// reference does:
//   rms_norm:   y = x * rsqrt(mean(x^2) + eps) * w
//   layer_norm: mu = mean(x); var = mean((x - mu)^2);
//               y = (x - mu) * rsqrt(var + eps) * w + b
// then one rounding to x's dtype. w and b are f32. Not compensated: the
// reference's norm is a plain sum, and a compensated one would move its
// numerics.
//
// The rule: one fixed reduction order per row that depends on d alone.
// One CTA per row; the CTA's thread count and the vector width VEC are
// functions of d only (`threads_for`). Thread t owns the groups of VEC
// consecutive columns g = t, t + T, t + 2T, ... and folds them into one
// f32 partial in that order (column by column within a group); the
// partials meet in a fixed shuffle tree per warp (offsets 16, 8, 4, 2,
// 1 into lane 0) and a fixed tree over the warps' partials in warp 0.
// Every add and product is __fadd_rn / __fmul_rn (no FMA contraction)
// and the mean is an IEEE division by d, so no choice depends on M or on
// the row's place in the batch.
//
// Bound: bytes. x is read once (the row stays in registers: at most 32
// values a thread for d <= 8192), w (and b) once per CTA from L2, y
// written once: 2 x M x d x 2 B for a bf16 row. At [8, 1024] that is 33
// KB, far below a launch's latency; at [2048, 1024] 8.4 MB, 2.5 us at
// 3.35 TB/s.
//
// Design: grid M, T threads (T a multiple of 32 from 32 to 256, about
// four groups a thread), 8- or 16-byte vector loads when d % 4 == 0 (the
// wrapper hands in a 16-byte aligned base), scalar loads otherwise.
//
// No --use_fast_math: __frsqrt_rn is the rounded reciprocal square root,
// and the chains rely on the explicit roundings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVals = 32;     // x values a thread keeps in registers
constexpr int kMaxThreads = 256;
constexpr int kMaxWidth = kMaxVals * kMaxThreads;   // 8192

__host__ __device__ inline int vec_for(int d) { return d % 4 == 0 ? 4 : 1; }

// Threads of the CTA for a row of width d: about four groups a thread,
// a multiple of 32, from 32 to 256. A function of d alone.
__host__ __device__ inline int threads_for(int d) {
  const int groups = d / vec_for(d);
  int t = ((groups + 3) / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename T, int VEC>
struct Io;

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = p[0];
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Io<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint2 q;
    *reinterpret_cast<__nv_bfloat162*>(&q.x) =
        __halves2bfloat162(__float2bfloat16_rn(v[0]),
                           __float2bfloat16_rn(v[1]));
    *reinterpret_cast<__nv_bfloat162*>(&q.y) =
        __halves2bfloat162(__float2bfloat16_rn(v[2]),
                           __float2bfloat16_rn(v[3]));
    *reinterpret_cast<uint2*>(p) = q;
  }
};

// The CTA's total of one partial per thread, in a fixed tree; every
// thread gets the total. `red` holds kMaxThreads / 32 + 1 floats.
__device__ __forceinline__ float block_sum(float s, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) red[kMaxThreads / 32] = s;
  }
  __syncthreads();
  const float total = red[kMaxThreads / 32];
  __syncthreads();   // red is free again for the next sum
  return total;
}

template <typename T, int VEC, bool kLayer>
__global__ void __launch_bounds__(kMaxThreads)
row_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y, int d,
                float eps) {
  constexpr int kPer = kMaxVals / VEC;   // groups a thread may own
  __shared__ float red[kMaxThreads / 32 + 1];
  const int groups = d / VEC;
  const long long row = (long long)blockIdx.x * d;
  float v[kMaxVals];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    if (g < groups) {
      Io<T, VEC>::load(x + row + (long long)g * VEC, v + i * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        s = kLayer ? __fadd_rn(s, v[i * VEC + j])
                   : __fadd_rn(s, __fmul_rn(v[i * VEC + j], v[i * VEC + j]));
    }
  }
  const float fd = static_cast<float>(d);
  float mu = 0.f, var;
  if (kLayer) {
    mu = __fdiv_rn(block_sum(s, red), fd);
    s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = threadIdx.x + i * blockDim.x;
      if (g < groups) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float c = __fsub_rn(v[i * VEC + j], mu);
          s = __fadd_rn(s, __fmul_rn(c, c));
        }
      }
    }
  }
  var = __fdiv_rn(block_sum(s, red), fd);
  const float r = __frsqrt_rn(__fadd_rn(var, eps));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
    if (g < groups) {
      float o[VEC], wv[VEC], bv[VEC];
      Io<float, VEC>::load(w + g * VEC, wv);
      if (kLayer) Io<float, VEC>::load(b + g * VEC, bv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xv = kLayer ? __fsub_rn(v[i * VEC + j], mu)
                                : v[i * VEC + j];
        o[j] = __fmul_rn(__fmul_rn(xv, r), wv[j]);
        if (kLayer) o[j] = __fadd_rn(o[j], bv[j]);
      }
      Io<T, VEC>::store(y + row + (long long)g * VEC, o);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, const void* b, void* y, int m,
           int d, float eps, cudaStream_t st) {
  const int threads = threads_for(d);
  if (b != nullptr)
    row_norm_kernel<T, VEC, true><<<m, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<T*>(y), d, eps);
  else
    row_norm_kernel<T, VEC, false><<<m, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), nullptr,
        static_cast<T*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* y, int m,
             int d, float eps, cudaStream_t st) {
  return vec_for(d) == 4 ? launch<T, 4>(x, w, b, y, m, d, eps, st)
                         : launch<T, 1>(x, w, b, y, m, d, eps, st);
}

}  // namespace

extern "C" {

// x, y: [M, d] row-major, bf16 (x_bf16 == 1) or f32, 16-byte aligned;
// w (and b, or null for the RMS norm): [d] f32, 16-byte aligned.
// Launches one kernel; returns cudaGetLastError().
int repro_row_norm(const void* x, int x_bf16, const void* w, const void* b,
                   void* y, int m, int d, float eps, void* stream) {
  if (m < 1 || d < 1 || d > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch<__nv_bfloat16>(x, w, b, y, m, d, eps, st)
                : dispatch<float>(x, w, b, y, m, d, eps, st);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
