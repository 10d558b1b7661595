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
// The order: one fixed reduction order per row that depends on d alone.
// A row is summed by T = threads_for(d) "virtual threads" and VEC-wide
// column groups (both functions of d only). Virtual thread t owns the
// groups g = t, t + T, t + 2T, ... and folds them into one f32 partial
// in that order (column by column within a group); the partials of each
// run of 32 virtual threads (a "virtual warp") meet in a fixed shuffle
// tree (offsets 16, 8, 4, 2, 1 into lane 0), and the virtual warps'
// totals meet in the same tree, placed in lanes 0 .. nwarps-1 with zeros
// beyond. Every add and product is __fadd_rn / __fmul_rn (no FMA
// contraction) and the mean is an IEEE division by d, so no choice
// depends on M or on the row's place in the batch. This is the order of
// the first form of this kernel (one CTA of T threads per row, the
// totals passed through shared memory), so its bits are that form's
// (tools/norm_parent_bits.py).
//
// Two routes walk that order; `plan` picks one from d alone. On both, a
// CTA holds several rows that share one copy of w (and b) in shared
// memory, fetched by cp.async before x is read, so that its latency
// overlaps x's:
//   narrow (T <= 64, d <= 1024 for 4-aligned rows; 4 rows a CTA): one
//     warp per row, each lane standing for the NW = T / 32 virtual
//     threads lane, lane + 32: the NW shuffle trees run side by side and
//     the totals' tree follows in registers, with no shared memory for
//     the sums; one barrier per CTA publishes w.
//   wide (d > 1024; 2 rows a CTA): T threads per row, as the first form,
//     with one barrier per sum: each warp's total goes to its own slot of
//     a buffer kept for that sum, the row's threads meet at a named
//     barrier (the last sum's barrier is the CTA's, and publishes w), and
//     every warp then runs the totals' tree itself.
// The route and the rows per CTA were chosen from the card's readings
// (tools/norm_parent_bits.py --sweep): at d = 1536 and 2048 one warp per
// row took twice the wide route's time at M = 8; two rows a CTA keep
// the wide route's shared w (and b) from limiting how many rows an SM
// holds. Reading w (and b) from L2 after the sums, with an L1 prefetch
// issued before them, took 1.1-2x the staged form's time.
//
// Bound: bytes. x is read once (the row stays in registers: at most 32
// values a lane or a thread), w (and b) once per CTA from L2, y written
// once: 2 x M x d x 2 B for a
// bf16 row. At [8, 1024] that is 33 KB, far below a launch's latency; at
// [2048, 1024] 8.4 MB, 2.5 us at 3.35 TB/s.
//
// No --use_fast_math: __frsqrt_rn is the rounded reciprocal square root,
// and the chains rely on the explicit roundings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVals = 32;     // x values a thread keeps (wide route)
constexpr int kMaxThreads = 256;
constexpr int kMaxWidth = kMaxVals * kMaxThreads;   // 8192
constexpr int kNarrowWarps = 2;  // virtual warps one lane carries at most
constexpr int kNarrowGroups = 4; // groups a virtual thread owns (narrow)
constexpr int kWideThreads = 512; // threads of a CTA on the wide route
constexpr int kWideRows = 15;    // named barriers 1-15 (0 is the CTA's)
constexpr unsigned kFull = 0xffffffffu;

enum Route { kAuto = 0, kNarrow = 1, kWide = 2 };

__host__ __device__ inline int vec_for(int d) { return d % 4 == 0 ? 4 : 1; }

// Virtual threads of a row of width d: about four groups a thread, a
// multiple of 32, from 32 to 256. A function of d alone.
__host__ __device__ inline int threads_for(int d) {
  const int groups = d / vec_for(d);
  int t = ((groups + 3) / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// Rows per CTA: 4 on the narrow route (a warp each), 2 on the wide one.
inline int rows_for(int route) { return route == kNarrow ? 4 : 2; }

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

// w (and b) [d] f32 into shared memory, copied by the CTA's threads with
// cp.async (16-byte pieces for 4-aligned rows); not waited for here.
template <int VEC>
__device__ __forceinline__ void fetch_params(const float* __restrict__ src,
                                             float* dst, int d) {
  const int pieces = d / VEC;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + i * VEC));
    if (VEC == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src + i * VEC));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(s), "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void params_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The fixed tree of one warp: lane 0 ends with the total of the 32
// lanes' values.
__device__ __forceinline__ float warp_tree(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  return s;
}

// ---------------------------------------------------------------- narrow --
// One warp per row; lane l carries virtual threads l + 32 k, k < NW.

// The row's total of the NW x 32 virtual threads' partials s[k]: the NW
// warp trees side by side, then the totals' tree over lanes 0 .. NW-1
// (zeros beyond). Every lane gets the total.
template <int NW>
__device__ __forceinline__ float warp_row_sum(const float (&s)[NW]) {
  const int lane = threadIdx.x & 31;
  float t[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) t[k] = s[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NW; ++k)
      t[k] = __fadd_rn(t[k], __shfl_down_sync(kFull, t[k], off));
  }
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const float wk = __shfl_sync(kFull, t[k], 0);
    if (lane == k) tot = wk;
  }
  return __shfl_sync(kFull, warp_tree(tot), 0);
}

// The explicit 1 of minBlocksPerMultiprocessor: with the bare bound, nvcc
// 12.8's ptxas gave the bf16 layer-norm form at NW = 2 an 8-byte stack
// frame (48 registers); with it, 63 registers and none.
template <typename T, int VEC, int NW, bool kLayer>
__global__ void __launch_bounds__(kMaxThreads, 1)
row_norm_warp_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y, int m,
                     int d, float eps) {
  constexpr int kG = kNarrowGroups;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* bs = ws + d;
  fetch_params<VEC>(w, ws, d);
  if (kLayer) fetch_params<VEC>(b, bs, d);
  const int lane = threadIdx.x & 31;
  const int row_i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool live = row_i < m;
  const int groups = d / VEC;
  const int tv = NW * 32;                       // virtual threads T
  const long long row = (long long)(live ? row_i : 0) * d;
  float v[NW][kG * VEC];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int g = k * 32 + lane + i * tv;
      if (live && g < groups)
        Io<T, VEC>::load(x + row + (long long)g * VEC, v[k] + i * VEC);
    }
  }
  float s[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    s[k] = 0.f;
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int g = k * 32 + lane + i * tv;
      if (g < groups) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xv = v[k][i * VEC + j];
          s[k] = kLayer ? __fadd_rn(s[k], xv)
                        : __fadd_rn(s[k], __fmul_rn(xv, xv));
        }
      }
    }
  }
  const float fd = static_cast<float>(d);
  float mu = 0.f;
  if (kLayer) {
    mu = __fdiv_rn(warp_row_sum<NW>(s), fd);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      s[k] = 0.f;
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int g = k * 32 + lane + i * tv;
        if (g < groups) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float c = __fsub_rn(v[k][i * VEC + j], mu);
            s[k] = __fadd_rn(s[k], __fmul_rn(c, c));
          }
        }
      }
    }
  }
  const float var = __fdiv_rn(warp_row_sum<NW>(s), fd);
  const float r = __frsqrt_rn(__fadd_rn(var, eps));
  params_landed();
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int g = k * 32 + lane + i * tv;
      if (g < groups) {
        float o[VEC], wv[VEC], bv[VEC];
        Io<float, VEC>::load(ws + g * VEC, wv);
        if (kLayer) Io<float, VEC>::load(bs + g * VEC, bv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xv = kLayer ? __fsub_rn(v[k][i * VEC + j], mu)
                                  : v[k][i * VEC + j];
          o[j] = __fmul_rn(__fmul_rn(xv, r), wv[j]);
          if (kLayer) o[j] = __fadd_rn(o[j], bv[j]);
        }
        Io<T, VEC>::store(y + row + (long long)g * VEC, o);
      }
    }
  }
}

// ------------------------------------------------------------------ wide --
// One group of T threads per row, `rows` rows a CTA sharing w (and b).

// The row's total of one partial per thread of its T: each warp's tree,
// its total into red[warp], a barrier of the row's threads (named
// barrier `bar`, or the whole CTA's for bar 0), then every warp runs the
// totals' tree (zeros past nwarps). `red` serves this one sum only, so
// nothing has to wait before it is written again.
__device__ __forceinline__ float row_sum(float s, float* red, int tid,
                                         int nthreads, int bar) {
  const int lane = tid & 31, warp = tid >> 5;
  s = warp_tree(s);
  if (lane == 0) red[warp] = s;
  if (bar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" :: "r"(bar), "r"(nthreads) : "memory");
  return __shfl_sync(kFull,
                     warp_tree(lane < (nthreads >> 5) ? red[lane] : 0.f), 0);
}

template <typename T, int VEC, bool kLayer>
__global__ void __launch_bounds__(kWideThreads)
row_norm_cta_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y, int m,
                    int d, float eps) {
  constexpr int kPer = kMaxVals / VEC;   // groups a thread may own
  __shared__ float red[kWideThreads / 32][2][kMaxThreads / 32];
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* bs = ws + d;
  fetch_params<VEC>(w, ws, d);
  if (kLayer) fetch_params<VEC>(b, bs, d);
  const int nt = threads_for(d);
  const int r_local = threadIdx.x / nt, tid = threadIdx.x - r_local * nt;
  const int rows = blockDim.x / nt;
  const int row_i = blockIdx.x * rows + r_local;
  const bool live = row_i < m;
  const int groups = d / VEC;
  const long long row = (long long)(live ? row_i : 0) * d;
  float v[kMaxVals];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = tid + i * nt;
    if (g < groups) {
      if (live) Io<T, VEC>::load(x + row + (long long)g * VEC, v + i * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        s = kLayer ? __fadd_rn(s, v[i * VEC + j])
                   : __fadd_rn(s, __fmul_rn(v[i * VEC + j], v[i * VEC + j]));
    }
  }
  const float fd = static_cast<float>(d);
  float mu = 0.f;
  if (kLayer) {
    mu = __fdiv_rn(row_sum(s, red[r_local][0], tid, nt,
                           rows == 1 ? 0 : 1 + r_local), fd);
    s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = tid + i * nt;
      if (g < groups) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float c = __fsub_rn(v[i * VEC + j], mu);
          s = __fadd_rn(s, __fmul_rn(c, c));
        }
      }
    }
  }
  // the last sum's barrier is the whole CTA's: it publishes w (and b)
  params_landed();
  const float var = __fdiv_rn(row_sum(s, red[r_local][1], tid, nt, 0), fd);
  const float r = __frsqrt_rn(__fadd_rn(var, eps));
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = tid + i * nt;
    if (g < groups) {
      float o[VEC], wv[VEC], bv[VEC];
      Io<float, VEC>::load(ws + g * VEC, wv);
      if (kLayer) Io<float, VEC>::load(bs + g * VEC, bv);
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

// ---------------------------------------------------------------- launch --

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int VEC, int NW, bool kLayer>
int launch_warp(const void* x, const void* w, const void* b, void* y, int m,
                int d, float eps, int rows, cudaStream_t st) {
  const size_t smem = sizeof(float) * d * (kLayer ? 2 : 1);
  const int grid = (m + rows - 1) / rows;
  row_norm_warp_kernel<T, VEC, NW, kLayer><<<grid, rows * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), m, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool kLayer>
int launch_narrow(const void* x, const void* w, const void* b, void* y,
                  int m, int d, float eps, int rows, cudaStream_t st) {
  switch (threads_for(d) / 32) {
    case 1: return launch_warp<T, VEC, 1, kLayer>(x, w, b, y, m, d, eps,
                                                  rows, st);
    case 2: return launch_warp<T, VEC, 2, kLayer>(x, w, b, y, m, d, eps,
                                                  rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int VEC, bool kLayer>
int launch_wide(const void* x, const void* w, const void* b, void* y, int m,
                int d, float eps, int rows, cudaStream_t st) {
  const size_t smem = sizeof(float) * d * (kLayer ? 2 : 1);
  const cudaError_t e = allow_smem(row_norm_cta_kernel<T, VEC, kLayer>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (m + rows - 1) / rows;
  row_norm_cta_kernel<T, VEC, kLayer>
      <<<grid, rows * threads_for(d), smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), m, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool kLayer>
int launch(const void* x, const void* w, const void* b, void* y, int m,
           int d, float eps, int route, int rows, cudaStream_t st) {
  return route == kNarrow
             ? launch_narrow<T, VEC, kLayer>(x, w, b, y, m, d, eps, rows, st)
             : launch_wide<T, VEC, kLayer>(x, w, b, y, m, d, eps, rows, st);
}

template <typename T, int VEC>
int dispatch_layer(const void* x, const void* w, const void* b, void* y,
                   int m, int d, float eps, int route, int rows,
                   cudaStream_t st) {
  return b != nullptr
             ? launch<T, VEC, true>(x, w, b, y, m, d, eps, route, rows, st)
             : launch<T, VEC, false>(x, w, b, y, m, d, eps, route, rows, st);
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* y, int m,
             int d, float eps, int route, int rows, cudaStream_t st) {
  return vec_for(d) == 4
             ? dispatch_layer<T, 4>(x, w, b, y, m, d, eps, route, rows, st)
             : dispatch_layer<T, 1>(x, w, b, y, m, d, eps, route, rows, st);
}

}  // namespace

extern "C" {

// The route and rows per CTA `repro_row_norm` takes for width d, and the
// virtual threads of its order: *route 1 narrow (a warp per row, *rows
// rows a CTA), 2 wide (a CTA per row). Returns 0, or cudaErrorInvalidValue
// for a width out of range.
int repro_row_norm_plan(int d, int* route, int* rows, int* threads) {
  if (d < 1 || d > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = threads_for(d) / 32 <= kNarrowWarps;
  *route = narrow ? kNarrow : kWide;
  *rows = rows_for(*route);
  *threads = threads_for(d);
  return 0;
}

// The most rows per CTA `repro_row_norm_ex` takes on `route` at width d:
// narrow, 8 warps if a lane can carry the row's virtual warps (else 0);
// wide, as many rows of threads_for(d) threads as a CTA holds, at most
// one named barrier each. 0 for a width out of range.
int repro_row_norm_max_rows(int d, int route) {
  if (d < 1 || d > kMaxWidth) return 0;
  const int threads = threads_for(d);
  if (route == kNarrow)
    return threads / 32 <= kNarrowWarps ? kMaxThreads / 32 : 0;
  if (route == kWide)
    return kWideThreads / threads < kWideRows ? kWideThreads / threads
                                              : kWideRows;
  return 0;
}

// `repro_row_norm` on a forced route (0: the plan's) with a forced number
// of rows per CTA (0: the plan's, else 1 to repro_row_norm_max_rows).
// Every route gives the same bits; this entry is for measuring them.
int repro_row_norm_ex(const void* x, int x_bf16, const void* w,
                      const void* b, void* y, int m, int d, float eps,
                      int route, int rows, void* stream) {
  int plan_route, plan_rows, threads;
  if (m < 1 || repro_row_norm_plan(d, &plan_route, &plan_rows, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kAuto) route = plan_route;
  if (rows == 0) rows = rows_for(route);
  if (rows < 1 || rows > repro_row_norm_max_rows(d, route))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return x_bf16
             ? dispatch<__nv_bfloat16>(x, w, b, y, m, d, eps, route, rows, st)
             : dispatch<float>(x, w, b, y, m, d, eps, route, rows, st);
}

// x, y: [M, d] row-major, bf16 (x_bf16 == 1) or f32, 16-byte aligned;
// w (and b, or null for the RMS norm): [d] f32, 16-byte aligned.
// Launches one kernel; returns cudaGetLastError().
int repro_row_norm(const void* x, int x_bf16, const void* w, const void* b,
                   void* y, int m, int d, float eps, void* stream) {
  return repro_row_norm_ex(x, x_bf16, w, b, y, m, d, eps, kAuto, 0, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
