// The serving LM head for Hopper (sm_90a): logits = h @ W in f32, with
// each logit's bits independent of how many rows share the call.
//
// Not a port of a TPU kernel: the reference computes this product with
// XLA (repro/models/lm.py `_serving_logits`), and the port first ran it
// on cuBLAS. cuBLAS picks its kernel, and with it the order of each
// logit's K-sum, by M, so a row decoded at M = 8 (decode) and at M = 40
// (the speculative verify window) got different bits, and the verify
// window's logits could not equal the decode steps' (ROADMAP queue C).
//
// Computes out[m, v] = sum_k h[m, k] * W(k, v) for 1 <= m <= M, where W
// is the LM head [K, V] (`lm_head`) or the tied embedding [V, K]
// (`embed`, read in place: W(k, v) = E[v, k]). h is f32 or bf16 (widened
// exactly); W and out are f32.
//
// The rule: one fixed order per logit. The thread that owns column v
// carries one f32 accumulator per row and folds k = 0, 1, ..., K - 1 into
// it in that order with one fmaf each. Nothing else touches the sum: no
// split of K, no tree, no choice that depends on M, on the row's place
// in the batch or on V. The kernel is a template on MT (the rows a CTA
// holds, M rounded up to a multiple of 8, at most 64), and the chain of
// each row is the same instruction sequence in every instantiation, so
// a row's logits are bitwise the same at any M. Rows past M are zeros
// that are never stored.
//
// Bound: bytes. For M <= 64 all rows share one pass over W, so W is read
// once per call: 1024 x 151936 x 4 B = 622 MB for qwen1.5-0.5b, 0.186 ms
// at 3.35 TB/s; at M = 8 the f32 arithmetic is 2.5 GFLOP, 0.037 ms at
// 67 TFLOP/s. M > 64 runs ceil(M / 64) row blocks on the grid's y axis,
// each reading W again (still one launch, and still the same bits).
//
// Design: grid (ceil(V / 128), ceil(M / MT)), 128 threads, one column of
// W per thread. In turns of kChunk k values the CTA stages h[:, k0:k0 +
// kChunk] into shared memory as [k][row] (zero rows past M), then each
// thread issues kLoads loads of its column (consecutive threads read
// consecutive columns of a row of W: one 128-byte line per warp and k;
// the loads stream with evict-first) before the FMAs that use them, and
// reads the rows' h values as 16-byte shared-memory broadcasts: per k,
// MT FMAs, MT / 4 broadcasts, one load. The tied layout reads E[v, k]
// with the same mapping; a warp's loads then touch 32 rows of E, whose
// lines the L1 keeps across the turn.
//
// Where the time goes (NVIDIA H100 80GB HBM3, PERF.md): at M = 8 the
// loads (0.23 ms against the 0.187 ms bound; cuBLAS 0.27 ms); from M =
// 24 on the broadcasts and FMAs, 0.58 ms at M = 40 (cuBLAS 0.46 ms) and
// 1.7 ms at M = 64. Two or four columns per thread, one broadcast
// feeding each, were no faster (M = 40: 0.62 and 1.02 ms; more
// registers, fewer warps). A register-blocked tile of W through shared
// memory is the next step for the verify window's rows.
//
// No --use_fast_math: fmaf is one rounding, and the compiler may neither
// split it nor reorder the chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // columns of W per CTA, one per thread
constexpr int kChunk = 128;     // k values of h staged per turn
constexpr int kLoads = 8;       // loads of W issued before their FMAs
constexpr int kMaxRows = 64;    // rows a CTA holds at most

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <bool kTied>
__device__ __forceinline__ float load_w(const float* __restrict__ w,
                                        long long k, long long col,
                                        long long kdim, long long vdim) {
  return kTied ? __ldg(w + col * kdim + k) : __ldcs(w + k * vdim + col);
}

template <int MT>
__device__ __forceinline__ void fold(float (&acc)[MT], const float* hk,
                                     float wv) {
#pragma unroll
  for (int r = 0; r < MT; r += 4) {
    const float4 hv = *reinterpret_cast<const float4*>(hk + r);
    acc[r] = fmaf(hv.x, wv, acc[r]);
    acc[r + 1] = fmaf(hv.y, wv, acc[r + 1]);
    acc[r + 2] = fmaf(hv.z, wv, acc[r + 2]);
    acc[r + 3] = fmaf(hv.w, wv, acc[r + 3]);
  }
}

template <int MT, bool kTied, typename T>
__global__ void __launch_bounds__(kThreads)
serving_head_kernel(const T* __restrict__ h, const float* __restrict__ w,
                    float* __restrict__ out, int m, int kdim, int vdim) {
  __shared__ __align__(16) float hs[kChunk][MT];
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int row0 = blockIdx.y * MT;
  const bool live = col < vdim;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kChunk) {
    const int kc = min(kChunk, kdim - k0);
    __syncthreads();   // the previous turn's reads of hs are done
    for (int i = threadIdx.x; i < kChunk * MT; i += kThreads) {
      const int r = i / kChunk, kk = i % kChunk;   // h rows read along k
      const int gr = row0 + r;
      hs[kk][r] = (gr < m && kk < kc)
                      ? widen(h[(long long)gr * kdim + k0 + kk])
                      : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    int kk = 0;
    for (; kk + kLoads <= kc; kk += kLoads) {
      float wv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        wv[u] = load_w<kTied>(w, k0 + kk + u, col, kdim, vdim);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) fold<MT>(acc, hs[kk + u], wv[u]);
    }
    for (; kk < kc; ++kk)
      fold<MT>(acc, hs[kk], load_w<kTied>(w, k0 + kk, col, kdim, vdim));
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < MT; ++r)
    if (row0 + r < m) out[(long long)(row0 + r) * vdim + col] = acc[r];
}

template <int MT, bool kTied, typename T>
int launch(const void* h, const void* w, void* out, int m, int k, int v,
           cudaStream_t st) {
  dim3 grid((v + kThreads - 1) / kThreads, (m + MT - 1) / MT);
  serving_head_kernel<MT, kTied, T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(h), static_cast<const float*>(w),
      static_cast<float*>(out), m, k, v);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTied, typename T>
int dispatch(const void* h, const void* w, void* out, int m, int k, int v,
             cudaStream_t st) {
  switch (m > kMaxRows ? kMaxRows : (m + 7) / 8 * 8) {
    case 8: return launch<8, kTied, T>(h, w, out, m, k, v, st);
    case 16: return launch<16, kTied, T>(h, w, out, m, k, v, st);
    case 24: return launch<24, kTied, T>(h, w, out, m, k, v, st);
    case 32: return launch<32, kTied, T>(h, w, out, m, k, v, st);
    case 40: return launch<40, kTied, T>(h, w, out, m, k, v, st);
    case 48: return launch<48, kTied, T>(h, w, out, m, k, v, st);
    case 56: return launch<56, kTied, T>(h, w, out, m, k, v, st);
    default: return launch<64, kTied, T>(h, w, out, m, k, v, st);
  }
}

}  // namespace

extern "C" {

// h: [M, K] row-major, f32 (h_bf16 == 0) or bf16; w: [K, V] (tied == 0)
// or [V, K] (tied == 1) f32 row-major; out: [M, V] f32. Launches one
// kernel; returns cudaGetLastError().
int repro_serving_head(const void* h, int h_bf16, const void* w, int tied,
                       void* out, int m, int k, int v, void* stream) {
  if (m < 1 || k < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (tied)
    return h_bf16 ? dispatch<true, __nv_bfloat16>(h, w, out, m, k, v, st)
                  : dispatch<true, float>(h, w, out, m, k, v, st);
  return h_bf16 ? dispatch<false, __nv_bfloat16>(h, w, out, m, k, v, st)
                : dispatch<false, float>(h, w, out, m, k, v, st);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
