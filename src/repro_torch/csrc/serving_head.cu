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
// The rule: one fixed order per logit. The thread that owns logit (m, v)
// carries one f32 accumulator, +0 at first, and folds k = 0, 1, ..., K -
// 1 into it in that order with one fmaf(h, W, acc) each. Nothing else
// touches the sum: no split of K, no tree, no choice that depends on M,
// on the row's place in the batch or on V. The kernels are templates on
// MT (the rows a CTA holds, M rounded up to a multiple of 8, at most
// 64), and the chain of each row is the same in every instantiation, so
// a row's logits are bitwise the same at any M. Rows past M are zeros
// that are never stored.
//
// Bound: bytes. For M <= 64 all rows share one pass over W, so W is read
// once per call: 1024 x 151936 x 4 B = 622 MB for qwen1.5-0.5b, 0.186 ms
// at 3.35 TB/s; at M = 8 the f32 arithmetic is 2.5 GFLOP, 0.037 ms at
// 67 TFLOP/s. M > 64 runs ceil(M / 64) row blocks on the grid's y axis,
// each reading W again (still one launch, and still the same bits).
//
// Two kernels, one chain. Both compute every logit as that one fmaf
// chain from +0, so they give the same bits, and a call picks one by its
// rows alone:
//
// * column (M <= 16): grid (ceil(V / 128), ceil(M / MT)), 128 threads,
//   one column of W per thread. In turns of kChunk k values the CTA
//   stages h[:, k0:k0 + kChunk] into shared memory as [k][row] (zero rows
//   past M), then each thread issues kLoads loads of its column
//   (consecutive threads read consecutive columns of a row of W: one
//   128-byte line per warp and k; the loads stream with evict-first)
//   before the FMAs that use them, and reads the rows' h values as
//   16-byte shared-memory broadcasts: per k, MT FMAs, MT / 4 broadcasts,
//   one load. The tied layout reads E[v, k] with the same mapping; a
//   warp's loads then touch 32 rows of E, whose lines the L1 keeps
//   across the turn.
// * tile (M >= 17: the verify window's rows, MT = 24 ... 64): grid
//   (ceil(V / 128), ceil(M / MT)), MT / 8 warps. The CTA stages W's
//   [kTileK x 128] slab of the turn into shared memory by cp.async, two
//   turns in flight: [K, V] rows by 16-byte copies (V a multiple of 4,
//   aligned) or 4-byte ones (any V; zero past V) as [k][v], and the tied
//   [V, K] transposed by 4-byte copies as [v][k] rows of kTileK + 1
//   words, so both read conflict-free. Each thread loads 8 k of one row
//   of h a turn ahead (one 16-byte load of bf16) and stores them as
//   [k][row], consecutive threads on consecutive rows. Warp y owns rows
//   8 y .. 8 y + 7 and lane x 4 columns (4 x .. 4 x + 3 of [K, V], x + 32
//   j of the tied layout): a register block of 8 x 4 logits, so per k a
//   thread reads 4 W values and two 16-byte h broadcasts for 32 FMAs
//   (the column kernel: 1 load, MT / 4 broadcasts, MT FMAs).
//
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W, PERF.md): the column
// kernel at M = 8 is bound by its loads (0.23 ms against the 0.187 ms
// bound; cuBLAS 0.27 ms); from M = 24 on by its broadcasts and FMAs,
// 0.58 ms at M = 40 (cuBLAS 0.46 ms) and 1.7 ms at M = 64. Two or four
// columns per thread, one broadcast feeding each, were no faster (M = 40:
// 0.62 and 1.02 ms; more registers, fewer warps), hence the tile. The
// tile's time went mostly to staging h until each thread loaded 8 k of a
// row at once (a 2-byte load per k and thread, 32 lines per warp load,
// cost it more than the FMAs). At M = 24, 40 and 64 it takes 0.30, 0.43
// and 0.66 ms against the column kernel's 0.42, 0.58 and 1.73; at M = 16
// it only ties it (0.28), so the column kernel keeps M <= 16
// (tools/head_parent_bits.py, both in turns; PERF.md).
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
constexpr int kTileMinMT = 24;  // the tile kernel's least MT: M >= 17
constexpr int kTileK = 32;      // tile: k values per turn
constexpr int kTileN = 128;     // tile: columns per CTA
constexpr int kTileStages = 2;  // tile: W turns in flight

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
serving_head_kernel_column(const T* __restrict__ h,
                           const float* __restrict__ w,
                           float* __restrict__ out, int m, int kdim,
                           int vdim) {
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

// cp.async of 4 or 16 bytes, zero-filled where !ok
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the tile kernel's W turn in words: [kTileK][kTileN] from [K, V], or
// [kTileN][kTileK + 1] from the tied [V, K]
template <bool kTied>
__host__ __device__ constexpr int tile_words() {
  return kTied ? kTileN * (kTileK + 1) : kTileK * kTileN;
}

template <int MT, bool kTied>
__host__ __device__ constexpr int tile_smem() {
  return 4 * (kTileStages * tile_words<kTied>() + 2 * kTileK * MT);
}

// kVec: [K, V] with V a multiple of 4 and W 16-byte aligned, staged by
// 16-byte copies (else 4-byte ones). Lane x owns columns 4 x .. 4 x + 3
// of the [K, V] layout (one 16-byte read of the turn's row per k) or x +
// 32 j of the tied one (rows 33 words apart: conflict-free).
template <int MT, bool kTied, bool kVec, typename T>
__global__ void __launch_bounds__(4 * MT)
serving_head_kernel_tile(const T* __restrict__ h,
                         const float* __restrict__ w,
                         float* __restrict__ out, int m, int kdim,
                         int vdim) {
  constexpr int kT = 4 * MT;            // MT / 8 warps
  constexpr int kW = tile_words<kTied>();
  constexpr int kH = kTileK * MT / kT;  // h values per thread a turn: 8
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                  // [stages][kW]
  float* hs = smem + kTileStages * kW;               // [2][kTileK][MT]
  const int tid = threadIdx.x, lane = tid & 31, wy = tid >> 5;
  const long long n0 = (long long)blockIdx.x * kTileN;
  const int row0 = blockIdx.y * MT;
  const int turns = (kdim + kTileK - 1) / kTileK;

  // W's turn t into stage slot t % kTileStages, zeros past K and V
  auto load_w = [&](int t) {
    const int k0 = t * kTileK;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(ws + (t % kTileStages) * kW));
    if constexpr (kTied) {      // E[v, k]: a warp reads 32 k of one row
      for (int i = tid; i < kTileK * kTileN; i += kT) {
        const int c = i / kTileK, kk = i % kTileK;
        const long long v = n0 + c;
        const bool ok = v < vdim && k0 + kk < kdim;
        cp_async4(dst + 4 * (c * (kTileK + 1) + kk),
                  ok ? w + v * kdim + k0 + kk : w, ok);
      }
    } else if constexpr (kVec) {  // W[k, v]: 16 bytes, 4 v of one row
      for (int i = tid; i < kTileK * kTileN / 4; i += kT) {
        const int kk = i / (kTileN / 4), c = 4 * (i % (kTileN / 4));
        const long long v = n0 + c;
        const bool ok = v < vdim && k0 + kk < kdim;
        cp_async16(dst + 4 * (kk * kTileN + c),
                   ok ? w + (long long)(k0 + kk) * vdim + v : w, ok);
      }
    } else {                      // W[k, v]: a warp reads 32 v of one row
      for (int i = tid; i < kTileK * kTileN; i += kT) {
        const int kk = i / kTileN, c = i % kTileN;
        const long long v = n0 + c;
        const bool ok = v < vdim && k0 + kk < kdim;
        cp_async4(dst + 4 * i, ok ? w + (long long)(k0 + kk) * vdim + v : w,
                  ok);
      }
    }
  };
  // h's turn t: this thread loads k 8 q .. 8 q + 7 of row r (r = tid %
  // MT, q = tid / MT; one 16-byte load of bf16, two of f32, where in
  // range and aligned) and stores them as [k][row], consecutive threads
  // on consecutive rows; zeros past M and K
  static_assert(kH == 8, "8 k of a row a thread");
  float hv[kH];
  const int hr_ = tid % MT, hq = tid / MT;
  const bool hvec = kdim % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(h) % 16 == 0;
  auto load_h = [&](int t) {
    const int k0 = t * kTileK + 8 * hq, gr = row0 + hr_;
    const T* src = h + (long long)gr * kdim + k0;
    if (gr < m && hvec && k0 + 8 <= kdim) {
      if constexpr (sizeof(T) == 2) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        const uint32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hv[2 * e] = __uint_as_float(p[e] << 16);
          hv[2 * e + 1] = __uint_as_float(p[e] & 0xFFFF0000u);
        }
      } else {
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float4 b = reinterpret_cast<const float4*>(src)[1];
        hv[0] = a.x, hv[1] = a.y, hv[2] = a.z, hv[3] = a.w;
        hv[4] = b.x, hv[5] = b.y, hv[6] = b.z, hv[7] = b.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kH; ++e)
        hv[e] = gr < m && k0 + e < kdim ? widen(src[e]) : 0.f;
    }
  };
  auto store_h = [&](int t) {
    float* dst = hs + (t & 1) * kTileK * MT + 8 * hq * MT + hr_;
#pragma unroll
    for (int e = 0; e < kH; ++e) dst[e * MT] = hv[e];
  };

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

#pragma unroll
  for (int t = 0; t < kTileStages - 1; ++t) {
    if (t < turns) load_w(t);
    cp_async_commit();
  }
  load_h(0);
  store_h(0);
  for (int t = 0; t < turns; ++t) {
    cp_async_wait<kTileStages - 2>();   // W's turn t has landed
    __syncthreads();     // and every thread is done with turn t - 1
    if (t + kTileStages - 1 < turns) load_w(t + kTileStages - 1);
    cp_async_commit();
    if (t + 1 < turns) load_h(t + 1);
    const float* wt = ws + (t % kTileStages) * kW;
    const float* ht = hs + (t & 1) * kTileK * MT + 8 * wy;
    const int kc = min(kTileK, kdim - t * kTileK);
#pragma unroll 2
    for (int kk = 0; kk < kc; ++kk) {
      const float4 ha = *reinterpret_cast<const float4*>(ht + kk * MT);
      const float4 hb = *reinterpret_cast<const float4*>(ht + kk * MT + 4);
      const float hr[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
      float wv[4];
      if constexpr (kTied) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = wt[(lane + 32 * j) * (kTileK + 1)
                                               + kk];
      } else {
        const float4 w4 =
            *reinterpret_cast<const float4*>(wt + kk * kTileN + 4 * lane);
        wv[0] = w4.x, wv[1] = w4.y, wv[2] = w4.z, wv[3] = w4.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][j] = fmaf(hr[r], wv[j], acc[r][j]);
    }
    if (t + 1 < turns) store_h(t + 1);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + 8 * wy + r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long v = n0 + (kTied ? lane + 32 * j : 4 * lane + j);
      if (v < vdim) out[(long long)row * vdim + v] = acc[r][j];
    }
  }
}

template <int MT, bool kTied, bool kVec, typename T>
int launch_tile(const void* h, const void* w, void* out, int m, int k, int v,
                cudaStream_t st) {
  constexpr int smem = tile_smem<MT, kTied>();
  static unsigned long long sized = 0;   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(sized >> dev & 1)) {
    e = cudaFuncSetAttribute(serving_head_kernel_tile<MT, kTied, kVec, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) sized |= 1ull << dev;
  }
  dim3 grid((v + kTileN - 1) / kTileN, (m + MT - 1) / MT);
  serving_head_kernel_tile<MT, kTied, kVec, T><<<grid, 4 * MT, smem, st>>>(
      static_cast<const T*>(h), static_cast<const float*>(w),
      static_cast<float*>(out), m, k, v);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool kTied, typename T>
int launch(const void* h, const void* w, void* out, int m, int k, int v,
           cudaStream_t st) {
  if constexpr (MT < kTileMinMT) {
    dim3 grid((v + kThreads - 1) / kThreads, (m + MT - 1) / MT);
    serving_head_kernel_column<MT, kTied, T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(h), static_cast<const float*>(w),
        static_cast<float*>(out), m, k, v);
    return static_cast<int>(cudaGetLastError());
  } else if constexpr (kTied) {
    return launch_tile<MT, true, false, T>(h, w, out, m, k, v, st);
  } else {
    if (v % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
      return launch_tile<MT, false, true, T>(h, w, out, m, k, v, st);
    return launch_tile<MT, false, false, T>(h, w, out, m, k, v, st);
  }
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
