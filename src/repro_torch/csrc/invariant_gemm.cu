// An M-invariant bf16 product for Hopper (sm_90a): y = x @ w with bf16
// operands and an f32 result, each output row's bits independent of how
// many rows share the call.
//
// Not a port of a TPU kernel: the reference computes these products with
// XLA (repro/models/common.py `dense`, the MoE expert einsums), and the
// port first ran them on cuBLAS (`torch.mm(..., out_dtype=float32)`).
// cuBLAS picks its kernel, and with it each element's K order and K split,
// by M, so a row computed in a decode step (M = 8), a verify window (M =
// 40) or a prefill chunk (M = 240) got different bits (ROADMAP queue C
// item 2): a copy-on-write prefix hit parted from its cold run, and
// deepseek-v2's verify window from its decode steps.
//
// Computes y[b, m, n] = sum_k x[b, m, k] * w[b, k, n] for b < B (1 for a
// plain product, the experts for the MoE's batched one), m < M, n < N.
//
// The rule: every element sums in an order set by (B, K, N) alone.
//   * Tiles: kBM x kBN = 64 x 64 outputs per CTA, K walked in chunks of
//     kBK = 32 in increasing order, each chunk as two m16n8k16 tensor-core
//     products (mma.sync) in k order into the same f32 accumulators. A
//     tensor-core product computes each element from its own row of A,
//     column of B and accumulator, so a row's chain is the same whichever
//     of the tile's rows it sits in, and whatever the other rows hold.
//   * Rows past M are zeros that are never stored; K and N edges are
//     zero-filled, which adds exact zeros set by K and N.
//   * The K split: S parts of `cps` chunks each, chosen by the host
//     wrapper from (B, K, N) only (kernels/invariant_gemm.py
//     `split_plan`). With S > 1 each part writes its f32 partial tile to
//     scratch [S, B, M, N], and a second kernel folds the parts in the
//     order s = 0, 1, ..., S - 1, one __fadd_rn each.
//
// Bound: at the served path's M (8 to 256 rows) bytes: the bf16 weight
// read once (qwen1.5-0.5b's 144 products of one decode step: ~607 MB,
// 0.18 ms at 3.35 TB/s). The split exists for that case: at M = 8 a
// [1024 x 1024] weight is 16 column tiles, so S = 8 parts spread its read
// over 128 CTAs. At prefill M (2048) operations bound it (989 TFLOP/s
// bf16), and the split's scratch adds 8 B per output per part.
//
// Design (a simple, correct first form): 128 threads, four warps, warp w
// owning rows 16w..16w+15 of the tile and all 64 columns (8 n8 tiles, 32
// f32 accumulators a thread); a three-stage cp.async ring of A [64 x 32]
// and B [32 x 64] bf16 tiles, padded rows (80 B and 144 B) so the
// ldmatrix row reads hit distinct banks; A by ldmatrix.x4, B by
// ldmatrix.x4.trans straight from w's row-major [K, N] layout. A warp
// whose 16 rows are all past M skips its products (at M = 8 only warp 0
// computes). Operands that are not 16-byte aligned (K or N not a multiple
// of 8) take scalar loads into the same ring. TMA rings, wgmma and warp
// specialisation are later work.
//
// No --use_fast_math: the fold's adds are explicit __fadd_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 8;   // bf16 per staged A row: 80 bytes
constexpr int kBStride = kBN + 8;   // bf16 per staged B row: 144 bytes

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  int n = full ? 16 : 0;          // 0 source bytes: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage chunk [k0, k0 + kBK) of the A rows [m0, m0 + kBM) and of the B
// columns [n0, n0 + kBN); everything outside [M, K] / [K, N] is zero.
template <bool kAligned>
__device__ __forceinline__ void load_stage(bf16* sa, bf16* sb,
                                           const bf16* x, const bf16* w,
                                           int m0, int n0, int k0, int m,
                                           int n, int k, int tid) {
  if (kAligned) {
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      bool ok = m0 + r < m && k0 + c < k;
      const bf16* src = ok ? x + (size_t)(m0 + r) * k + k0 + c : x;
      cp_async16(smem_u32(sa + r * kAStride + c), src, ok);
    }
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      bool ok = k0 + r < k && n0 + c < n;
      const bf16* src = ok ? w + (size_t)(k0 + r) * n + n0 + c : w;
      cp_async16(smem_u32(sb + r * kBStride + c), src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      int r = i / kBK, c = i % kBK;
      bool ok = m0 + r < m && k0 + c < k;
      sa[r * kAStride + c] = ok ? x[(size_t)(m0 + r) * k + k0 + c] : zero;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      int r = i / kBN, c = i % kBN;
      bool ok = k0 + r < k && n0 + c < n;
      sb[r * kBStride + c] = ok ? w[(size_t)(k0 + r) * n + n0 + c] : zero;
    }
  }
}

// grid (ceil(N / kBN), ceil(M / kBM), B * S): CTA (x, y, b * S + s)
// computes part s of the tile's K walk for batch entry b, into
// out + s * split_stride + b * M * N.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
invariant_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      float* __restrict__ out, int m, int n, int k, int splits,
                      int cps, long long split_stride) {
  __shared__ __align__(128) bf16 sa[kStages][kBM * kAStride];
  __shared__ __align__(128) bf16 sb[kStages][kBK * kBStride];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int b = blockIdx.z / splits, s = blockIdx.z % splits;
  x += (size_t)b * m * k;
  w += (size_t)b * k * n;
  out += s * split_stride + (long long)b * m * n;
  const int kc = (k + kBK - 1) / kBK;
  const int c0 = s * cps;
  const int chunks = min(kc, c0 + cps) - c0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool active = m0 + warp * 16 < m;   // the warp holds a real row

  float acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks)
      load_stage<kAligned>(sa[st], sb[st], x, w, m0, n0, (c0 + st) * kBK, m,
                           n, k, tid);
    cp_async_commit();
  }
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < chunks)
      load_stage<kAligned>(sa[next % kStages], sb[next % kStages], x, w, m0,
                           n0, (c0 + next) * kBK, m, n, k, tid);
    cp_async_commit();
    if (!active) continue;
    const bf16* a = sa[i % kStages];
    const bf16* bt = sb[i % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[4];
      ldsm_x4(af, a + (warp * 16 + (lane & 15)) * kAStride + kk
                      + (lane >> 4) * 8);
      const int j = lane >> 3;
#pragma unroll
      for (int nt = 0; nt < kBN / 8; nt += 2) {
        unsigned bfr[4];
        ldsm_x4_trans(bfr, bt + (kk + (lane & 7) + ((j & 1) << 3)) * kBStride
                               + nt * 8 + ((j >> 1) << 3));
        mma_bf16(acc[nt], af, bfr[0], bfr[1]);
        mma_bf16(acc[nt + 1], af, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  const int r0 = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    const int col = n0 + nt * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= m) continue;
      float* o = out + (size_t)row * n;
      if (col < n) o[col] = acc[nt][2 * h];
      if (col + 1 < n) o[col + 1] = acc[nt][2 * h + 1];
    }
  }
}

// y[i] = part[0][i] + part[1][i] + ... + part[S - 1][i], left to right.
__global__ void invariant_gemm_fold_kernel(const float* __restrict__ part,
                                           float* __restrict__ y,
                                           long long count, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v = __fadd_rn(v, part[s * count + i]);
    y[i] = v;
  }
}

}  // namespace

extern "C" {

// x: [B, M, K] bf16, w: [B, K, N] bf16, y: [B, M, N] f32, all contiguous;
// scratch: [S, B, M, N] f32 when splits > 1 (else unused). `aligned`: K
// and N multiples of 8 and x, w 16-byte aligned. Launches the product
// (and, with splits > 1, the fold); returns cudaGetLastError().
int repro_invariant_gemm(const void* x, const void* w, void* y,
                         void* scratch, int batch, int m, int n, int k,
                         int splits, int cps, int aligned, void* stream) {
  const int kc = (k + kBK - 1) / kBK;
  if (batch < 1 || m < 1 || n < 1 || k < 1 || splits < 1 || cps < 1 ||
      (long long)splits * cps < kc || (splits - 1) * cps >= kc ||
      (splits > 1 && scratch == nullptr) ||
      (m + kBM - 1) / kBM > 65535 || (long long)batch * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long count = (long long)batch * m * n;
  float* out = static_cast<float*>(splits > 1 ? scratch : y);
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch * splits);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  if (aligned)
    invariant_gemm_kernel<true><<<grid, kThreads, 0, st>>>(
        xb, wb, out, m, n, k, splits, cps, count);
  else
    invariant_gemm_kernel<false><<<grid, kThreads, 0, st>>>(
        xb, wb, out, m, n, k, splits, cps, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  long long blocks = (count + 255) / 256;
  invariant_gemm_fold_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                               256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<float*>(y), count,
      splits);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
