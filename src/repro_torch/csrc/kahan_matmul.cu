// Matmul with compensated K-block accumulation for Hopper (sm_90a):
// C = A @ B and C = A @ dequant(qw).
//
// Replaces the TPU kernels of repro/kernels/kahan_matmul.py:
// `_kahan_matmul_kernel` (launched by `kahan_matmul`) and
// `_kahan_matmul_q8_kernel` (launched by `kahan_matmul_q8`). For every
// output element the K axis is cut into blocks of bk; each block's
// partial dot is an ordinary f32 sum (the TPU's MXU partial), and the
// partials are folded into a Neumaier (sum, carry) pair in block order.
// The result is sum + carry in f32. The compensation works ACROSS the
// blocks, so the kernel folds at exactly the reference's bk boundaries
// (the result depends on bk; the reference's bm / bn change no number
// and play no part here).
//
// q8 form: B is an int8 or fp8 (e4m3 bytes in u8) payload [K, N] with
// f32 scales [K / bk, N]; each block partial is multiplied by its
// (block, column) scale as its own rounding (__fmul_rn) before the
// fold. int8 widens exactly; fp8 widens through the bit trick of
// repro.quant.core.e4m3_to_f32 (superkernel_common.cuh). The TPU
// kernel reads fp8 bytes as integers; this one widens them as e4m3.
//
// Design (simple first): one CTA per 64 x 64 output tile, 256 threads,
// each thread 4 x 4 outputs (rows ty + 16 i, columns tx + 16 j). A
// K-slice of 16 is staged in shared memory (A transposed, both widened
// to f32, ragged rows / columns zero-filled), and the thread's 16
// partials run an FMA chain inside a K block; at the block's end the
// partials are folded with TwoSum (__fadd_rn / __fsub_rn, no
// contraction) into register (sum, carry) pairs. bf16 inputs widen
// exactly, so their products are exact in f32.
//
// Bound: operations. At the qwen1.5 down projection (A [2048, 2816],
// B [2816, 1024]) the product is 11.8 GFLOP against 43 MB of traffic:
// 0.176 ms at the f32 CUDA-core rate (TF32 would change the numbers),
// 0.013 ms for the bytes (H100 SXM data sheet, 700 W power limit).
// This version runs on the CUDA cores from shared memory; tensor cores
// (wgmma) with the fold in registers are a later step. At a decode
// batch (M = 8) the grid has N / 64 CTAs and the time is latency, not
// bandwidth.
//
// ptxas (sm_90a, -O3, CUDA 12.8): 78 registers and 8448 bytes of static
// shared memory (one kernel for plain and int8 / fp8 weights); no
// spills.

#include "superkernel_common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kahan_matmul_kernel(const void* __restrict__ a, const void* __restrict__ b,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int m, int n, int k, int bk, int a_type, int b_type) {
  __shared__ float a_s[kDepth][kTile + 4];   // [kk][row]
  __shared__ float b_s[kDepth][kTile];       // [kk][col]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float s[4][4], c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = c[i][j] = 0.0f;

  const int nblk = k / bk;
  for (int blk = 0; blk < nblk; ++blk) {
    const int kbeg = blk * bk;
    const int kend = kbeg + bk;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;

    for (int k0 = kbeg; k0 < kend; k0 += kDepth) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = threadIdx.x + kThreads * q;
        const int r = idx >> 4, kk = idx & 15;
        const int gr = row0 + r, gk = k0 + kk;
        a_s[kk][r] = (gr < m && gk < kend)
                         ? load_pool(a, static_cast<long long>(gr) * k + gk,
                                     a_type)
                         : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = threadIdx.x + kThreads * q;
        const int kk = idx >> 6, cc = idx & 63;
        const int gk = k0 + kk, gc = col0 + cc;
        b_s[kk][cc] = (gk < kend && gc < n)
                          ? load_pool(b, static_cast<long long>(gk) * n + gc,
                                      b_type)
                          : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = __fmaf_rn(av[i], bv[j], p[i][j]);
      }
      __syncthreads();
    }

    // fold this block's partials: (s, c) <- neumaier_step(s, c, x)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      const float sc = (scales != nullptr && col < n)
                           ? scales[static_cast<long long>(blk) * n + col]
                           : 1.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = scales != nullptr ? __fmul_rn(p[i][j], sc) : p[i][j];
        const Pair t = twosum(s[i][j], x);
        s[i][j] = t.s;
        c[i][j] = __fadd_rn(c[i][j], t.c);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < n)
        out[static_cast<long long>(row) * n + col] = __fadd_rn(s[i][j], c[i][j]);
    }
  }
}

int launch(const void* a, const void* b, const float* scales, float* out,
           int m, int n, int k, int bk, int a_type, int b_type,
           void* stream) {
  dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  kahan_matmul_kernel<<<grid, kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      a, b, scales, out, m, n, k, bk, a_type, b_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// C [m, n] f32 = A [m, k] @ B [k, n], Neumaier fold every bk along K
// (bk divides k). a_type / b_type: POOL_BF16 or POOL_F32. Launches on
// `stream`; returns cudaGetLastError().
int repro_kahan_matmul(const void* a, const void* b, void* out, int m, int n,
                       int k, int bk, int a_type, int b_type, void* stream) {
  return launch(a, b, nullptr, static_cast<float*>(out), m, n, k, bk, a_type,
                b_type, stream);
}

// C [m, n] f32 = A [m, k] @ dequant(qw [k, n], scales [k / bk, n]).
// a_type: POOL_BF16 or POOL_F32; b_type: POOL_INT8 or POOL_FP8.
int repro_kahan_matmul_q8(const void* a, const void* qw, const void* scales,
                          void* out, int m, int n, int k, int bk, int a_type,
                          int b_type, void* stream) {
  return launch(a, qw, static_cast<const float*>(scales),
                static_cast<float*>(out), m, n, k, bk, a_type, b_type,
                stream);
}

}  // extern "C"
