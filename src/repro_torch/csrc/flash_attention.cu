// Flash attention (online softmax, uncompensated) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py,
// `_flash_kernel` launched by `flash_attention_pallas`: q / k / v
// [BH, L, D] (f32 or bf16), all arithmetic in f32, output in q's dtype.
// Semantics copied from the Pallas kernel, not from its test oracle:
// * causal is top-left, q_pos >= k_pos (the two differ when Lq != Lk);
// * key tiles entirely above the diagonal are skipped;
// * ragged Lq / Lk need no padding: key rows past Lk are never read
//   (their shared-memory slots are zero-filled) and are masked, query
//   rows past Lq are computed on zeros and never stored;
// * masked scores are the finite -1e30, and masked p is multiplied to 0;
// * m starts at -1e30, l and acc at 0; per key tile
//   m_new = max(m, rowmax s), p = exp(s - m_new) * mask,
//   corr = exp(m - m_new), l = l * corr + sum p, acc = acc * corr + p V;
// * out = acc / max(l, 1e-30), IEEE expf and division (no fast math).
// The kernel tiles by its own 64 x 64, so its online-softmax steps
// differ from the reference's 256 x 256 blocks: it is held to the
// reference at a tolerance (f32 rounding of the rescales and sums).
//
// Design (simple first): one CTA per (bh, 64 query rows), 256 threads
// as 16 x 16, each thread owning 4 query rows (ty + 16 i) and, per key
// tile, 4 key columns (tx + 16 j) of the score tile and Dv / 16 output
// columns (tx + 16 j) of the accumulator, all in registers. Q, the K
// and V tiles (widened to f32) and the p tile sit in shared memory (Q
// and K rows padded by one float against bank conflicts). A row's 64
// scores live in the 16 lanes of one half-warp, so the row max and the
// row sum are xor-shuffle butterflies (every lane ends with the same
// value). D and Dv up to 128.
//
// Bound: at the qwen1.5 prefill shape (BH = 64, L = 2048, D = 64, bf16,
// causal) the work is 34.4 GFLOP (the causal half) against 67 MB of
// traffic: 0.035 ms at the bf16 tensor-core rate, 0.020 ms for the
// bytes (H100 SXM data sheet, 700 W power limit), so operations. This
// kernel does the products on the CUDA cores from shared memory, far
// from that rate. It is the route of head dims that are not multiples of
// 16, f32 or bf16; inputs whose D and Dv are multiples of 16 go to the
// tensor cores (flash_attention_wgmma.cu: bf16, and f32 as exact bf16
// planes, since the reference's f32 tolerance of 2e-5 rules out TF32).
//
// ptxas (sm_90a, -O3, CUDA 12.8): 64 / 78 / 128 registers for Dv up to
// 32 / 64 / 128; no spills.

#include "superkernel_common.cuh"

namespace {

constexpr int kQ = 64;
constexpr int kK = 64;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       const void* __restrict__ v, void* __restrict__ out,
                       int lq, int lk, int d, int dv, float scale, int causal,
                       int io_type) {
  extern __shared__ float smem[];
  const int ds = d + 1;                 // padded row stride of Q and K
  float* q_s = smem;                    // [kQ][ds]
  float* k_s = q_s + kQ * ds;           // [kK][ds]
  float* v_s = k_s + kK * ds;           // [kK][dv]
  float* p_s = v_s + kK * dv;           // [kQ][kK]

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  for (int i = threadIdx.x; i < kQ * d; i += kThreads) {
    const int r = i / d, e = i % d;
    q_s[r * ds + e] =
        q0 + r < lq ? load_io(q, (bh * lq + q0 + r) * d + e, io_type) : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // key tiles: all of them, or (causal) those not above the diagonal of
  // the last real query row of this CTA
  int tiles = (lk + kK - 1) / kK;
  if (causal) {
    const int q_last = min(q0 + kQ, lq) - 1;
    tiles = min(tiles, q_last / kK + 1);
  }

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kK;
    for (int i = threadIdx.x; i < kK * d; i += kThreads) {
      const int r = i / d, e = i % d;
      k_s[r * ds + e] =
          k0 + r < lk ? load_io(k, (bh * lk + k0 + r) * d + e, io_type) : 0.0f;
    }
    for (int i = threadIdx.x; i < kK * dv; i += kThreads) {
      const int r = i / dv, e = i % dv;
      v_s[i] =
          k0 + r < lk ? load_io(v, (bh * lk + k0 + r) * dv + e, io_type) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int e = 0; e < d; ++e) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * ds + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * ds + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = __fmaf_rn(a[i], b[j], sc[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mask[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool ok = k_pos < lk && (!causal || q_pos >= k_pos);
        mask[j] = ok ? 1.0f : 0.0f;
        sc[i][j] = ok ? __fmul_rn(sc[i][j], scale) : kNegInf;
        mx = pmax(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = pmax(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = pmax(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __fmul_rn(expf(__fsub_rn(sc[i][j], m_new)), mask[j]);
        p_s[(ty + 16 * i) * kK + tx + 16 * j] = p;
        rs = __fadd_rn(rs, p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(kFull, rs, off));
      corr[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), rs);
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) pv[i][j] = 0.0f;
    for (int c = 0; c < kK; ++c) {
      float a[4], b[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = p_s[(ty + 16 * i) * kK + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        b[j] = col < dv ? v_s[c * dv + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) pv[i][j] = __fmaf_rn(a[i], b[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr[i]), pv[i][j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col >= dv) continue;
      const float o = __fdiv_rn(acc[i][j], denom);
      const long long idx = (bh * lq + row) * dv + col;
      if (io_type == IO_BF16) {
        static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(o);
      } else {
        static_cast<float*>(out)[idx] = o;
      }
    }
  }
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int lq, int lk, int d, int dv, float scale, int causal,
           int io_type, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<NJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((lq + kQ - 1) / kQ, bh);
  flash_attention_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lq, lk, d, dv, scale, causal, io_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory (bytes) one CTA needs.
long long repro_flash_attention_smem(int d, int dv) {
  return 4LL * ((kQ + kK) * (d + 1) + kK * dv + kQ * kK);
}

// q, k: [bh, lq | lk, d]; v: [bh, lk, dv]; out: [bh, lq, dv]; all of
// io_type (IO_BF16 / IO_F32). d, dv in [1, 128]. Launches on `stream`;
// returns cudaGetLastError().
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int bh, int lq, int lk, int d, int dv,
                          float scale, int causal, int io_type, void* stream) {
  const long long smem = repro_flash_attention_smem(d, dv);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dv <= 32)
    return launch<2>(q, k, v, out, bh, lq, lk, d, dv, scale, causal, io_type,
                     smem, st);
  if (dv <= 64)
    return launch<4>(q, k, v, out, bh, lq, lk, d, dv, scale, causal, io_type,
                     smem, st);
  return launch<8>(q, k, v, out, bh, lq, lk, d, dv, scale, causal, io_type,
                   smem, st);
}

}  // extern "C"
