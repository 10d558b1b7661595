// Paged-attention superkernel (GQA form) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py,
// `_super_kernel` (mla=False) launched by `paged_attention_pallas`.
// W query rows per sequence attend a block-paged K/V pool through a
// block table: row r (= w * groups + g, width-major per kv head) sees
// keys at positions < q_offsets[b] + 1 + r / groups. The online softmax
// keeps the normaliser l and the output accumulator acc as Neumaier
// (sum, carry) pairs; the rescale multiplies sum AND carry. int8 / fp8
// pools carry per-(token, head) f32 scales: kscale is folded into the
// [rows, bs] score tile after the dot, vscale into p before the PV
// product, and the normaliser sums the unscaled p.
//
// Design: one CUDA block per (sequence b, kv head h); a loop over the
// table slots j inside the block replaces the TPU's sequential grid
// axis. Slots with j * bs >= lens[b] are skipped (exact identity
// updates in the reference); the loop is bounded by the table width,
// since idle slots' lengths drift past it and their tables point at
// the null block. Each step stages the bs x D K and V tile (and the
// scales) in shared memory, widened to f32 (fp8 bytes by the same bit
// trick as repro.quant.core.e4m3_to_f32, so 0x7f / 0xff give +-480).
//
// Width invariance, bitwise: every score (r, t), every row's softmax
// bookkeeping and every output element (r, e) is computed by one thread
// in a fixed sequential order that does not depend on W, and there is
// no split over table slots, so row w of a width-W call equals the
// width-1 call at q_offsets + w.
//
// Bound: bytes. Decode reads each resident K/V token once (bf16:
// 2 * Hkv * D * 2 bytes per token per layer) with ~4 flops per byte, far
// below the card's ridge. This first version is latency-bound instead:
// one block per (b, h) walks its table serially with two barriers per
// slot and no prefetch of the next tile.
//
// The compensated chains use __fmul_rn / __fadd_rn (no FMA contraction:
// neumaier(ls * corr, lc * corr, p_sum) would otherwise fuse the product
// into the add and the carry would measure the wrong rounding) and the
// IEEE expf. NEG_INF is the finite -1e30 of the reference; the `* mask`
// after exp makes a fully masked row an exact identity update.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

enum PoolType : int { POOL_BF16 = 0, POOL_F32 = 1, POOL_INT8 = 2,
                      POOL_FP8 = 3 };
enum IoType : int { IO_BF16 = 0, IO_F32 = 1 };

struct Pair { float s, c; };

__device__ __forceinline__ Pair twosum(float a, float b) {
  float s = __fadd_rn(a, b);
  float ap = __fsub_rn(s, b);
  float bp = __fsub_rn(s, ap);
  float da = __fsub_rn(a, ap);
  float db = __fsub_rn(b, bp);
  return {s, __fadd_rn(da, db)};
}

// NaN-propagating max (jnp.maximum semantics)
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// (s, c) <- neumaier_step(s * corr, c * corr, x)
__device__ __forceinline__ void rescale_add(float& s, float& c, float corr,
                                            float x) {
  Pair t = twosum(__fmul_rn(s, corr), x);
  s = t.s;
  c = __fadd_rn(__fmul_rn(c, corr), t.c);
}

__device__ __forceinline__ float e4m3_to_f32(uint8_t u) {
  unsigned short h = (unsigned short)(((u & 0x80u) << 8) | ((u & 0x7Fu) << 7));
  return __fmul_rn(__half2float(__ushort_as_half(h)), 256.0f);
}

__device__ __forceinline__ float load_pool(const void* p, long long i,
                                           int type) {
  switch (type) {
    case POOL_BF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case POOL_F32:
      return static_cast<const float*>(p)[i];
    case POOL_INT8:
      return static_cast<float>(static_cast<const int8_t*>(p)[i]);
    default:
      return e4m3_to_f32(static_cast<const uint8_t*>(p)[i]);
  }
}

__device__ __forceinline__ float load_io(const void* p, long long i,
                                         int type) {
  return type == IO_BF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// q: [B, W, Hq, D]; pools: [nb, bs, Hkv, D(v)]; scales: [nb, bs, Hkv];
// table: [B, mb]; lens, offs: [B]; out: [B, W, Hq, Dv].
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const void* __restrict__ q,
                       const void* __restrict__ kpool,
                       const void* __restrict__ vpool,
                       const float* __restrict__ kscale,
                       const float* __restrict__ vscale,
                       const int* __restrict__ table,
                       const int* __restrict__ lens,
                       const int* __restrict__ offs,
                       void* __restrict__ out, int w, int hq, int hkv, int d,
                       int dv, int bs, int mb, float scale, int pool_type,
                       int io_type) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int groups = hq / hkv;
  const int rows = w * groups;
  const bool quant = kscale != nullptr;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [rows][d]
  float* k_s = q_s + rows * d;         // [bs][d]
  float* v_s = k_s + bs * d;           // [bs][dv]
  float* p_s = v_s + bs * dv;          // [rows][bs] scores, then p
  float* acc_s = p_s + rows * bs;      // [rows][dv] acc sum
  float* acc_c = acc_s + rows * dv;    // [rows][dv] acc carry
  float* m_s = acc_c + rows * dv;      // [rows]
  float* l_s = m_s + rows;             // [rows] l sum
  float* l_c = l_s + rows;             // [rows] l carry
  float* corr_s = l_c + rows;          // [rows]
  float* ks_s = corr_s + rows;         // [bs]
  float* vs_s = ks_s + bs;             // [bs]

  // q rows of this kv head: row r = wi * groups + g <- q[b, wi, h*groups+g]
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, e = i % d;
    const int wi = r / groups, g = r % groups;
    q_s[i] = load_io(q, (((long long)b * w + wi) * hq + h * groups + g) * d + e,
                     io_type);
  }
  for (int i = threadIdx.x; i < rows * dv; i += kThreads) {
    acc_s[i] = 0.0f;
    acc_c[i] = 0.0f;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
    l_c[r] = 0.0f;
  }
  const int length = lens[b];
  const int off = offs[b];
  __syncthreads();

  for (int j = 0; j < mb; ++j) {
    if (j * bs >= length) break;       // dead block: identity update
    const long long blk = table[(long long)b * mb + j];
    // stage K, V (and scales) of (blk, :, h, :) as f32
    for (int i = threadIdx.x; i < bs * d; i += kThreads) {
      const int t = i / d, e = i % d;
      k_s[i] = load_pool(kpool, ((blk * bs + t) * hkv + h) * d + e, pool_type);
    }
    for (int i = threadIdx.x; i < bs * dv; i += kThreads) {
      const int t = i / dv, e = i % dv;
      v_s[i] = load_pool(vpool, ((blk * bs + t) * hkv + h) * dv + e,
                         pool_type);
    }
    if (quant) {
      for (int t = threadIdx.x; t < bs; t += kThreads) {
        ks_s[t] = kscale[(blk * bs + t) * hkv + h];
        vs_s[t] = vscale[(blk * bs + t) * hkv + h];
      }
    }
    __syncthreads();

    // scores s[r][t] = (q_r . k_t) * scale [* kscale_t], masked
    for (int i = threadIdx.x; i < rows * bs; i += kThreads) {
      const int r = i / bs, t = i % bs;
      const float* qr = q_s + r * d;
      const float* kt = k_s + t * d;
      float dot = 0.0f;
      for (int e = 0; e < d; ++e) dot = __fmaf_rn(qr[e], kt[e], dot);
      float s = __fmul_rn(dot, scale);
      if (quant) s = __fmul_rn(s, ks_s[t]);
      const int limit = off + 1 + r / groups;
      p_s[i] = (j * bs + t < limit) ? s : kNegInf;
    }
    __syncthreads();

    // per row: running max, p = exp(s - m_new) * mask, corr, l update;
    // p_s[r][t] becomes p (times vscale for quantized pools)
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      float* pr = p_s + r * bs;
      const int limit = off + 1 + r / groups;
      const float m_prev = m_s[r];
      float mx = pr[0];
      for (int t = 1; t < bs; ++t) mx = pmax(mx, pr[t]);
      const float m_new = pmax(m_prev, mx);
      float p_sum = 0.0f;
      for (int t = 0; t < bs; ++t) {
        const float mask = (j * bs + t < limit) ? 1.0f : 0.0f;
        const float p = __fmul_rn(expf(__fsub_rn(pr[t], m_new)), mask);
        p_sum = __fadd_rn(p_sum, p);
        pr[t] = quant ? __fmul_rn(p, vs_s[t]) : p;
      }
      const float corr = expf(__fsub_rn(m_prev, m_new));
      rescale_add(l_s[r], l_c[r], corr, p_sum);
      m_s[r] = m_new;
      corr_s[r] = corr;
    }
    __syncthreads();

    // acc[r][e] <- neumaier(acc * corr, carry * corr, sum_t p[r][t] v[t][e])
    for (int i = threadIdx.x; i < rows * dv; i += kThreads) {
      const int r = i / dv, e = i % dv;
      const float* pr = p_s + r * bs;
      float pv = 0.0f;
      for (int t = 0; t < bs; ++t) pv = __fmaf_rn(pr[t], v_s[t * dv + e], pv);
      rescale_add(acc_s[i], acc_c[i], corr_s[r], pv);
    }
    __syncthreads();
  }

  // out = (acc_s + acc_c) / max(l_s + l_c, 1e-30)
  for (int i = threadIdx.x; i < rows * dv; i += kThreads) {
    const int r = i / dv, e = i % dv;
    const int wi = r / groups, g = r % groups;
    const float l = fmaxf(__fadd_rn(l_s[r], l_c[r]), 1e-30f);
    const float o = __fdiv_rn(__fadd_rn(acc_s[i], acc_c[i]), l);
    const long long idx = (((long long)b * w + wi) * hq + h * groups + g) * dv + e;
    if (io_type == IO_BF16) {
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(o);
    } else {
      static_cast<float*>(out)[idx] = o;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) the kernel needs for one (b, h) block.
long long repro_paged_attention_smem(int rows, int d, int dv, int bs) {
  return 4LL * (rows * d + bs * d + bs * dv + rows * bs + 2LL * rows * dv +
                4LL * rows + 2LL * bs);
}

// Launch on `stream`; grid (B, Hkv). kscale / vscale are null for
// unquantized pools. Returns cudaGetLastError().
int repro_paged_attention(const void* q, const void* kpool, const void* vpool,
                          const void* kscale, const void* vscale,
                          const void* table, const void* lens,
                          const void* offs, void* out, int batch, int w,
                          int hq, int hkv, int d, int dv, int bs, int mb,
                          float scale, int pool_type, int io_type,
                          void* stream) {
  const int rows = w * (hq / hkv);
  const long long smem = repro_paged_attention_smem(rows, d, dv, bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(batch, hkv);
  paged_attention_kernel<<<grid, kThreads, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      q, kpool, vpool, static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<const int*>(offs), out, w,
      hq, hkv, d, dv, bs, mb, scale, pool_type, io_type);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
