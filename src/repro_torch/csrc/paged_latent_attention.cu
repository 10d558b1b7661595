// Paged-attention superkernel, MLA latent form, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py,
// `_super_kernel` (mla=True) launched by `paged_latent_attention_pallas`.
// MLA decode is MQA-like: the W*H query rows of a sequence (row
// r = w * H + h) all attend ONE latent stream through the block table.
// Row r sees keys at positions < q_offsets[b] + 1 + r / H. Scores have two
// parts, s = (q_lat . c_kv + q_rope . k_rope) * scale, and the value IS
// the c_kv latent, so each c_kv tile is staged once in shared memory and
// read for both. int8 / fp8 pools carry one f32 scale per cached token
// for each stream: s = (q_lat . c_kv * cs + q_rope . k_rope * rs) * scale,
// and p is scaled by cs (the c_kv scale) before the PV product while the
// normaliser sums the unscaled p. The online softmax keeps l and acc as
// Neumaier (sum, carry) pairs; the rescale multiplies sum AND carry. The
// output is the f32 context latent [B, W, H, C]; the caller applies the
// absorbed value projection. `scale` is passed: (nope + rope)^-0.5, not
// derivable from C.
//
// Design: the accumulator of one sequence is [W*H, C] f32 twice (sum and
// carry), 512 KB for a full-width decode row set (128 heads x 512), so
// it cannot live in one block as the GQA kernel keeps its own. The ROWS
// are split instead: grid (B, ceil(W*H / 16)), each block holding 16
// query rows, their accumulators and one staged latent tile in ~138 KB of
// shared memory, and walking the sequence's whole table with a loop over
// the slots (dead slots, j * bs >= lens[b], skipped; bounded by the table
// width for idle slots). Every row block re-reads the sequence's latent
// tiles; after the first they come from L2. The walk is never split over
// table slots: that would change the summation order.
//
// Width invariance, bitwise: every score (r, t), every row's softmax
// bookkeeping and every output element (r, e) is one thread's fixed
// sequential chain (the c_kv dot, then the rope dot, then the scale, in
// the reference's order of operations), independent of W and of which
// block holds the row, so row w of a width-W call equals the width-1
// call at q_offsets + w.
//
// Bound: operations. Each live (row, key) pair costs 2 * (C + R) flops
// for the score and 2 * C for the value; at the serve decode shape
// (H = 128, C = 512, R = 64) that is ~2176 flops per row per cached token
// against 1152 bytes of bf16 latents per token shared by all 128 rows.
// This first version is latency-bound instead: one thread per score runs
// a 576-term FMA chain, with two barriers per slot and no prefetch.
//
// Compensated chains use __fmul_rn / __fadd_rn (no FMA contraction) and
// the IEEE expf; no --use_fast_math. NEG_INF is the reference's finite
// -1e30, and the `* mask` after exp makes a masked key an exact identity
// update. Staged tiles are padded to an odd row stride so that the 16
// keys of a warp's score loads fall in 16 different banks.

#include "superkernel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // query rows per block

// q_lat: [B, W*H, C]; q_rope: [B, W*H, R]; ck_pool: [nb, bs, C];
// kr_pool: [nb, bs, R]; scales: [nb, bs]; table: [B, mb]; lens, offs: [B];
// out: [B, W*H, C] f32.
__global__ void __launch_bounds__(kThreads)
paged_latent_attention_kernel(const void* __restrict__ q_lat,
                              const void* __restrict__ q_rope,
                              const void* __restrict__ ck_pool,
                              const void* __restrict__ kr_pool,
                              const float* __restrict__ ck_scale,
                              const float* __restrict__ kr_scale,
                              const int* __restrict__ table,
                              const int* __restrict__ lens,
                              const int* __restrict__ offs,
                              float* __restrict__ out, int rows, int h,
                              int c, int r, int bs, int mb, float scale,
                              int pool_type, int ql_type, int qr_type) {
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - row0);
  const bool quant = ck_scale != nullptr;
  const int cp = c + 1;                // padded strides of the staged tiles
  const int rp = r + 1;

  extern __shared__ float smem[];
  float* ql_s = smem;                  // [kRows][cp]
  float* qr_s = ql_s + kRows * cp;     // [kRows][rp]
  float* ck_s = qr_s + kRows * rp;     // [bs][cp]
  float* kr_s = ck_s + bs * cp;        // [bs][rp]
  float* p_s = kr_s + bs * rp;         // [kRows][bs] scores, then p
  float* acc_s = p_s + kRows * bs;     // [kRows][c] acc sum
  float* acc_c = acc_s + kRows * c;    // [kRows][c] acc carry
  float* m_s = acc_c + kRows * c;      // [kRows]
  float* l_s = m_s + kRows;            // [kRows] l sum
  float* l_c = l_s + kRows;            // [kRows] l carry
  float* corr_s = l_c + kRows;         // [kRows]
  float* cs_s = corr_s + kRows;        // [bs] c_kv scales
  float* rs_s = cs_s + bs;             // [bs] k_rope scales

  const long long qrow = (long long)b * rows + row0;
  for (int i = threadIdx.x; i < nr * c; i += kThreads) {
    const int lr = i / c, e = i % c;
    ql_s[lr * cp + e] = load_io(q_lat, (qrow + lr) * c + e, ql_type);
  }
  for (int i = threadIdx.x; i < nr * r; i += kThreads) {
    const int lr = i / r, e = i % r;
    qr_s[lr * rp + e] = load_io(q_rope, (qrow + lr) * r + e, qr_type);
  }
  for (int i = threadIdx.x; i < kRows * c; i += kThreads) {
    acc_s[i] = 0.0f;
    acc_c[i] = 0.0f;
  }
  for (int lr = threadIdx.x; lr < kRows; lr += kThreads) {
    m_s[lr] = kNegInf;
    l_s[lr] = 0.0f;
    l_c[lr] = 0.0f;
  }
  const int length = lens[b];
  const int off = offs[b];
  __syncthreads();

  for (int j = 0; j < mb; ++j) {
    if (j * bs >= length) break;       // dead block: identity update
    const long long blk = table[(long long)b * mb + j];
    // stage the c_kv and k_rope tiles (and scales) of block blk as f32
    for (int i = threadIdx.x; i < bs * c; i += kThreads) {
      const int t = i / c, e = i % c;
      ck_s[t * cp + e] = load_pool(ck_pool, (blk * bs + t) * c + e,
                                   pool_type);
    }
    for (int i = threadIdx.x; i < bs * r; i += kThreads) {
      const int t = i / r, e = i % r;
      kr_s[t * rp + e] = load_pool(kr_pool, (blk * bs + t) * r + e,
                                   pool_type);
    }
    if (quant) {
      for (int t = threadIdx.x; t < bs; t += kThreads) {
        cs_s[t] = ck_scale[blk * bs + t];
        rs_s[t] = kr_scale[blk * bs + t];
      }
    }
    __syncthreads();

    // scores s[lr][t], masked
    for (int i = threadIdx.x; i < nr * bs; i += kThreads) {
      const int lr = i / bs, t = i % bs;
      const float* qlr = ql_s + lr * cp;
      const float* ckt = ck_s + t * cp;
      float dl = 0.0f;
      for (int e = 0; e < c; ++e) dl = __fmaf_rn(qlr[e], ckt[e], dl);
      const float* qrr = qr_s + lr * rp;
      const float* krt = kr_s + t * rp;
      float dr = 0.0f;
      for (int e = 0; e < r; ++e) dr = __fmaf_rn(qrr[e], krt[e], dr);
      const float sum = quant ? __fadd_rn(__fmul_rn(dl, cs_s[t]),
                                          __fmul_rn(dr, rs_s[t]))
                              : __fadd_rn(dl, dr);
      const int limit = off + 1 + (row0 + lr) / h;
      p_s[i] = (j * bs + t < limit) ? __fmul_rn(sum, scale) : kNegInf;
    }
    __syncthreads();

    // per row: running max, p = exp(s - m_new) * mask, corr, l update;
    // p_s[lr][t] becomes p (times the c_kv scale for quantized pools)
    for (int lr = threadIdx.x; lr < nr; lr += kThreads) {
      float* pr = p_s + lr * bs;
      const int limit = off + 1 + (row0 + lr) / h;
      const float m_prev = m_s[lr];
      float mx = pr[0];
      for (int t = 1; t < bs; ++t) mx = pmax(mx, pr[t]);
      const float m_new = pmax(m_prev, mx);
      float p_sum = 0.0f;
      for (int t = 0; t < bs; ++t) {
        const float mask = (j * bs + t < limit) ? 1.0f : 0.0f;
        const float p = __fmul_rn(expf(__fsub_rn(pr[t], m_new)), mask);
        p_sum = __fadd_rn(p_sum, p);
        pr[t] = quant ? __fmul_rn(p, cs_s[t]) : p;
      }
      const float corr = expf(__fsub_rn(m_prev, m_new));
      rescale_add(l_s[lr], l_c[lr], corr, p_sum);
      m_s[lr] = m_new;
      corr_s[lr] = corr;
    }
    __syncthreads();

    // acc[lr][e] <- neumaier(acc * corr, carry * corr, sum_t p[lr][t] ck[t][e])
    for (int i = threadIdx.x; i < nr * c; i += kThreads) {
      const int lr = i / c, e = i % c;
      const float* pr = p_s + lr * bs;
      float pv = 0.0f;
      for (int t = 0; t < bs; ++t) pv = __fmaf_rn(pr[t], ck_s[t * cp + e], pv);
      rescale_add(acc_s[i], acc_c[i], corr_s[lr], pv);
    }
    __syncthreads();
  }

  // out = (acc_s + acc_c) / max(l_s + l_c, 1e-30)
  for (int i = threadIdx.x; i < nr * c; i += kThreads) {
    const int lr = i / c, e = i % c;
    const float l = fmaxf(__fadd_rn(l_s[lr], l_c[lr]), 1e-30f);
    out[(qrow + lr) * c + e] = __fdiv_rn(__fadd_rn(acc_s[i], acc_c[i]), l);
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs.
long long repro_paged_latent_attention_smem(int c, int r, int bs) {
  return 4LL * ((long long)kRows * (c + 1) + kRows * (r + 1) +
                (long long)bs * (c + 1) + bs * (r + 1) + kRows * bs +
                2LL * kRows * c + 4LL * kRows + 2LL * bs);
}

// Launch on `stream`; grid (B, ceil(W*H / rows per block)). ck_scale /
// kr_scale are null for unquantized pools. Returns cudaGetLastError().
int repro_paged_latent_attention(const void* q_lat, const void* q_rope,
                                 const void* ck_pool, const void* kr_pool,
                                 const void* ck_scale, const void* kr_scale,
                                 const void* table, const void* lens,
                                 const void* offs, void* out, int batch,
                                 int w, int h, int c, int r, int bs, int mb,
                                 float scale, int pool_type, int ql_type,
                                 int qr_type, void* stream) {
  const int rows = w * h;
  const long long smem = repro_paged_latent_attention_smem(c, r, bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_latent_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(batch, (rows + kRows - 1) / kRows);
  paged_latent_attention_kernel<<<grid, kThreads, smem,
                                  reinterpret_cast<cudaStream_t>(stream)>>>(
      q_lat, q_rope, ck_pool, kr_pool, static_cast<const float*>(ck_scale),
      static_cast<const float*>(kr_scale), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<const int*>(offs),
      static_cast<float*>(out), rows, h, c, r, bs, mb, scale, pool_type,
      ql_type, qr_type);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
