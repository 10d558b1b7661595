// Flash attention (online softmax, uncompensated) on the Hopper tensor
// cores (sm_90a): the bf16 route of flash_attention.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py,
// `_flash_kernel` launched by `flash_attention_pallas`, for bf16 q / k /
// v [BH, L, D] whose head dims D and Dv are multiples of 16 up to 128;
// flash_attention.cu keeps f32 inputs and other head dims (the
// reference's f32 path needs full f32 products: TF32 would break its
// 2e-5 tolerance). The semantics are that file's (the Pallas kernel's):
// top-left causal q_pos >= k_pos, key tiles above the diagonal skipped,
// ragged Lq / Lk with key rows past Lk never read (zero-filled), masked
// scores the finite -1e30 and masked p exactly 0, m from -1e30, l and
// acc from 0, per key tile m_new = max(m, rowmax s), corr = exp(m -
// m_new), l = l * corr + sum p, acc = acc * corr + P V, and out =
// acc / max(l, 1e-30) in bf16. The score is multiplied by the scale
// after the product, as the reference does; the scale carries log2(e)
// so that exp(x) is 2^(x log2 e), taken by the hardware ex2
// (ex2.approx.ftz, ~2 ulp), as flash kernels on this card do. l sums the
// f32 p. Two roundings are new against the reference: p is rounded to
// bf16 as the A operand of the P V product (about one bf16 ulp of the
// output; the reference keeps p in f32), and the ex2. Both sit inside
// the bf16 tolerance of 2e-2: the parity cases read at most 1.56e-2,
// one bf16 ulp of an output in [2, 4).
//
// Bound: operations. At the qwen1.5 prefill shape (BH = 64, L = 2048,
// D = 64, causal) the work is 34.4 GFLOP against 67 MB of traffic:
// 0.035 ms at the bf16 tensor-core rate of 989 TFLOP/s, 0.020 ms for
// the bytes (H100 SXM data sheet, 700 W).
//
// Design: one CTA per (bh, 128 query rows), two consumer warpgroups of
// 64 rows each; under causal masking the CTAs walk the query tiles
// heaviest first (the grid's y index reversed), so the short tiles fill
// the tail wave. Q is staged once; K / V tiles of 64 keys go through a
// two-stage ring in shared memory filled by 16-byte cp.async (zero-fill
// past Lk and past D / Dv), issued one tile ahead of the compute. All
// tiles are stored in the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)), in 64-element-wide panels, so one wgmma
// descriptor (SBO 1024 bytes) addresses them:
// * S = Q K^T: wgmma.mma_async m64n64k16, both operands K-major from
//   shared memory, f32 accumulators in registers; bf16 products are
//   exact in f32, only the summation order differs from the reference.
// * online softmax in registers: a row's 64 scores sit in the 4 lanes
//   of a quad, so the row max is two xor shuffles; masks are applied
//   only on the diagonal tile and the ragged-Lk tile, in a code path of
//   their own (the unmasked path has no index arithmetic); a warpgroup
//   skips the tiles wholly above its own diagonal.
// * O += P V: P rounded to bf16 in registers is the register-A operand
//   (the S accumulator layout is the A fragment layout), V the B
//   operand read MN-major (transposed) from the swizzled tile, one
//   m64n64k16 per 64-wide panel of Dv.
// What bounds this design on the card is the softmax's instruction
// issue, not the tensor cores: a clock64 breakdown of an earlier version
// (exp2f, and the mask evaluated on every tile) showed the softmax
// taking most of a warpgroup's time, and this version's cuts there
// nearly halved the kernel's time. A three-stage ring that overlaps the
// softmax of tile t with the P V product of tile t - 1 (FA3's
// intra-warpgroup overlap) was slower on the card and is not used.
//
// ptxas (sm_90a, -O3, CUDA 12.8): 120 / 144 / 117 / 148 registers for
// (D, Dv) padded to (64, 64) / (64, 128) / (128, 64) / (128, 128), no
// spills; the (64, 64) build keeps two CTAs per SM. SASS: 8 / 12 / 12 /
// 16 HGMMA instructions, 48 in all.

#include "superkernel_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kM = 128;            // query rows per CTA (two warpgroups)
constexpr int kN = 64;             // keys per K / V tile
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the hardware ex2 (MUFU.EX2, flush to zero, ~2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage rows [row0, row0 + R) of a [L, D] bf16 matrix into the swizzled
// panels at `dst` (shared address): panel p (columns 64p..64p+63) is
// R x 128 bytes; rows past L and columns past D are zero-filled, never
// read.
template <int R, int DP>
__device__ __forceinline__ void stage_tile(unsigned dst,
                                           const __nv_bfloat16* src,
                                           int row0, int L, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per padded row
  constexpr int kRowsPer = kThreads / kChunks;    // rows of one pass
  static_assert(R % kRowsPer == 0 && kRowsPer % 8 == 0,
                "a thread keeps its chunk column and its swizzle phase");
  const int cg = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const unsigned at =
      dst + (cg >> 3) * (R * 128) + r0 * 128 + (((cg & 7) ^ (r0 & 7)) << 4);
  const bool col_ok = cg * 8 < D;
  const __nv_bfloat16* from = src + (long long)(row0 + r0) * D + cg * 8;
#pragma unroll
  for (int j = 0; j < R / kRowsPer; ++j) {
    const bool ok = col_ok && row0 + r0 + j * kRowsPer < L;
    cp_async16_zfill(at + j * kRowsPer * 128,
                     ok ? from + (long long)j * kRowsPer * D : src,
                     ok ? 16 : 0);
  }
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, DVP == 64 ? 2 : 1)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ out, int lq, int lk,
                             int d, int dv, float scale_log2, int causal) {
  constexpr int kNP = DVP / 64;    // 64-wide panels of Dv
  constexpr int kQBytes = kM * DP * 2;
  constexpr int kKBytes = kN * DP * 2;
  constexpr int kVBytes = kN * DVP * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned q_s = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const unsigned k_s = q_s + kQBytes;             // [2][kN][DP]
  const unsigned v_s = k_s + 2 * kKBytes;         // [2][kN][DVP]

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kM;
  const int tid = threadIdx.x;
  // the warpgroup index, broadcast so the compiler sees it is uniform
  // (a branch it cannot prove uniform makes it serialize the products)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qw = q0 + 64 * wg;     // first query row of this warpgroup
  const __nv_bfloat16* qb = q + (long long)bh * lq * d;
  const __nv_bfloat16* kb = k + (long long)bh * lk * d;
  const __nv_bfloat16* vb = v + (long long)bh * lk * dv;

  // key tiles of the CTA (causal: up to its last real row's diagonal),
  // and of this warpgroup (none if all its rows are past Lq)
  int tiles = (lk + kN - 1) / kN;
  if (causal) tiles = min(tiles, (min(q0 + kM, lq) - 1) / kN + 1);
  int wg_tiles = 0;
  if (qw < lq) {
    wg_tiles = tiles;
    if (causal) wg_tiles = min(tiles, (min(qw + 64, lq) - 1) / kN + 1);
  }

  stage_tile<kM, DP>(q_s, qb, q0, lq, d);
  stage_tile<kN, DP>(k_s, kb, 0, lk, d);
  stage_tile<kN, DVP>(v_s, vb, 0, lk, dv);
  cp_async_commit();

  float o[kNP][32];
#pragma unroll
  for (int pp = 0; pp < kNP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pp][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};       // this thread's share of the row sums
  // rows of this thread's accumulator entries: u < 2 -> r_lo, else r_hi
  const int r_lo = qw + warp * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;
  const int c_lane = 2 * (lane & 3);

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) {
      const int k1 = (t + 1) * kN;
      stage_tile<kN, DP>(k_s + (st ^ 1) * kKBytes, kb, k1, lk, d);
      stage_tile<kN, DVP>(v_s + (st ^ 1) * kVBytes, vb, k1, lk, dv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    if (t < wg_tiles) {
      const int k0 = t * kN;
      // S = Q K^T over DP / 16 steps of k16 (32 bytes within a panel row)
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const unsigned qa = q_s + (kk >> 2) * (kM * 128) + wg * (64 * 128) +
                            (kk & 3) * 32;
        const unsigned ka =
            k_s + st * kKBytes + (kk >> 2) * (kN * 128) + (kk & 3) * 32;
        wgmma_ss(s, make_desc(qa, 16, 1024), make_desc(ka, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // scale after the product; masks only where the tile needs them.
      // A masked score is -1e30, so its p = 2^(-1e30 - m) is exactly 0,
      // the reference's p * mask: every real row sees key 0, which sits
      // in tile 0, so m is finite from the first tile on.
      const bool need_mask =
          k0 + kN > lk || (causal && k0 + kN - 1 > qw);
      float mx[2] = {kNegInf, kNegInf};
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int kp = k0 + 8 * j + c_lane + (u & 1);
            const int qp = (u >> 1) ? r_hi : r_lo;
            const float x = (kp >= lk || (causal && qp < kp))
                                ? kNegInf
                                : __fmul_rn(s[4 * j + u], scale_log2);
            s[4 * j + u] = x;
            mx[u >> 1] = fmaxf(mx[u >> 1], x);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = __fmul_rn(s[i], scale_log2);
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = ex2(__fsub_rn(m[h], m_new));
        m[h] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(__fsub_rn(s[i], m[(i >> 1) & 1]));
        rs[(i >> 1) & 1] = __fadd_rn(rs[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), rs[h]);
#pragma unroll
      for (int pp = 0; pp < kNP; ++pp)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          o[pp][i] = __fmul_rn(o[pp][i], corr[(i >> 1) & 1]);

      // P (bf16) as the A fragment: keys 16kk..16kk+15 are the
      // accumulator's n8 blocks 2kk and 2kk + 1
      uint32_t pa[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int pp = 0; pp < kNP; ++pp) fence_regs(o[pp]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int pp = 0; pp < kNP; ++pp) {
          const unsigned va =
              v_s + st * kVBytes + pp * (kN * 128) + kk * (16 * 128);
          wgmma_rs_tb(o[pp], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                      pa[4 * kk + 3], make_desc(va, 1024, 1024));
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int pp = 0; pp < kNP; ++pp) fence_regs(o[pp]);
    }
    __syncthreads();               // stage st is free for tile t + 2
  }

  // out = acc / max(l, 1e-30): the row sum over the quad, then bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 2));
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r_hi : r_lo;
    if (row >= lq) continue;
    __nv_bfloat16* orow = out + ((long long)bh * lq + row) * dv;
#pragma unroll
    for (int pp = 0; pp < kNP; ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pp * 64 + 8 * j + c_lane;
        if (col >= dv) continue;
        const float x = __fdiv_rn(o[pp][4 * j + 2 * h], l[h]);
        const float y = __fdiv_rn(o[pp][4 * j + 2 * h + 1], l[h]);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x, y);
      }
  }
}

template <int DP, int DVP>
long long smem_bytes() {
  return 1024LL + kM * DP * 2 + 2LL * kN * DP * 2 + 2LL * kN * DVP * 2;
}

template <int DP, int DVP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int lq, int lk, int d, int dv, float scale, int causal,
           cudaStream_t stream) {
  const long long smem = smem_bytes<DP, DVP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP, DVP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, (lq + kM - 1) / kM);
  flash_attention_wgmma_kernel<DP, DVP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lq, lk, d, dv, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory (bytes) one CTA needs, the 1024-byte alignment slack
// included.
long long repro_flash_attention_wgmma_smem(int d, int dv) {
  if (d <= 64) return dv <= 64 ? smem_bytes<64, 64>() : smem_bytes<64, 128>();
  return dv <= 64 ? smem_bytes<128, 64>() : smem_bytes<128, 128>();
}

// q, k: [bh, lq | lk, d]; v: [bh, lk, dv]; out: [bh, lq, dv]; all bf16,
// 16-byte aligned; d, dv multiples of 16 in [16, 128]. Launches on
// `stream`; returns cudaGetLastError().
int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                void* out, int bh, int lq, int lk, int d,
                                int dv, float scale, int causal,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d <= 64) {
    if (dv <= 64)
      return launch<64, 64>(q, k, v, out, bh, lq, lk, d, dv, scale, causal,
                            st);
    return launch<64, 128>(q, k, v, out, bh, lq, lk, d, dv, scale, causal,
                           st);
  }
  if (dv <= 64)
    return launch<128, 64>(q, k, v, out, bh, lq, lk, d, dv, scale, causal,
                           st);
  return launch<128, 128>(q, k, v, out, bh, lq, lk, d, dv, scale, causal,
                          st);
}

}  // extern "C"
