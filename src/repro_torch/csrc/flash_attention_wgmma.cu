// Flash attention (online softmax, uncompensated) on the Hopper tensor
// cores (sm_90a): the routes of flash_attention.cu for head dims D and Dv
// that are multiples of 16 up to 128, bf16 (flash_attention_wgmma_kernel)
// and f32 (flash_attention_wgmma_f32_kernel, below); flash_attention.cu
// keeps other head dims.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py,
// `_flash_kernel` launched by `flash_attention_pallas`. The semantics are
// that file's (the Pallas kernel's): top-left causal q_pos >= k_pos, key
// tiles above the diagonal skipped, ragged Lq / Lk with key rows past Lk
// never read (zero-filled), masked scores the finite -1e30 and masked p
// exactly 0, m from -1e30, l and acc from 0, per key tile m_new = max(m,
// rowmax s), corr = exp(m - m_new), l = l * corr + sum p, acc = acc *
// corr + P V, and out = acc / max(l, 1e-30) in q's dtype. The score is
// multiplied by the scale after the product, as the reference does; the
// scale carries log2(e) so that exp(x) is 2^(x log2 e), taken by the
// hardware ex2 (ex2.approx.ftz, ~2 ulp), as flash kernels on this card
// do. l sums the f32 p.
//
// bf16: two roundings are new against the reference: p is rounded to
// bf16 as the A operand of the P V product (about one bf16 ulp of the
// output; the reference keeps p in f32), and the ex2. Both sit inside
// the bf16 tolerance of 2e-2: the parity cases read at most 1.56e-2,
// one bf16 ulp of an output in [2, 4).
//
// f32: every operand enters the tensor cores as exact bf16 planes (hi,
// mid, lo; wgmma_common.cuh), so no TF32 rounding: the reference's f32
// tolerance of 2e-5 holds (the parity cases read at most ~1.5e-6).
// Design notes and bound beside the kernel below.
//
// bf16 bound: operations. At the qwen1.5 prefill shape (BH = 64, L =
// 2048, D = 64, causal) the work is 34.4 GFLOP against 67 MB of traffic:
// 0.035 ms at the bf16 tensor-core rate of 989 TFLOP/s, 0.020 ms for
// the bytes (H100 SXM data sheet, 700 W).
//
// bf16 design: one CTA per (bh, 128 query rows), two consumer warpgroups of
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
// ptxas (sm_90a, -O3, CUDA 12.8), bf16: 120 / 144 / 117 / 148 registers
// for (D, Dv) padded to (64, 64) / (64, 128) / (128, 64) / (128, 128),
// no spills; the (64, 64) build keeps two CTAs per SM. SASS: 8 / 12 / 12
// / 16 HGMMA instructions, 48 in all (f32: below).

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
                      pa[4 * kk + 3], make_desc(va, 1024, 1024), 1);
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

// ------------------------------------------------------- the f32 route --
// f32 q / k / v (D, Dv multiples of 16 up to 128) as exact bf16 planes
// (hi, mid, lo: wgmma_common.cuh). Q is split once per CTA; each K / V
// tile of 64 keys arrives raw (f32, 16-byte cp.async, one tile ahead) and
// is split ONCE into its planes in shared memory, then serves every k16
// step of the CTA's rows (splitting per product was what bounded the
// matmul's f32 kernels). S = Q Kᵀ takes the six products q_i . k_j with
// i + j <= 2, smallest first, hi.hi in its own accumulator (the three
// dropped are at most ~2^-24 of |q . k| together); s = big + small,
// round-to-nearest. P (f32, in registers) is split into planes as the
// register-A operand and P V takes the same six products into fresh
// accumulators per key tile; acc = acc * corr + (big + small), rounded to
// nearest, as the reference's acc * corr + p @ v (the tensor core's
// accumulation is not round-to-nearest, so acc does not chain in it
// across tiles). The softmax is the bf16 route's (ex2 of the log2-scaled
// score, ~2 ulp), l and the output in f32. 128 query rows (two
// warpgroups) per CTA for D <= 64, 64 rows for D up to 128, so the planes
// fit in shared memory.
//
// f32 bound: operations. At the qwen1.5 prefill shape the six bf16
// passes are 206 GFLOP, 0.209 ms at 989 TFLOP/s (the f32 CUDA cores
// would need 0.513 ms for the 34.4 GFLOP). Its time and SDPA f32's are
// in PERF.md.
//
// ptxas (sm_90a, -O3, CUDA 12.8), f32: 208-255 registers over the four
// (D, Dv) builds, no spills; 288 HGMMA instructions.
template <int DP>
__host__ __device__ constexpr int f32_rows() {
  return DP == 64 ? 128 : 64;
}

template <int DP, int DVP>
__host__ __device__ constexpr long long f32_smem_bytes() {
  constexpr int kMF = f32_rows<DP>();
  return 1024LL + 3LL * kMF * DP * 2 + 3LL * kN * DP * 2 +
         3LL * kN * DVP * 2 + 4LL * kN * (DP + DVP);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(f32_rows<DP>() * 2, 1)
flash_attention_wgmma_f32_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out, int lq, int lk,
                                 int d, int dv, float scale_log2,
                                 int causal) {
  constexpr int kMF = f32_rows<DP>();
  constexpr int kT = kMF * 2;            // threads: one warpgroup / 64 rows
  constexpr int kNP = DVP / 64;          // 64-wide panels of Dv
  constexpr int kQPl = kMF * DP * 2;     // bytes of one Q plane
  constexpr int kKPl = kN * DP * 2;      // one K plane
  constexpr int kVPl = kN * DVP * 2;     // one V plane
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned q_s = (raw + 1023u) & ~1023u;
  const unsigned k_s = q_s + 3 * kQPl;
  const unsigned v_s = k_s + 3 * kKPl;
  const unsigned kr_s = v_s + 3 * kVPl;            // raw K [kN][DP] f32
  const unsigned vr_s = kr_s + 4 * kN * DP;        // raw V [kN][DVP] f32

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kMF;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qw = q0 + 64 * wg;
  const float* qb = q + (long long)bh * lq * d;
  const float* kb = k + (long long)bh * lk * d;
  const float* vb = v + (long long)bh * lk * dv;

  int tiles = (lk + kN - 1) / kN;
  if (causal) tiles = min(tiles, (min(q0 + kMF, lq) - 1) / kN + 1);
  int wg_tiles = 0;
  if (qw < lq) {
    wg_tiles = tiles;
    if (causal) wg_tiles = min(tiles, (min(qw + 64, lq) - 1) / kN + 1);
  }

  // raw f32 rows [row0, row0 + kN) of an [L, D] matrix, zero past L and D
  auto stage_raw = [&](unsigned dst, const float* src, int row0, int L,
                       int D, int DPAD) {
    const int chunks = DPAD / 4;
    for (int i = tid; i < kN * chunks; i += kT) {
      const int t = i / chunks, c4 = i - t * chunks;
      const bool ok = row0 + t < L && 4 * c4 < D;
      cp_async16_zfill(dst + (t * DPAD + 4 * c4) * 4,
                       ok ? src + (long long)(row0 + t) * D + 4 * c4 : src,
                       ok ? 16 : 0);
    }
  };
  // split rows of a raw f32 tile into swizzled planes (panel-major)
  auto split_tile = [&](unsigned dst, unsigned src, int rows, int DPAD,
                        int plane) {
    const int chunks = DPAD / 8;
    for (int i = tid; i < rows * chunks; i += kT) {
      const int t = i / chunks, c8 = i - t * chunks;
      uint32_t w[8];
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                   : "r"(src + (t * DPAD + 8 * c8) * 4));
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[4]), "=r"(w[5]), "=r"(w[6]), "=r"(w[7])
                   : "r"(src + (t * DPAD + 8 * c8) * 4 + 16));
      store_planes<POOL_F32>(
          w, dst + (c8 >> 3) * (rows * 128) + t * 128 +
                 (((c8 & 7) ^ (t & 7)) << 4),
          plane);
    }
  };

  // Q: straight from global memory into its planes, once
  for (int i = tid; i < kMF * (DP / 8); i += kT) {
    const int t = i / (DP / 8), c8 = i - t * (DP / 8);
    uint32_t w[8];
    const bool ok = q0 + t < lq && 8 * c8 < d;
    if (ok) {
      const uint4* p =
          reinterpret_cast<const uint4*>(qb + (long long)(q0 + t) * d + 8 * c8);
      const uint4 a = p[0], b = p[1];
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
      w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = 0u;
    }
    store_planes<POOL_F32>(w, q_s + (c8 >> 3) * (kMF * 128) + t * 128 +
                                  (((c8 & 7) ^ (t & 7)) << 4),
                           kQPl);
  }
  stage_raw(kr_s, kb, 0, lk, d, DP);
  stage_raw(vr_s, vb, 0, lk, dv, DVP);
  cp_async_commit();

  float o[kNP][32];
#pragma unroll
  for (int pp = 0; pp < kNP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pp][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  const int r_lo = qw + warp * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;
  const int c_lane = 2 * (lane & 3);

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();             // tile t's raw rows landed; planes free
    split_tile(k_s, kr_s, kN, DP, kKPl);
    split_tile(v_s, vr_s, kN, DVP, kVPl);
    fence_proxy_async();
    __syncthreads();             // planes written; the raw slot is free
    if (t + 1 < tiles) {
      stage_raw(kr_s, kb, (t + 1) * kN, lk, d, DP);
      stage_raw(vr_s, vb, (t + 1) * kN, lk, dv, DVP);
      cp_async_commit();
    }
    if (t >= wg_tiles) continue;
    const int k0 = t * kN;

    // S = Q Kᵀ: six plane products per k16 step, smallest first
    float sb[32], ss[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sb[i] = ss[i] = 0.0f;
    fence_regs(sb);
    fence_regs(ss);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint64_t dq[3], dk[3];
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        dq[pl] = make_desc(q_s + pl * kQPl + (kk >> 2) * (kMF * 128) +
                               wg * (64 * 128) + (kk & 3) * 32,
                           16, 1024);
        dk[pl] = make_desc(k_s + pl * kKPl + (kk >> 2) * (kN * 128) +
                               (kk & 3) * 32,
                           16, 1024);
      }
      wgmma_ss(ss, dq[2], dk[0], kk > 0);
      wgmma_ss(ss, dq[1], dk[1], 1);
      wgmma_ss(ss, dq[0], dk[2], 1);
      wgmma_ss(ss, dq[1], dk[0], 1);
      wgmma_ss(ss, dq[0], dk[1], 1);
      wgmma_ss(sb, dq[0], dk[0], kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sb);
    fence_regs(ss);

    const bool need_mask = k0 + kN > lk || (causal && k0 + kN - 1 > qw);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * j + u;
        float x = __fmul_rn(__fadd_rn(sb[i], ss[i]), scale_log2);
        if (need_mask) {
          const int kp = k0 + 8 * j + c_lane + (u & 1);
          const int qp = (u >> 1) ? r_hi : r_lo;
          if (kp >= lk || (causal && qp < kp)) x = kNegInf;
        }
        sb[i] = x;
        mx[u >> 1] = fmaxf(mx[u >> 1], x);
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
      sb[i] = ex2(__fsub_rn(sb[i], m[(i >> 1) & 1]));
      rs[(i >> 1) & 1] = __fadd_rn(rs[(i >> 1) & 1], sb[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), rs[h]);

    // P planes as register-A fragments (keys 16kk..16kk+15)
    uint32_t pa[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i0 = 8 * kk + 4 * (e >> 1) + 2 * (e & 1);
        float h0, m0, o0, h1, m1, o1;
        split3(sb[i0], h0, m0, o0);
        split3(sb[i0 + 1], h1, m1, o1);
        pa[0][kk][e] = pack_bf16(h0, h1);
        pa[1][kk][e] = pack_bf16(m0, m1);
        pa[2][kk][e] = pack_bf16(o0, o1);
      }
    // O = O * corr + P V, per 64-wide panel of Dv
#pragma unroll
    for (int pp = 0; pp < kNP; ++pp) {
      float pb[32], ps[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pb[i] = ps[i] = 0.0f;
      fence_regs(pb);
      fence_regs(ps);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint64_t dvd[3];
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          dvd[pl] = make_desc(v_s + pl * kVPl + pp * (kN * 128) +
                                  kk * (16 * 128),
                              1024, 1024);
        const uint32_t* hi = pa[0][kk];
        const uint32_t* mi = pa[1][kk];
        const uint32_t* lo = pa[2][kk];
        wgmma_rs_tb(ps, lo[0], lo[1], lo[2], lo[3], dvd[0], kk > 0);
        wgmma_rs_tb(ps, mi[0], mi[1], mi[2], mi[3], dvd[1], 1);
        wgmma_rs_tb(ps, hi[0], hi[1], hi[2], hi[3], dvd[2], 1);
        wgmma_rs_tb(ps, mi[0], mi[1], mi[2], mi[3], dvd[0], 1);
        wgmma_rs_tb(ps, hi[0], hi[1], hi[2], hi[3], dvd[1], 1);
        wgmma_rs_tb(pb, hi[0], hi[1], hi[2], hi[3], dvd[0], kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(pb);
      fence_regs(ps);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[pp][i] = __fadd_rn(__fmul_rn(o[pp][i], corr[(i >> 1) & 1]),
                             __fadd_rn(pb[i], ps[i]));
    }
  }

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
    float* orow = out + ((long long)bh * lq + row) * dv;
#pragma unroll
    for (int pp = 0; pp < kNP; ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pp * 64 + 8 * j + c_lane;
        if (col >= dv) continue;
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(__fdiv_rn(o[pp][4 * j + 2 * h], l[h]),
                        __fdiv_rn(o[pp][4 * j + 2 * h + 1], l[h]));
      }
  }
}

template <int DP, int DVP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int lq, int lk, int d, int dv, float scale, int causal,
               cudaStream_t stream) {
  constexpr long long smem = f32_smem_bytes<DP, DVP>();
  constexpr int kMF = f32_rows<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_f32_kernel<DP, DVP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, (lq + kMF - 1) / kMF);
  flash_attention_wgmma_f32_kernel<DP, DVP><<<grid, kMF * 2, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lq, lk, d, dv,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
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

// The f32 route: q, k: [bh, lq | lk, d]; v: [bh, lk, dv]; out: [bh, lq,
// dv]; all f32, 16-byte aligned; d, dv multiples of 16 in [16, 128].
long long repro_flash_attention_wgmma_f32_smem(int d, int dv) {
  if (d <= 64)
    return dv <= 64 ? f32_smem_bytes<64, 64>() : f32_smem_bytes<64, 128>();
  return dv <= 64 ? f32_smem_bytes<128, 64>() : f32_smem_bytes<128, 128>();
}

// Query rows per CTA of the f32 route for head dim d.
int repro_flash_attention_wgmma_f32_rows(int d) {
  return d <= 64 ? f32_rows<64>() : f32_rows<128>();
}

int repro_flash_attention_wgmma_f32(const void* q, const void* k,
                                    const void* v, void* out, int bh, int lq,
                                    int lk, int d, int dv, float scale,
                                    int causal, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d <= 64) {
    if (dv <= 64)
      return launch_f32<64, 64>(q, k, v, out, bh, lq, lk, d, dv, scale,
                                causal, st);
    return launch_f32<64, 128>(q, k, v, out, bh, lq, lk, d, dv, scale,
                               causal, st);
  }
  if (dv <= 64)
    return launch_f32<128, 64>(q, k, v, out, bh, lq, lk, d, dv, scale,
                               causal, st);
  return launch_f32<128, 128>(q, k, v, out, bh, lq, lk, d, dv, scale, causal,
                              st);
}

}  // extern "C"
