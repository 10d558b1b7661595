// Flash attention (online softmax, uncompensated) on the Hopper tensor
// cores (sm_90a), every head dim D, Dv in [1, 128]: bf16
// (flash_attention_wgmma_kernel) and f32 (flash_attention_wgmma_f32_kernel,
// below). Head dims are padded with exact zeros to a 64-wide panel (D, Dv
// <= 64) or two: a padded column adds +0 to every score and yields an
// output column that is never stored. Every k16 step of the padded
// panels runs: a runtime skip of the steps wholly past D (D = 40 needs 3
// of a panel's 4) made ptxas inject warpgroup.arrive fences around the
// products (C7519), and D = 40 ran no faster with it (PERF.md).
//
// Rows of any D start aligned to the element size only, so the loaders
// copy as wide as every row's alignment allows (copy_width: 16, 8 or 4
// bytes by cp.async, zero-filled past Lk and D); bf16 rows of odd D
// (2-byte aligned) are staged by plain loads and 16-byte shared stores,
// which wait for their loads and so lose the ring's overlap. The stores
// write pairs where Dv is even and single elements where it is odd, so
// no byte past Dv is written.
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
// two-stage ring in shared memory filled by cp.async (zero-fill past Lk
// and past D / Dv), issued one tile ahead of the compute. All
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
// ptxas (sm_90a, -O3, CUDA 12.8), bf16: 117 / 145 / 117 / 150 registers
// for (D, Dv) padded to (64, 64) / (64, 128) / (128, 64) / (128, 128)
// in the ALIGNED builds (127 / 167 / 128 / 174 in the general ones), no
// spills; the (64, 64) builds keep two CTAs per SM. SASS: 96 HGMMA
// instructions over the eight builds (f32: below).

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

// cp.async of W bytes (4, 8 or 16; src and dst W-aligned), zero-filled
// past `bytes` (0 or W)
template <int W>
__device__ __forceinline__ void cp_async_zfill(unsigned dst, const void* src,
                                               int bytes) {
  if constexpr (W == 16) {
    cp_async16_zfill(dst, src, bytes);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(W), "r"(bytes)
                 : "memory");
  }
}

// The widest copy (16, 8, 4 or 2 bytes) that every row of an [*, D]
// matrix of `esize`-byte elements at `p` starts aligned to.
int copy_width(const void* p, int d, int esize) {
  int w = 16;
  while (w > esize &&
         ((reinterpret_cast<uintptr_t>(p) | (uintptr_t)d * esize) % w))
    w /= 2;
  return w;
}

// One thread's 16-byte chunks of the tile (rows r, r + kRowsPer, ...) by
// copies of W bytes; a copy lies wholly inside or wholly past D, as every
// row starts W-aligned and D is a whole number of W-byte copies.
template <int W, int R, int kRowsPer>
__device__ __forceinline__ void stage_chunks(unsigned at,
                                             const __nv_bfloat16* from,
                                             const __nv_bfloat16* src,
                                             int col, int rows_left, int D) {
  constexpr int kE = W / 2;        // elements per copy
#pragma unroll
  for (int j = 0; j < R / kRowsPer; ++j)
#pragma unroll
    for (int i = 0; i < 16 / W; ++i) {
      const bool ok = j * kRowsPer < rows_left && col + i * kE < D;
      cp_async_zfill<W>(at + j * kRowsPer * 128 + i * W,
                        ok ? from + (long long)j * kRowsPer * D + i * kE
                           : src,
                        ok ? W : 0);
    }
}

// Stage rows [row0, row0 + R) of a [L, D] bf16 matrix into the swizzled
// panels at `dst` (shared address): panel p (columns 64p..64p+63) is
// R x 128 bytes; rows past L and columns past D are zero-filled, never
// read, so the padded k16 steps add exact zeros. Rows start w-aligned
// (copy_width): by cp.async of w bytes, or for odd D (2-byte rows) by
// plain loads and 16-byte shared stores, which wait for their loads.
// ALIGNED builds (every row 16-byte aligned) keep the 16-byte path only.
template <int R, int DP, bool ALIGNED>
__device__ __forceinline__ void stage_tile(unsigned dst,
                                           const __nv_bfloat16* src,
                                           int row0, int L, int D, int w) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per padded row
  constexpr int kRowsPer = kThreads / kChunks;    // rows of one pass
  static_assert(R % kRowsPer == 0 && kRowsPer % 8 == 0,
                "a thread keeps its chunk column and its swizzle phase");
  const int cg = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const unsigned at =
      dst + (cg >> 3) * (R * 128) + r0 * 128 + (((cg & 7) ^ (r0 & 7)) << 4);
  const int col = cg * 8;
  const int rows_left = L - row0 - r0;
  const __nv_bfloat16* from = src + (long long)(row0 + r0) * D + col;
  if (ALIGNED || w == 16) {
    stage_chunks<16, R, kRowsPer>(at, from, src, col, rows_left, D);
  } else if (w == 8) {
    stage_chunks<8, R, kRowsPer>(at, from, src, col, rows_left, D);
  } else if (w == 4) {
    stage_chunks<4, R, kRowsPer>(at, from, src, col, rows_left, D);
  } else {
    const unsigned short* f = reinterpret_cast<const unsigned short*>(from);
#pragma unroll
    for (int j = 0; j < R / kRowsPer; ++j) {
      const bool row_ok = j * kRowsPer < rows_left;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const long long o = (long long)j * kRowsPer * D + e;
        const uint32_t lo =
            row_ok && col + e < D ? __ldg(f + o) : 0u;
        const uint32_t hi =
            row_ok && col + e + 1 < D ? __ldg(f + o + 1) : 0u;
        v[e / 2] = lo | (hi << 16);
      }
      st_shared4(at + j * kRowsPer * 128, v[0], v[1], v[2], v[3]);
    }
  }
}

template <int DP, int DVP, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, DVP == 64 ? 2 : 1)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ out, int lq, int lk,
                             int d, int dv, float scale_log2, int causal,
                             int wq, int wk, int wv) {
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

  stage_tile<kM, DP, ALIGNED>(q_s, qb, q0, lq, d, wq);
  stage_tile<kN, DP, ALIGNED>(k_s, kb, 0, lk, d, wk);
  stage_tile<kN, DVP, ALIGNED>(v_s, vb, 0, lk, dv, wv);
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
      stage_tile<kN, DP, ALIGNED>(k_s + (st ^ 1) * kKBytes, kb, k1, lk, d,
                                  wk);
      stage_tile<kN, DVP, ALIGNED>(v_s + (st ^ 1) * kVBytes, vb, k1, lk, dv,
                                   wv);
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
        if (ALIGNED || dv % 2 == 0) {   // col, col + 1 real, 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x, y);
        } else {                     // odd Dv: no byte past it is written
          orow[col] = __float2bfloat16_rn(x);
          if (col + 1 < dv) orow[col + 1] = __float2bfloat16_rn(y);
        }
      }
  }
}

// raw f32 rows [row0, row0 + kN) of an [L, D] matrix into a [kN][DPAD]
// tile, zero past L and D, by cp.async of W bytes (every row starts
// W-aligned: copy_width), the CTA's kT threads in turn
template <int W, int kT>
__device__ __forceinline__ void stage_raw_w(unsigned dst, const float* src,
                                            int row0, int L, int D,
                                            int DPAD, int tid) {
  constexpr int kE = W / 4;        // elements per copy
  const int chunks = DPAD / kE;
  for (int i = tid; i < kN * chunks; i += kT) {
    const int t = i / chunks, c = (i - t * chunks) * kE;
    const bool ok = row0 + t < L && c < D;
    cp_async_zfill<W>(dst + (t * DPAD + c) * 4,
                      ok ? src + (long long)(row0 + t) * D + c : src,
                      ok ? W : 0);
  }
}

// ------------------------------------------------------- the f32 route --
// f32 q / k / v (D, Dv up to 128) as exact bf16 planes
// (hi, mid, lo: wgmma_common.cuh). Q is split once per CTA; each K / V
// tile of 64 keys arrives raw (f32, cp.async, one tile ahead) and
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
// ptxas (sm_90a, -O3, CUDA 12.8), f32: 208-255 registers over the eight
// builds, no spills; 576 HGMMA instructions.
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

template <int DP, int DVP, bool ALIGNED>
__global__ void __launch_bounds__(f32_rows<DP>() * 2, 1)
flash_attention_wgmma_f32_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out, int lq, int lk,
                                 int d, int dv, float scale_log2,
                                 int causal, int wq, int wk, int wv) {
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

  auto stage_raw = [&](unsigned dst, const float* src, int row0, int L,
                       int D, int DPAD, int w) {
    if (ALIGNED || w == 16) {
      stage_raw_w<16, kT>(dst, src, row0, L, D, DPAD, tid);
    } else if (w == 8) {
      stage_raw_w<8, kT>(dst, src, row0, L, D, DPAD, tid);
    } else {
      stage_raw_w<4, kT>(dst, src, row0, L, D, DPAD, tid);
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
    const float* p = qb + (long long)(q0 + t) * d + 8 * c8;
    if (ok && (ALIGNED || wq == 16) && 8 * c8 + 8 <= d) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[0];
      const uint4 b = reinterpret_cast<const uint4*>(p)[1];
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
      w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    } else {                     // a row's last chunk, or rows not 16-aligned
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e] = ok && 8 * c8 + e < d ? __float_as_uint(p[e]) : 0u;
    }
    store_planes<POOL_F32>(w, q_s + (c8 >> 3) * (kMF * 128) + t * 128 +
                                  (((c8 & 7) ^ (t & 7)) << 4),
                           kQPl);
  }
  stage_raw(kr_s, kb, 0, lk, d, DP, wk);
  stage_raw(vr_s, vb, 0, lk, dv, DVP, wv);
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
      stage_raw(kr_s, kb, (t + 1) * kN, lk, d, DP, wk);
      stage_raw(vr_s, vb, (t + 1) * kN, lk, dv, DVP, wv);
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
        const float x = __fdiv_rn(o[pp][4 * j + 2 * h], l[h]);
        const float y = __fdiv_rn(o[pp][4 * j + 2 * h + 1], l[h]);
        if (ALIGNED || dv % 2 == 0) {   // col, col + 1 real, 8-byte aligned
          *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
        } else {                     // odd Dv: no byte past it is written
          orow[col] = x;
          if (col + 1 < dv) orow[col + 1] = y;
        }
      }
  }
}

// Every row of q, k and v 16-byte aligned: the ALIGNED build. The general
// build gives the same bits on such rows and runs 2-4% slower at D = 64
// and 40 (its loaders' width branches; tools/flash_aligned_ab.py, NVIDIA
// H100 80GB HBM3, 700 W).
bool all_aligned(int wq, int wk, int wv) {
  return wq == 16 && wk == 16 && wv == 16;
}

template <int DP, int DVP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int lq, int lk, int d, int dv, float scale, int causal,
               cudaStream_t stream) {
  constexpr long long smem = f32_smem_bytes<DP, DVP>();
  constexpr int kMF = f32_rows<DP>();
  const int wq = copy_width(q, d, 4), wk = copy_width(k, d, 4),
            wv = copy_width(v, dv, 4);
  auto kernel = all_aligned(wq, wk, wv)
                    ? flash_attention_wgmma_f32_kernel<DP, DVP, true>
                    : flash_attention_wgmma_f32_kernel<DP, DVP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, (lq + kMF - 1) / kMF);
  kernel<<<grid, kMF * 2, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lq, lk, d, dv,
      scale * kLog2e, causal, wq, wk, wv);
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
  const int wq = copy_width(q, d, 2), wk = copy_width(k, d, 2),
            wv = copy_width(v, dv, 2);
  auto kernel = all_aligned(wq, wk, wv)
                    ? flash_attention_wgmma_kernel<DP, DVP, true>
                    : flash_attention_wgmma_kernel<DP, DVP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, (lq + kM - 1) / kM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lq, lk, d, dv, scale * kLog2e, causal, wq, wk, wv);
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

// q, k: [bh, lq | lk, d]; v: [bh, lk, dv]; out: [bh, lq, dv]; all bf16;
// d, dv in [1, 128], any alignment of the element type (the loaders copy
// as wide as the rows' alignment allows). Launches on `stream`; returns
// cudaGetLastError().
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
// dv]; all f32; d, dv in [1, 128], any alignment of the element type.
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
