// Matmul with compensated K-block accumulation for Hopper (sm_90a):
// C = A @ B and C = A @ dequant(qw).
//
// Replaces the TPU kernels of repro/kernels/kahan_matmul.py:
// `_kahan_matmul_kernel` (launched by `kahan_matmul`) and
// `_kahan_matmul_q8_kernel` (launched by `kahan_matmul_q8`). For every
// output element the K axis is cut into blocks of bk; each block's
// partial dot is an ordinary f32 sum (the TPU's MXU partial), and the
// partials are folded into a Neumaier (sum, carry) pair in block order
// (twosum, then __fadd_rn on the carry: no contraction). The result is
// sum + carry in f32. The compensation works ACROSS the blocks, so both
// routes fold at exactly the reference's bk (the result depends on bk;
// the reference's bm / bn change no number and play no part here).
//
// q8 form: B is an int8 or fp8 (e4m3 bytes in u8) payload [K, N] with
// f32 scales [K / bk, N]; each block partial is multiplied by its
// (block, column) scale as its own rounding (__fmul_rn) before the
// fold. fp8 widens through the bit trick of repro.quant.core.e4m3_to_f32
// (superkernel_common.cuh), as `dequantize_weight` does.
//
// Two routes, picked by the wrapper by M (kernels/kahan_matmul.py):
//
// Route T (tile), M > 64: wgmma on the bf16 tensor cores. There is no
// f32 x f32 wgmma that keeps f32 accuracy (TF32 keeps 10 mantissa bits),
// so each operand enters the tensor cores as exact bf16 PLANES
// (wgmma_common.cuh: one plane for bf16 and 8-bit payloads, hi / mid /
// lo for f32, hi + mid + lo == x). Every bf16 x bf16 product is exact in
// f32, so the products the kernel issues per k16 step are:
//   bf16 A, bf16 or 8-bit B: a.b (1 pass);
//   f32 A with a one-plane B (or bf16 A with f32 B): lo.b, mid.b, hi.b
//   (3 passes), every product of the exact split, nothing dropped;
//   f32 A and f32 B: the six a_i.b_j with i + j <= 2, smallest first:
//   lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi (6 passes). The three
//   dropped (mid.lo, lo.mid, lo.lo) are at most ~2^-24 of |a.b|
//   together, under one f32 rounding of the product, so below the
//   reference's own in-block rounding.
// The tensor core's own f32 accumulation does not round to nearest, and
// chained over a block its error grows with the chain. So with planes,
// the products smaller than hi.hi go to a "small" accumulator, and hi.hi
// to a "big" one that restarts (scale-d = 0) at every k16 step: each
// step's hi.hi is added round-to-nearest (__fadd_rn) into the block's sum
// in registers. At each block end the partial is that sum + small,
// rounded to nearest, times the scale (q8), then the fold. On the deep
// K = 2^14 case (kahan_matmul.deep_case(72), bk = 128) the max error was
// 2.24x the reference's with hi.hi chained over the block (8 steps);
// runs of 4, 2 and 1 steps gave 1.15x, 0.91x and 0.78x, at 1.01, 1.05
// and 1.10 times the f32 time and 1.02, 1.10 and 1.22 times the f32 x
// int8 time at the qwen1.5 down projection (tools/kahan_hi_run.py, which
// patches the runs back into a copy of this file; one call, NVIDIA H100
// 80GB HBM3, 700 W). Accuracy comes first: runs of one step.
// One-plane operands (bf16 x bf16, bf16 x 8-bit) keep one accumulator
// chained over the block, as a bf16 matmul does.
//
// Design of route T: one CTA per output tile of 128 rows, two consumer
// warpgroups of 64 rows, A K-major and B MN-major (row-major [K, N])
// from shared memory, planes in the 128-byte swizzle of
// wgmma_common.cuh. K advances in stages of four k16 steps over a
// PADDED K axis: each block of bk is padded with zeros to the next 16,
// so a block ends on a k16 step (bk need not be a multiple of 16), and
// rows past M, columns past N are zero-filled too. Three ways to stage
// a tile:
// * bf16 A and B (bk a multiple of 64, rows of 16-byte multiples, 16-
//   byte aligned): 128-wide tiles (m64n128k16) fed by TMA straight into
//   the swizzled planes, a four-slot ring, the boxes two stages ahead
//   and one stage's products still in flight while the next is issued.
//   64 accumulators and 64 sums per thread leave no room for 64
//   carries in registers (they spilled), so this kernel keeps its
//   carries in shared memory, each thread its own. A 64-wide tile fed
//   the same way, its carries in registers, took 0.0578 ms against
//   0.0424 / 0.0423 for this one at the qwen1.5 down projection
//   (chip_smoke.py times phase, one call, NVIDIA H100 80GB HBM3, 700 W).
// * every other type pair so aligned: 64-wide tiles; TMA brings the raw
//   tiles three stages deep, and every thread splits or widens its
//   chunks into the bf16 planes (st.shared), during the products of the
//   stage before where two plane slots fit in shared memory (all but f32
//   x f32 and f32 x bf16: one slot, converted after the products).
// * any other shape (bk not a multiple of 64, odd widths, unaligned):
//   64-wide tiles loaded by ld.global into registers one stage ahead,
//   each thread's positions on the padded axis advanced without a
//   division.
// The sums, and the carries of the 64-wide tiles, stay in registers.
// What bounds it (clock64 counters of the loop on the card, at the
// qwen1.5 down projection): for bf16 the fold every fourth stage (the
// wait for the block's products, 64 TwoSums and 64 carries through
// shared memory per thread) outweighs the products; for the f32 pairs
// the split into planes, bound by shared-memory traffic rather than by
// conversion instructions (an integer-only split measured the same).
//
// Route S (split), M <= 64 (a decode batch): the fold is a chain over K
// blocks, but no block's partial depends on another. So the grid is
// (column tiles of 64, K blocks, groups of 8 rows): at [8, 2816] x
// [2816, 1024], bk 256, that is 16 x 11 = 176 CTAs instead of 16. Each
// CTA stages its block's weight tile raw in chunks of 16 KB (16-byte
// loads, four per thread, all in flight before the first use) and
// computes the block's [8, 64] partial on the CUDA cores (at M = 8 the
// bytes bound the route, not the operations): each thread takes 4
// adjacent columns and all 8 rows over one contiguous K slice, FMA
// chains in k order, then the slices' sums add in slice order; times
// the scale in q8, into an f32 workspace [nk, M, N] (360 KB at that
// shape). A batch of 9 to 64 rows takes one row group per 8 rows, each
// reading the weight tile again (from L2 after the first): no measured
// workload has such a batch, so no wider build. A second, small
// kernel then folds each output's partials in block order 0 .. nk - 1:
// given the same partials this is bitwise the serial fold, not a
// `combine` of independent pairs. A second kernel rather than a
// last-arriving CTA per column tile: no ticket array to zero per call
// (itself a launch), no fence-ordered handoff, and the fold reads the
// workspace from L2.
//
// Bounds (H100 SXM data sheet, 700 W): route T by operations, P bf16
// passes x 2 M N K at 989 TFLOP/s plus the fold's f32 flops at 67
// TFLOP/s; at the qwen1.5 down projection ([2048, 2816] x [2816, 1024],
// bk 256) 0.0144 ms (bf16, P = 1), 0.074 ms (f32, P = 6), 0.0385 ms (f32
// x 8-bit, P = 3). Route S by bytes: [8, 2816] x int8 [2816, 1024] moves
// 3.05 MB, 0.0009 ms at 3.35 TB/s.
//
// ptxas (sm_90a, -O3, CUDA 12.8), 25 kernels: route T 151-255 registers
// (the bf16 TMA kernel 224; the plane kernels, with the run sum, 212-255),
// route S 80-91, the fold kernel 32; no stack frame (so no spill) in any.
// chip_smoke.py's build phase reads them from the built library
// (cuobjdump -res-usage) and fails on a spill.

#include <cuda.h>

#include "superkernel_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 128;                 // route T: rows per CTA
constexpr int kKS = 4;                   // route T: k16 steps per stage
constexpr int kAPlane = kTM * 128;       // 128 rows x 64 bf16: 16 KB
constexpr int kBPlane = 64 * 128;        // 64 K rows x 64 bf16: 8 KB
constexpr int kSN = 64;                  // route S: columns per CTA
constexpr int kSM = 8;                   // route S: rows per CTA

// BYTES (8, 16 or 32) bytes of elements of size E from element i0 of
// `base`: the first n_ok elements, zeros past them. One or two vector
// loads when all are valid and the address is aligned, else element by
// element.
template <int E, int BYTES>
__device__ __forceinline__ void load_vec(uint32_t (&w)[BYTES / 4],
                                         const void* base, long long i0,
                                         int n_ok) {
  constexpr int kN = BYTES / E;
  const char* p = static_cast<const char*>(base) + i0 * E;
  const uintptr_t align = BYTES >= 16 ? 15 : BYTES - 1;
  if (n_ok >= kN && (reinterpret_cast<uintptr_t>(p) & align) == 0) {
    if constexpr (BYTES == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int h = 0; h < BYTES / 16; ++h) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[h];
        w[4 * h + 0] = v.x;
        w[4 * h + 1] = v.y;
        w[4 * h + 2] = v.z;
        w[4 * h + 3] = v.w;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < BYTES / 4; ++i) w[i] = 0u;
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (e < n_ok) {
      uint32_t v;
      if constexpr (E == 4)
        v = reinterpret_cast<const uint32_t*>(p)[e];
      else if constexpr (E == 2)
        v = reinterpret_cast<const unsigned short*>(p)[e];
      else
        v = reinterpret_cast<const unsigned char*>(p)[e];
      w[(e * E) / 4] |= v << (8 * ((e * E) % 4));
    }
  }
}

// Where padded K index kp sits: block j, offset o; the element's real K
// index is j * bk + o and it is real iff j < nk and o < bk.
struct KPos {
  int j, o;
};

__device__ __forceinline__ KPos kpos(int kp, int bkp) {
  const int j = kp / bkp;
  return {j, kp - j * bkp};
}

// ------------------------------------------------ route T (tile, wgmma) --

// How a stage reaches its swizzled bf16 planes:
enum Staging : int {
  STAGE_REGS = 0,   // 16-byte ld.global into registers one stage ahead,
                    // split / widened, st.shared (any shape, any type)
  STAGE_TMA = 1,    // bf16 A and B by TMA straight into the planes
  STAGE_RAW = 2     // raw tiles by TMA, split / widened from shared
                    // memory into the planes
};

struct TileGeom {
  int m, n, k, bk, bkp, nk, row0, col0;
};

// A chunk q of this thread: rows r + 32 q, 8 K elements from padded
// position p (c8 = tid % 8, r = tid / 8). Returns the number of real
// elements (contiguous from the first) and their element offset.
__device__ __forceinline__ int a_chunk(const TileGeom& g, const KPos& p,
                                       int q, long long& off) {
  const int gr = g.row0 + (threadIdx.x >> 3) + 32 * q;
  const int ok = (gr < g.m && p.j < g.nk) ? max(0, min(8, g.bk - p.o)) : 0;
  off = ok ? static_cast<long long>(gr) * g.k + p.j * g.bk + p.o : 0;
  return ok;
}

// B chunk: K row at padded position p, columns col0 + 8 c8
__device__ __forceinline__ int b_chunk(const TileGeom& g, const KPos& p,
                                       long long& off) {
  const int col = g.col0 + 8 * (threadIdx.x & 7);
  const int ok = (p.j < g.nk && p.o < g.bk) ? max(0, min(8, g.n - col)) : 0;
  off = ok ? static_cast<long long>(p.j * g.bk + p.o) * g.n + col : 0;
  return ok;
}

// p advanced by d (>= 0) along the padded K axis, without a division
__device__ __forceinline__ KPos kadd(KPos p, int d, int bkp) {
  p.o += d;
  while (p.o >= bkp) {
    p.o -= bkp;
    ++p.j;
  }
  return p;
}

// The padded-K positions of this thread's chunks in the next stage to
// load: a for its A chunks (8 c8 into the stage), b for its first B
// chunk (K row r = tid / 8); B chunk q sits 32 q rows further. Stages
// load in order, so both advance by a stage without a division.
struct Cursors {
  KPos a, b;
  __device__ __forceinline__ void init(int bkp) {
    a = kpos(8 * (threadIdx.x & 7), bkp);
    b = kpos(threadIdx.x >> 3, bkp);
  }
  __device__ __forceinline__ KPos bq(int q, int bkp) const {
    return q ? kadd(b, 32 * q, bkp) : b;
  }
  __device__ __forceinline__ void next(int bkp) {
    a = kadd(a, kKS * 16, bkp);
    b = kadd(b, kKS * 16, bkp);
  }
};

// byte offsets of those chunks in a swizzled plane
__device__ __forceinline__ unsigned a_dst(int q) {
  const int c8 = threadIdx.x & 7, r = threadIdx.x >> 3;
  return (r + 32 * q) * 128 + ((c8 ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned b_dst(int q) {
  const int c8 = threadIdx.x & 7, r = threadIdx.x >> 3;
  return (r + 32 * q) * 128 + ((c8 ^ (r & 7)) << 4);
}

template <int T>
__device__ __forceinline__ void ld_shared_raw(uint32_t (&w)[2 * esize<T>()],
                                              unsigned addr) {
  if constexpr (esize<T>() == 1) {
    asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1])
                 : "r"(addr));
  } else {
#pragma unroll
    for (int h = 0; h < esize<T>() / 2; ++h)
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[4 * h]), "=r"(w[4 * h + 1]), "=r"(w[4 * h + 2]),
                     "=r"(w[4 * h + 3])
                   : "r"(addr + 16 * h));
  }
}

template <int AT, int BT, int S>
struct TileCfg {
  static constexpr int PA = planes<AT>(), PB = planes<BT>();
  static constexpr int NB = S == STAGE_TMA ? 2 : 1;   // 64-wide N panels
  static constexpr int TN = 64 * NB;
  static constexpr int kPlanes = PA * kAPlane + PB * NB * kBPlane;
  static constexpr int kRawA = kTM * 64 * esize<AT>();  // [128][64] raw
  static constexpr int kRawB = 64 * 64 * esize<BT>();   // [64][64] raw
  static constexpr int kRaw = kRawA + kRawB;
  // plane slots: four for STAGE_TMA (the ring itself), else two when
  // they fit beside three raw slots (STAGE_RAW), one otherwise
  static constexpr int kPlaneSlots =
      S == STAGE_TMA ? 4
      : S == STAGE_REGS ? 2
      : (3 * kRaw + 2 * kPlanes + 1024 <= 232448 ? 2 : 1);
  // the 128-wide tile keeps its Neumaier carries in shared memory (each
  // thread its own, so no barrier guards them): in registers beside the
  // 64 accumulators and 64 sums per thread they spill
  static constexpr bool kCarrySmem = NB == 2;
  static constexpr int kCarryOffset =
      kPlaneSlots * kPlanes + (S == STAGE_RAW ? 3 * kRaw : 0);
  static constexpr int kBarOffset =
      kCarryOffset + (kCarrySmem ? kTM * TN * 4 : 0);
  static constexpr int kBars = S == STAGE_TMA ? 4 : S == STAGE_RAW ? 3 : 0;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * kBars;
};

template <int AT, int BT, int S>
__global__ void __launch_bounds__(kThreads, 1)
kahan_matmul_tile_kernel(const void* __restrict__ a,
                         const void* __restrict__ b,
                         const float* __restrict__ scales,
                         float* __restrict__ out, int m, int n, int k,
                         int bk, const __grid_constant__ CUtensorMap tma_a,
                         const __grid_constant__ CUtensorMap tma_b) {
  using C = TileCfg<AT, BT, S>;
  constexpr int PA = C::PA, PB = C::PB, NB = C::NB;
  constexpr bool kTwoAcc = PA * PB > 1;
  constexpr bool kScaled = BT == POOL_INT8 || BT == POOL_FP8;   // q8 form
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned raw_base = base + C::kPlaneSlots * C::kPlanes;

  const int tid = threadIdx.x;
  // the warpgroup index, broadcast so the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  TileGeom g;
  g.m = m, g.n = n, g.k = k, g.bk = bk;
  g.bkp = (bk + 15) & ~15;                // block padded to k16 steps
  g.nk = k / bk;
  g.row0 = blockIdx.y * kTM;
  g.col0 = blockIdx.x * C::TN;
  const int spb = g.bkp / 16;             // k16 steps per block
  const int steps = g.nk * spb;
  const int nstages = (steps + kKS - 1) / kKS;

  static_assert(!kTwoAcc || NB == 1, "planes only on the 64-wide tiles");
  float big[NB][32], small[NB][32], s[NB][32], c[NB][32];
  // kTwoAcc: the block's round-to-nearest sum of its steps' hi.hi
  float hs[32];
  float* const c_smem = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + C::kCarryOffset);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      big[nb][i] = small[nb][i] = s[nb][i] = c[nb][i] = 0.0f;
      if constexpr (C::kCarrySmem)
        c_smem[(nb * 32 + i) * kThreads + tid] = 0.0f;
    }
#pragma unroll
  for (int i = 0; i < 32; ++i) hs[i] = 0.0f;
  // the carry of output (nb, i) of this thread
  auto carry = [&](int nb, int i) -> float& {
    if constexpr (C::kCarrySmem)
      return c_smem[(nb * 32 + i) * kThreads + tid];
    else
      return c[nb][i];
  };
  const int c_lane = 2 * (lane & 3);

  auto fence_acc = [&]() {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(big[nb]);
      if (kTwoAcc) fence_regs(small[nb]);
    }
  };
  // with planes: a k16 step's hi.hi (a fresh tensor-core sum) joins the
  // block's sum, round-to-nearest
  auto add_hi = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) hs[i] = __fadd_rn(hs[i], big[0][i]);
  };
  auto fold = [&](int blk) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = big[nb][i];
        if constexpr (kTwoAcc) {
          x = __fadd_rn(hs[i], small[nb][i]);
          hs[i] = 0.0f;
        }
        if constexpr (kScaled) {
          const int col = g.col0 + 64 * nb + 8 * (i >> 2) + c_lane + (i & 1);
          x = __fmul_rn(x, col < n ? scales[static_cast<long long>(blk) * n +
                                            col]
                                   : 0.0f);
        }
        const Pair t = twosum(s[nb][i], x);
        s[nb][i] = t.s;
        carry(nb, i) = __fadd_rn(carry(nb, i), t.c);
      }
  };

  // the k16 steps of the next stage from the planes at shared address
  // pb; returns the block whose fold waits for the stage's last products
  // (-1 if none). With planes, the last step's hi.hi waits too.
  int step = 0, blk = 0, sib = 0;
  auto compute = [&](unsigned pb) -> int {
    int pending = -1;
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      if (step < steps) {
        const int acc = sib != 0;
        uint64_t da[PA], db[PB];
#pragma unroll
        for (int p = 0; p < PA; ++p)
          da[p] = make_desc(pb + p * kAPlane + wg * (64 * 128) + kk * 32, 16,
                            1024);
#pragma unroll
        for (int q = 0; q < PB; ++q)
          db[q] = make_desc(pb + PA * kAPlane + q * NB * kBPlane +
                                kk * (16 * 128),
                            NB > 1 ? kBPlane : 1024, 1024);
        // planes: index 0 hi, 1 mid, 2 lo; smallest products first
        if constexpr (PA == 3 && PB == 3) {
          wgmma_ss_tb(small[0], da[2], db[0], acc);
          wgmma_ss_tb(small[0], da[1], db[1], 1);
          wgmma_ss_tb(small[0], da[0], db[2], 1);
          wgmma_ss_tb(small[0], da[1], db[0], 1);
          wgmma_ss_tb(small[0], da[0], db[1], 1);
        } else if constexpr (PA == 3) {
          wgmma_ss_tb(small[0], da[2], db[0], acc);
          wgmma_ss_tb(small[0], da[1], db[0], 1);
        } else if constexpr (PB == 3) {
          wgmma_ss_tb(small[0], da[0], db[2], acc);
          wgmma_ss_tb(small[0], da[0], db[1], 1);
        }
        if constexpr (NB == 2)
          wgmma_ss_tb_n128(big[0], big[NB - 1], da[0], db[0], acc);
        else
          // with planes hi.hi restarts (scale-d 0) at every step; else
          // it chains over the block
          wgmma_ss_tb(big[0], da[0], db[0], kTwoAcc ? 0 : acc);
        ++step;
        const bool blk_end = ++sib == spb;
        if (blk_end) sib = 0;
        if (kTwoAcc || blk_end) {
          if (kk + 1 < kKS && step < steps) {
            wgmma_commit();
            wgmma_wait0();
            fence_acc();
            if (kTwoAcc) add_hi();
            if (blk_end) fold(blk);
            fence_acc();
            wgmma_fence();
          } else if (blk_end) {
            pending = blk;
          }
          if (blk_end) ++blk;
        }
      }
    }
    wgmma_commit();
    return pending;
  };
  auto finish = [&](int pending) {
    wgmma_wait0();
    fence_acc();
    if (kTwoAcc) add_hi();
    if (pending >= 0) fold(pending);
  };

  if constexpr (S == STAGE_TMA) {
    // one thread issues a stage's three boxes (A 128 x 64, B two 64 x 64
    // panels, all in the 128-byte swizzle, zero past M and N) against
    // the stage's mbarrier, two stages ahead; the products of one stage
    // stay in flight while the next is issued, so the four slots hold
    // stages t - 1 .. t + 2
    constexpr int kStages = C::kPlaneSlots;
    const unsigned bars = base + C::kBarOffset;
    if (tid == 0) {
#pragma unroll
      for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, 1);
      mbar_fence_init();
    }
    __syncthreads();
    auto issue = [&](int t) {          // thread 0
      const int st = t % kStages;
      const unsigned sb = base + st * C::kPlanes;
      const unsigned bar = bars + 8 * st;
      mbar_expect_tx(bar, C::kPlanes);
      tma_load_2d(sb, &tma_a, t * kKS * 16, g.row0, bar);
#pragma unroll
      for (int p = 0; p < NB; ++p)
        tma_load_2d(sb + kAPlane + p * kBPlane, &tma_b, g.col0 + 64 * p,
                    t * kKS * 16, bar);
    };
    if (tid == 0) {
#pragma unroll
      for (int st = 0; st < kStages - 2; ++st)
        if (st < nstages) issue(st);
    }
    for (int t = 0; t < nstages; ++t) {
      mbar_wait(bars + 8 * (t % kStages), (t / kStages) & 1);
      __syncthreads();          // every product of t - 2 is done
      const int pending = compute(base + (t % kStages) * C::kPlanes);
      if (tid == 0 && t + kStages - 2 < nstages) issue(t + kStages - 2);
      if (kTwoAcc || pending >= 0)
        finish(pending);
      else
        wgmma_wait1();
    }
    wgmma_wait0();
    fence_acc();
  } else if constexpr (S == STAGE_RAW) {
    // raw tiles by TMA (A 128 x 64, B 64 x 64 elements, row-major, zero
    // past M and N) three stages deep; every thread splits / widens its
    // chunks into the bf16 planes, during the products of the stage
    // before where two plane slots fit
    constexpr int EA = esize<AT>(), EB = esize<BT>();
    const unsigned bars = base + C::kBarOffset;
    if (tid == 0) {
#pragma unroll
      for (int st = 0; st < 3; ++st) mbar_init(bars + 8 * st, 1);
      mbar_fence_init();
    }
    __syncthreads();
    auto issue = [&](int t) {          // thread 0
      const unsigned rb = raw_base + (t % 3) * C::kRaw;
      const unsigned bar = bars + 8 * (t % 3);
      mbar_expect_tx(bar, C::kRaw);
      tma_load_2d(rb, &tma_a, t * kKS * 16, g.row0, bar);
      tma_load_2d(rb + C::kRawA, &tma_b, g.col0, t * kKS * 16, bar);
    };
    auto convert = [&](int t) {
      mbar_wait(bars + 8 * (t % 3), (t / 3) & 1);
      const unsigned rb = raw_base + (t % 3) * C::kRaw;
      const unsigned sb = base + (t % C::kPlaneSlots) * C::kPlanes;
      const int c8 = tid & 7, r = tid >> 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t w[2 * EA];
        ld_shared_raw<AT>(w, rb + ((r + 32 * q) * 64 + 8 * c8) * EA);
        store_planes<AT>(w, sb + a_dst(q), kAPlane);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t w[2 * EB];
        ld_shared_raw<BT>(w,
                          rb + C::kRawA + ((r + 32 * q) * 64 + 8 * c8) * EB);
        store_planes<BT>(w, sb + PA * kAPlane + b_dst(q), kBPlane);
      }
    };
    if (tid == 0) {
#pragma unroll
      for (int st = 0; st < 3; ++st)
        if (st < nstages) issue(st);
    }
    convert(0);
    fence_proxy_async();
    __syncthreads();
    for (int t = 0; t < nstages; ++t) {
      const bool more = t + 1 < nstages;
      const int pending = compute(base + (t % C::kPlaneSlots) * C::kPlanes);
      // raw slot t % 3 held stage t, converted before the last barrier
      if (tid == 0 && t + 3 < nstages) issue(t + 3);
      if constexpr (C::kPlaneSlots == 2) {
        if (more) convert(t + 1);        // overlaps the products of t
        finish(pending);
      } else {
        finish(pending);
        __syncthreads();                 // every product of t has read
        if (more) convert(t + 1);
      }
      fence_proxy_async();
      __syncthreads();
    }
  } else {
    // registers one stage ahead (any shape and alignment)
    uint32_t ra[4][2 * esize<AT>()];
    uint32_t rb[2][2 * esize<BT>()];
    Cursors cur;
    cur.init(g.bkp);
    auto load = [&]() {                // stages in order: 0, 1, ...
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        long long off;
        const int ok = a_chunk(g, cur.a, q, off);
        load_vec<esize<AT>(), 8 * esize<AT>()>(ra[q], a, off, ok);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        long long off;
        const int ok = b_chunk(g, cur.bq(q, g.bkp), off);
        load_vec<esize<BT>(), 8 * esize<BT>()>(rb[q], b, off, ok);
      }
      cur.next(g.bkp);
    };
    auto store = [&](unsigned sb) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        store_planes<AT>(ra[q], sb + a_dst(q), kAPlane);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        store_planes<BT>(rb[q], sb + PA * kAPlane + b_dst(q), kBPlane);
    };
    load();
    store(base);
    fence_proxy_async();
    __syncthreads();
    for (int t = 0; t < nstages; ++t) {
      const bool more = t + 1 < nstages;
      if (more) load();                  // in flight during the products
      const int pending = compute(base + (t & 1) * C::kPlanes);
      if (more) store(base + ((t + 1) & 1) * C::kPlanes);
      finish(pending);
      fence_proxy_async();
      __syncthreads();
    }
  }

  // out = sum + carry
  const int r_lo = g.row0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r_lo + 8 * ((i >> 1) & 1);
      const int col = g.col0 + 64 * nb + 8 * (i >> 2) + c_lane + (i & 1);
      if (row < m && col < n)
        out[static_cast<long long>(row) * n + col] =
            __fadd_rn(s[nb][i], carry(nb, i));
    }
}

template <int AT, int BT, int S>
int launch_tile(const void* a, const void* b, const float* scales,
                float* out, int m, int n, int k, int bk,
                cudaStream_t stream, const CUtensorMap* maps = nullptr) {
  CUtensorMap none[2];
  if (maps == nullptr) {
    memset(none, 0, sizeof(none));
    maps = none;
  }
  using C = TileCfg<AT, BT, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kahan_matmul_tile_kernel<AT, BT, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n + C::TN - 1) / C::TN, (m + kTM - 1) / kTM);
  kahan_matmul_tile_kernel<AT, BT, S><<<grid, kThreads, C::kSmem, stream>>>(
      a, b, scales, out, m, n, k, bk, maps[0], maps[1]);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------- route S (split over K blocks) -----

// One CTA per (64-column tile, K block, group of 8 rows): the block's
// [8, 64] partial (times its scales in q8) into ws [nk, M, N]. The
// weight tile stays raw in shared memory; thread t owns 4 adjacent
// columns (column group t % 16) and all 8 rows, over one of 16
// contiguous K slices (t / 16), so one weight load feeds 32 FMAs and
// the A values of a K row are two float4 broadcasts. The slices' sums
// then add up in slice order.
template <int AT, int BT>
__global__ void __launch_bounds__(kThreads)
kahan_matmul_split_kernel(const void* __restrict__ a,
                          const void* __restrict__ b,
                          const float* __restrict__ scales,
                          float* __restrict__ ws, int m, int n, int k,
                          int bk) {
  constexpr int E = esize<BT>();
  constexpr int KC = 16384 / (kSN * E);   // K rows per 16 KB weight chunk
  constexpr int VPR = kSN * E / 16;       // 16-byte vectors per row
  constexpr int CPT = 4;                  // columns per thread
  constexpr int NG = kSN / CPT;           // column groups
  constexpr int NS = kThreads / NG;       // K slices
  constexpr int L = KC / NS;              // K rows per slice and chunk
  constexpr int WB = CPT * E;             // weight bytes per thread row
  extern __shared__ __align__(16) unsigned char smem_s[];
  unsigned char* w_s = smem_s;                              // [KC][64] raw
  float* a_s = reinterpret_cast<float*>(smem_s + KC * kSN * E);  // [KC][8]
  float* red = a_s + KC * kSM;                              // [NS][8][64]
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kSN;
  const int blk = blockIdx.y;
  const int row0 = blockIdx.z * kSM, mr = min(kSM, m - row0);
  const int kbeg = blk * bk, kend = kbeg + bk;
  const int cg = tid % NG, ks = tid / NG;

  float acc[kSM][CPT];
#pragma unroll
  for (int r = 0; r < kSM; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    const int rows = min(KC, kend - k0);
    uint32_t raw[4][4];                   // every load in flight at once
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = tid + kThreads * q;
      const int kr = v / VPR, col = col0 + (v % VPR) * (16 / E);
      const bool ok = kr < rows;
      load_vec<E, 16>(raw[q], b,
                      ok ? static_cast<long long>(k0 + kr) * n + col : 0,
                      ok ? max(0, min(16 / E, n - col)) : 0);
    }
    for (int i = tid; i < kSM * KC; i += kThreads) {
      const int r = i / KC, kk = i - r * KC;
      a_s[kk * kSM + r] =
          (r < mr && kk < rows)
              ? load_pool(a, static_cast<long long>(row0 + r) * k + k0 + kk,
                          AT)
              : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)            // raw, zero past the chunk
      *reinterpret_cast<uint4*>(w_s + (tid + kThreads * q) * 16) =
          make_uint4(raw[q][0], raw[q][1], raw[q][2], raw[q][3]);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < L; ++i) {
      const int kk = ks * L + i;
      uint32_t wv[WB / 4];
      const unsigned char* wp = w_s + (kk * kSN + cg * CPT) * E;
      if constexpr (WB == 16) {
        const uint4 x = *reinterpret_cast<const uint4*>(wp);
        wv[0] = x.x, wv[1] = x.y, wv[2] = x.z, wv[3] = x.w;
      } else if constexpr (WB == 8) {
        const uint2 x = *reinterpret_cast<const uint2*>(wp);
        wv[0] = x.x, wv[1] = x.y;
      } else {
        wv[0] = *reinterpret_cast<const uint32_t*>(wp);
      }
      float w[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) w[j] = widen<BT>(wv, j);
#pragma unroll
      for (int r4 = 0; r4 < kSM; r4 += 4) {
        const float4 av =
            *reinterpret_cast<const float4*>(a_s + kk * kSM + r4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[r4 + u][j] = __fmaf_rn(ar[u], w[j], acc[r4 + u][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kSM; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      red[(ks * kSM + r) * kSN + cg * CPT + j] = acc[r][j];
  __syncthreads();
  for (int o = tid; o < kSM * kSN; o += kThreads) {
    const int r = o / kSN, c = o % kSN, col = col0 + c;
    if (r >= mr || col >= n) continue;
    float x = red[r * kSN + c];
    for (int sl = 1; sl < NS; ++sl)
      x = __fadd_rn(x, red[(sl * kSM + r) * kSN + c]);
    if (scales != nullptr)
      x = __fmul_rn(x, scales[static_cast<long long>(blk) * n + col]);
    ws[(static_cast<long long>(blk) * m + row0 + r) * n + col] = x;
  }
}

// out[i] = the Neumaier fold of ws[0][i], ws[1][i], ... in block order
__global__ void __launch_bounds__(kThreads)
kahan_matmul_fold_kernel(const float* __restrict__ ws,
                         float* __restrict__ out, long long mn, int nk) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= mn) return;
  float s = 0.0f, c = 0.0f;
  for (int j = 0; j < nk; ++j) {
    const Pair t = twosum(s, ws[j * mn + i]);
    s = t.s;
    c = __fadd_rn(c, t.c);
  }
  out[i] = __fadd_rn(s, c);
}

// the (A type, B type) instantiation of a route
template <template <int, int> class Fn, typename... Args>
int dispatch(int a_type, int b_type, Args... args) {
  if (a_type == POOL_BF16) {
    switch (b_type) {
      case POOL_BF16: return Fn<POOL_BF16, POOL_BF16>::run(args...);
      case POOL_F32: return Fn<POOL_BF16, POOL_F32>::run(args...);
      case POOL_INT8: return Fn<POOL_BF16, POOL_INT8>::run(args...);
      default: return Fn<POOL_BF16, POOL_FP8>::run(args...);
    }
  }
  switch (b_type) {
    case POOL_BF16: return Fn<POOL_F32, POOL_BF16>::run(args...);
    case POOL_F32: return Fn<POOL_F32, POOL_F32>::run(args...);
    case POOL_INT8: return Fn<POOL_F32, POOL_INT8>::run(args...);
    default: return Fn<POOL_F32, POOL_FP8>::run(args...);
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// a 2-D tensor map over a row-major [outer, inner] matrix of `type`
// with boxes of box_inner x box_outer, zero-filled out of bounds: in the
// 128-byte swizzle (the bf16 planes) or plain (raw tiles)
bool make_map(CUtensorMap* map, const void* base, int type, int inner,
              int outer, int box_inner, int box_outer, bool swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const CUtensorMapDataType dt = type == POOL_BF16
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : type == POOL_F32
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int es = type == POOL_F32 ? 4 : type == POOL_BF16 ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, dt, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int AT, int BT>
struct Tile {
  // tma: 16-byte aligned A and B, bk a multiple of 64 (a stage never
  // straddles a block's padding) and row strides multiples of 16 bytes
  static int run(const void* a, const void* b, const float* scales,
                 float* out, int m, int n, int k, int bk, int tma,
                 cudaStream_t stream) {
    if (!tma)
      return launch_tile<AT, BT, STAGE_REGS>(a, b, scales, out, m, n, k, bk,
                                             stream);
    constexpr bool kPlanesDirect = AT == POOL_BF16 && BT == POOL_BF16;
    CUtensorMap maps[2];
    // A [m, k] in boxes of 64 x 128, B [k, n] in boxes of 64 x 64
    if (!make_map(&maps[0], a, AT, k, m, 64, kTM, kPlanesDirect) ||
        !make_map(&maps[1], b, BT, n, k, 64, 64, kPlanesDirect))
      return static_cast<int>(cudaErrorNotSupported);
    if constexpr (kPlanesDirect)
      return launch_tile<AT, BT, STAGE_TMA>(a, b, scales, out, m, n, k, bk,
                                            stream, maps);
    else
      return launch_tile<AT, BT, STAGE_RAW>(a, b, scales, out, m, n, k, bk,
                                            stream, maps);
  }
};

template <int AT, int BT>
struct Split {
  static int run(const void* a, const void* b, const float* scales,
                 float* ws, float* out, int m, int n, int k, int bk,
                 cudaStream_t stream) {
    constexpr int E = esize<BT>();
    constexpr int KC = 16384 / (kSN * E);
    constexpr int NS = kThreads / (kSN / 4);
    constexpr int smem = KC * kSN * E + (KC * kSM + NS * kSM * kSN) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        kahan_matmul_split_kernel<AT, BT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((n + kSN - 1) / kSN, k / bk, (m + kSM - 1) / kSM);
    kahan_matmul_split_kernel<AT, BT><<<grid, kThreads, smem, stream>>>(
        a, b, scales, ws, m, n, k, bk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long mn = static_cast<long long>(m) * n;
    kahan_matmul_fold_kernel<<<static_cast<unsigned>((mn + kThreads - 1) /
                                                     kThreads),
                               kThreads, 0, stream>>>(ws, out, mn, k / bk);
    return static_cast<int>(cudaGetLastError());
  }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Route T: C [m, n] f32 = A [m, k] @ B [k, n], Neumaier fold every bk
// (bk divides k), each block partial times scales [k / bk, n] first when
// `scales` is not null (the q8 form). a_type: POOL_BF16 or POOL_F32;
// b_type: any PoolType. Launches on `stream`; returns cudaGetLastError().
int repro_kahan_matmul_tile(const void* a, const void* b, const void* scales,
                            void* out, int m, int n, int k, int bk,
                            int a_type, int b_type, void* stream) {
  auto bytes = [](int t) {
    return t == POOL_F32 ? 4 : t == POOL_BF16 ? 2 : 1;
  };
  const int tma = bk % 64 == 0 && (1LL * k * bytes(a_type)) % 16 == 0 &&
                  (1LL * n * bytes(b_type)) % 16 == 0 && aligned16(a) &&
                  aligned16(b);
  return dispatch<Tile>(a_type, b_type, a, b,
                        static_cast<const float*>(scales),
                        static_cast<float*>(out), m, n, k, bk, tma,
                        reinterpret_cast<cudaStream_t>(stream));
}

// Route S: the same function for m <= 64 through the block partials in
// `ws` (f32 [k / bk, m, n]) and their fold in block order (two launches).
int repro_kahan_matmul_split(const void* a, const void* b,
                             const void* scales, void* ws, void* out, int m,
                             int n, int k, int bk, int a_type, int b_type,
                             void* stream) {
  if (m > 64) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Split>(a_type, b_type, a, b,
                         static_cast<const float*>(scales),
                         static_cast<float*>(ws), static_cast<float*>(out),
                         m, n, k, bk,
                         reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
