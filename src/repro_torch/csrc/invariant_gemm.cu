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
// The rule: every element's arithmetic is set by (B, K, N) alone.
//   * K is a chain of k16 steps of wgmma.mma_async m64n128k16 (bf16
//     operands, f32 accumulators) in increasing k, from a sum of +0
//     (every step accumulates). A tensor-core product computes each
//     element from its own row of A, column of B and accumulator, so a
//     row's chain is the same in any row of a tile. Padding past K is
//     zeros, whose products add nothing.
//   * The K split: S parts of `cpg` granules of 32 each, chosen by the
//     host wrapper from (B, K, N) only (kernels/invariant_gemm.py
//     `split_plan`), folded left to right: total = p0, then total + p1
//     (__fadd_rn), and so on.
//   * That is the arithmetic of the first form of this kernel (mma.sync
//     m16n8k16 in chunks of 32, a second fold kernel), whose k16 step
//     gives the same bits as wgmma's, and the plan is its plan up to 16
//     parts: the products are bitwise that kernel's wherever its plan had
//     16 parts or fewer (every product of qwen1.5-0.5b;
//     tools/gemm_parent_ab.py), so a faster kernel did not move the
//     served path's numerics.
//   * Rows past M and columns past N are zeros (TMA's out-of-bounds fill,
//     or the loads') that are never stored.
//
// Two routes, picked by the wrapper from M, give the same bits:
//   * skinny (M <= 64: decode, verify): grid (N tiles of 128, M tiles of
//     64, B x S). CTA (x, y, b S + s) computes part s of its tile with
//     one consumer warpgroup, and the S parts of a tile run as one
//     thread-block cluster (S <= 16; past 8 a non-portable size). The
//     CTA walks the 64-wide chunks (four k16 steps) that hold its part;
//     a step of those chunks outside its part reads a zero A tile, which
//     adds exact zeros to a sum of +0 or to the part's sum. Each CTA puts
//     its part in its own shared memory; after the cluster's barrier CTA
//     s folds a share of the tile's elements, reading the S parts through
//     distributed shared memory in the order s = 0, 1, ..., S - 1 (one
//     __fadd_rn each), and stores y. One kernel per call: no fold launch,
//     no scratch in device memory, no counters. (A first form wrote each
//     part to device memory and let the last CTA to take a ticket fold
//     them all: one SM reading every part back from L2, a cost that grew
//     with M.)
//   * wide (M > 64: prefill): grid (N tiles of 128, M tiles of 128, B).
//     Two consumer warpgroups (64 rows each) walk every part in turn,
//     each chunk in two halves of 32, and fold each part where it ends
//     (after either half) into a running total in registers with
//     __fadd_rn, restarting the sum at +0: bit for bit the skinny route's
//     fold, no scratch.
//
// Staging: with K and N multiples of 8 and 16-byte aligned operands,
// thread 0 keeps a ring of stages in flight by TMA (3-D tensor maps over
// [B, M, K] and [B, K, N], the 128-byte swizzle, an mbarrier per stage):
// 8 slots of A [64 x 64] + B [64 x 128] (24 KB; 6 stages, 96 KB of
// weights, in flight per SM) on the skinny route, 6 slots of A [128 x
// 64] + B on the wide one; one stage's products run while the next is
// issued. B is read MN-major straight from w's row-major [K, N] (two
// 64-column panels). Any other shape or alignment (e.g. whisper's bf16
// head, N = 51865, or an attention tail) is staged by the threads' own
// loads into the same swizzled layout, one stage at a time, and runs the
// same wgmma. (A producer warp beside the consumer warpgroups cost a
// warpgroup's registers, 168 a thread, and spilled on the wide route.)
//
// Bound: at the served path's M (8 to 256 rows) bytes: the bf16 weight
// read once (qwen1.5-0.5b's 144 products of one decode step: ~607 MB,
// 0.18 ms at 3.35 TB/s); the skinny route's split spreads a weight over
// up to one wave of CTAs (clusters of S share a GPC: `split_plan`), so
// each SM streams its share through a deep ring. At prefill
// M (2048) operations (989 TFLOP/s bf16); there a 128 x 128 tile reads
// 32 KB from L2 for every 2.1 MFLOP, and with the running total beside
// the accumulators (128 f32 registers a thread) it holds one CTA per SM.
// Where it stands against cuBLAS (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// chip_smoke.py [gemm]): 1.0-1.5x at M = 8 and 40, ~2x at 2048, and up
// to ~5x at M = 256, where the wide route's grid is one CTA per output
// tile (16 for qwen1.5's down) and a part of two granules folds after
// every chunk (tools/gemm_parent_ab.py times both routes there; the
// skinny route wins up to M = 256 on some shapes).
//
// No --use_fast_math: the fold's adds are explicit __fadd_rn.

#include <cooperative_groups.h>
#include <cuda.h>

#include "superkernel_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kBN = 128;              // output columns per CTA
constexpr int kBK = 64;               // K chunk: four k16 steps
constexpr int kPanel = 64 * 128;      // 64 rows x 64 bf16 (128 B): 8 KB
constexpr int kBBytes = 2 * kPanel;   // a B stage: 64 K rows x 128 columns
constexpr int kMaxSplits = 16;        // K split parts at most (a cluster)

// WG consumer warpgroups: 1 on the skinny route, 2 on the wide one
template <int WG>
struct Cfg {
  static constexpr int kRows = 64 * WG;            // rows per CTA
  static constexpr int kABytes = kRows * 128;      // an A stage
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kStages = WG == 1 ? 8 : 6;  // the TMA ring
  static constexpr int kThreads = 128 * WG;
  // skinny: a zero A tile for the steps of its chunks outside its part
  static constexpr int kZeroBytes = WG == 1 ? kABytes : 0;
  static constexpr int kZeroOffset = kStages * kStage;   // after the ring
  static constexpr int kBarOffset = kZeroOffset + kZeroBytes;
  static constexpr int kSmemTma = 1024 + kBarOffset + 8 * kStages;
  // one stage (then the zero tile) and no ring; room for the skinny
  // route's part (a [64 x 128] f32 tile) after the loop
  static constexpr int kLoadBytes = kStage + kZeroBytes;
  static constexpr int kSmemLoad =
      1024 + (kLoadBytes > kRows * kBN * 4 ? kLoadBytes : kRows * kBN * 4);
};

struct Args {
  const uint16_t* x;     // [B, M, K] bf16
  const uint16_t* w;     // [B, K, N] bf16
  float* y;              // [B, M, N]
  int batch, m, n, k, splits;
  int cpg, kg;           // granules of 32 K per part, and in all
};

// mbar_wait with a deadline: a stage that never arrives (a fault in the
// ring's bookkeeping) traps after ~10 s of clocks instead of hanging the
// card
__device__ __forceinline__ void wait_stage(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void st_shared_zero16(unsigned addr) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr),
               "r"(0)
               : "memory");
}

__device__ __forceinline__ void st_shared_u16(unsigned addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

// chunk c of the A rows [row0, row0 + kRows) and of the B columns [n0,
// n0 + kBN) by plain loads into the swizzled stage at sa; zeros outside
// [M, K] and [K, N]
template <int WG>
__device__ __forceinline__ void load_stage(const Args& a, unsigned sa,
                                           int b, int row0, int n0, int c) {
  using C = Cfg<WG>;
  const int k0 = c * kBK;
  const uint16_t* xb = a.x + (size_t)b * a.m * a.k;
  const uint16_t* wb = a.w + (size_t)b * a.k * a.n;
  for (int i = threadIdx.x; i < C::kRows * kBK; i += C::kThreads) {
    const int r = i >> 6, q = i & 63;
    const int gr = row0 + r, gk = k0 + q;
    const uint16_t v =
        gr < a.m && gk < a.k ? xb[(size_t)gr * a.k + gk] : uint16_t(0);
    st_shared_u16(sa + r * 128 + (((q >> 3) ^ (r & 7)) << 4) + (q & 7) * 2,
                  v);
  }
  for (int i = threadIdx.x; i < kBK * kBN; i += C::kThreads) {
    const int r = i >> 7, col = i & 127, q = col & 63;
    const int gk = k0 + r, gn = n0 + col;
    const uint16_t v =
        gk < a.k && gn < a.n ? wb[(size_t)gk * a.n + gn] : uint16_t(0);
    st_shared_u16(sa + C::kABytes + (col >> 6) * kPanel + r * 128 +
                      (((q >> 3) ^ (r & 7)) << 4) + (q & 7) * 2,
                  v);
  }
}

template <int WG, bool kTma>
__global__ void __launch_bounds__(Cfg<WG>::kThreads, 1)
invariant_gemm_kernel(const __grid_constant__ Args a,
                      const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w) {
  using C = Cfg<WG>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * C::kRows;
  // skinny: CTA z = b S + s holds part s; wide: CTA z = b walks them all
  const int b = WG == 1 ? blockIdx.z / a.splits : blockIdx.z;
  const int own = WG == 1 ? blockIdx.z % a.splits : 0;
  // the K steps (k16) this CTA sums: skinny, its part's granules [gb,
  // ge) of 32; wide, all of them. It walks the 64-wide chunks holding
  // them; a step of those chunks outside its part reads the zero A tile.
  const int gb = WG == 1 ? own * a.cpg : 0;
  const int ge = WG == 1 ? min(a.kg, gb + a.cpg) : a.kg;
  const int sb = 2 * gb, se = 2 * ge;
  const int c_begin = gb / 2, chunks = (ge + 1) / 2 - c_begin;

  // the warpgroup index, broadcast so the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  float d0[32], d1[32];     // the part being summed: columns 0-63, 64-127
  float t0[32], t1[32];     // wide: the running total of the parts
#pragma unroll
  for (int i = 0; i < 32; ++i) d0[i] = d1[i] = t0[i] = t1[i] = 0.0f;
  const unsigned zero = base + (kTma ? C::kZeroOffset : C::kStage);
  if constexpr (WG == 1) {
    for (int i = tid; i < C::kABytes / 16; i += C::kThreads)
      st_shared_zero16(zero + 16 * i);
    fence_proxy_async();
  }

  // k16 steps 2 h and 2 h + 1 of chunk c from the stage at sa, added to
  // the part's sum (which starts at +0: every step accumulates)
  auto issue_half = [&](unsigned sa, int c, int h) {
    const unsigned ab = sa + wg * (64 * 128), bb = sa + C::kABytes;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = 2 * h + j, g = 4 * c + kk;
      const unsigned as = WG == 1 && (g < sb || g >= se) ? zero : ab;
      wgmma_ss_tb_n128(d0, d1, make_desc(as + kk * 32, 16, 1024),
                       make_desc(bb + kk * (16 * 128), kPanel, 1024), 1);
    }
  };
  auto open_group = [&]() {
    fence_regs(d0);
    fence_regs(d1);
    wgmma_fence();
  };
  // wide: after the last granule q of a part, its sum joins the total
  // (total = p0, then total + p1, ...) and the next part starts at +0
  auto part_end = [&](int q) {
    return q < a.kg && ((q + 1) % a.cpg == 0 || q + 1 == a.kg);
  };
  auto fold = [&](int q) {
    fence_regs(d0);
    fence_regs(d1);
    const bool first = q < a.cpg;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      t0[i] = first ? d0[i] : __fadd_rn(t0[i], d0[i]);
      t1[i] = first ? d1[i] : __fadd_rn(t1[i], d1[i]);
      d0[i] = d1[i] = 0.0f;
    }
  };
  // chunk c: its two halves, a part folded between them where one ends
  // there (wide); the second half's products stay in flight
  auto chunk = [&](unsigned sa, int c) {
    open_group();
    issue_half(sa, c, 0);
    if (WG == 2 && part_end(2 * c)) {
      wgmma_commit();
      wgmma_wait0();
      fold(2 * c);
      open_group();
    }
    issue_half(sa, c, 1);
    wgmma_commit();
  };
  auto settle = [&](int c) {   // after chunk c: fold, or keep one in flight
    if (WG == 2 && part_end(2 * c + 1)) {
      wgmma_wait0();
      fold(2 * c + 1);
    } else {
      wgmma_wait1();
    }
  };

  if constexpr (kTma) {
    // thread 0 issues a stage's three boxes (A, B's two 64-column panels;
    // zeros past M, K and N) against the stage's mbarrier, kStages - 2
    // stages ahead; the products of one stage stay in flight while the
    // next is issued, so the ring holds stages t - 1 .. t + kStages - 2
    const unsigned full = base + C::kBarOffset;
    if (tid == 0) {
#pragma unroll
      for (int st = 0; st < C::kStages; ++st) mbar_init(full + 8 * st, 1);
      mbar_fence_init();
    }
    __syncthreads();
    auto load = [&](int t) {              // thread 0
      const int st = t % C::kStages, k0 = (c_begin + t) * kBK;
      const unsigned sa = base + st * C::kStage, bar = full + 8 * st;
      mbar_expect_tx(bar, C::kStage);
      tma_load_3d(sa, &map_x, k0, row0, b, bar);
      tma_load_3d(sa + C::kABytes, &map_w, n0, k0, b, bar);
      tma_load_3d(sa + C::kABytes + kPanel, &map_w, n0 + 64, k0, b, bar);
    };
    if (tid == 0)
      for (int t = 0; t < min(chunks, C::kStages - 2); ++t) load(t);
    for (int t = 0; t < chunks; ++t) {
      const int st = t % C::kStages, c = c_begin + t;
      wait_stage(full + 8 * st, (t / C::kStages) & 1);
      __syncthreads();          // every product of stage t - 2 is done
      chunk(base + st * C::kStage, c);
      if (tid == 0 && t + C::kStages - 2 < chunks) load(t + C::kStages - 2);
      settle(c);
    }
  } else {
    for (int t = 0; t < chunks; ++t) {
      const int c = c_begin + t;
      __syncthreads();            // every product has read the stage
      load_stage<WG>(a, base, b, row0, n0, c);
      fence_proxy_async();
      __syncthreads();
      chunk(base, c);
      wgmma_wait0();              // one stage: its products end here
      if (WG == 2 && part_end(2 * c + 1)) fold(2 * c + 1);
    }
  }
  wgmma_wait0();
  fence_regs(d0);
  fence_regs(d1);

  // this thread's outputs: rows r_lo and r_lo + 8, columns 8 j + 2 (lane %
  // 4) + {0, 1} of each 64-wide half; dst[off] = v for those within [M, N]
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = row0 + wg * 64 + warp * 16 + (lane >> 2);
  const int c_lo = n0 + 2 * (lane & 3);
  const bool pairs = (a.n & 1) == 0;     // (col, col + 1) as one float2
  auto store = [&](float* dst, const float (&v0)[32], const float (&v1)[32]) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r_lo + 8 * ((i >> 1) & 1);
      const int col = c_lo + 8 * (i >> 2);
      if (row >= a.m) continue;
      float* o = dst + (size_t)row * a.n + col;
#pragma unroll
      for (int half = 0; half < 2; ++half, o += 64) {
        const int c = col + 64 * half;
        const float x = half ? v1[i] : v0[i], y = half ? v1[i + 1] : v0[i + 1];
        if (pairs && c + 1 < a.n) {
          *reinterpret_cast<float2*>(o) = make_float2(x, y);
        } else {
          if (c < a.n) o[0] = x;
          if (c + 1 < a.n) o[1] = y;
        }
      }
    }
  };
  const size_t mn = (size_t)a.m * a.n;
  if (WG == 2 || a.splits == 1) {
    if constexpr (WG == 2)
      store(a.y + (size_t)b * mn, t0, t1);
    else
      store(a.y + (size_t)b * mn, d0, d1);
    return;
  }

  // skinny, S > 1: the tile's S parts are one cluster (z = b S .. b S +
  // S - 1). Each CTA puts its part in its own shared memory (the ring is
  // done); after the cluster's barrier CTA s folds float4 groups s, s +
  // S, ... of the tile, reading the parts of every CTA through
  // distributed shared memory in the order 0, 1, ..., S - 1; the second
  // barrier keeps each part alive until every CTA has read it.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* part =
      reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  __syncthreads();        // every product of this CTA has read the ring
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = r_lo - row0 + 8 * ((i >> 1) & 1);
    const int col = c_lo - n0 + 8 * (i >> 2);
    float* o = part + row * kBN + col;
    *reinterpret_cast<float2*>(o) = make_float2(d0[i], d0[i + 1]);
    *reinterpret_cast<float2*>(o + 64) = make_float2(d1[i], d1[i + 1]);
  }
  cluster.sync();
  const int rows = min(C::kRows, a.m - row0), cols = min(kBN, a.n - n0);
  const bool vec = (a.n & 3) == 0;
  float* y = a.y + (size_t)b * mn;
  for (int f = own * C::kThreads + tid; f < rows * (kBN / 4);
       f += a.splits * C::kThreads) {
    const int r = f / (kBN / 4), c4 = 4 * (f % (kBN / 4));
    if (c4 >= cols) continue;
    float4 p[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < a.splits)
        p[s] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part + r * kBN + c4, s));
    float4 v = p[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s) {
      if (s >= a.splits) continue;
      v.x = __fadd_rn(v.x, p[s].x);
      v.y = __fadd_rn(v.y, p[s].y);
      v.z = __fadd_rn(v.z, p[s].z);
      v.w = __fadd_rn(v.w, p[s].w);
    }
    float* o = y + (size_t)(row0 + r) * a.n + n0 + c4;
    if (vec && c4 + 4 <= cols) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      if (c4 < cols) o[0] = v.x;
      if (c4 + 1 < cols) o[1] = v.y;
      if (c4 + 2 < cols) o[2] = v.z;
      if (c4 + 3 < cols) o[3] = v.w;
    }
  }
  cluster.sync();
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// a 3-D tensor map over a row-major bf16 [outer2, outer1, inner] array,
// boxes of 64 (inner) x box1 x 1 in the 128-byte swizzle, zero-filled
// out of bounds
bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer1,
              int outer2, int box1) {
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
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer1),
                              static_cast<cuuint64_t>(outer2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * outer1 * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WG, bool kTma>
int launch(const Args& a, cudaStream_t st) {
  using C = Cfg<WG>;
  constexpr int smem = kTma ? C::kSmemTma : C::kSmemLoad;
  static unsigned long long sized = 0;   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(sized >> dev & 1)) {
    e = cudaFuncSetAttribute(invariant_gemm_kernel<WG, kTma>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    // clusters of up to kMaxSplits CTAs: past 8, a non-portable size
    if (e == cudaSuccess && WG == 1)
      e = cudaFuncSetAttribute(
          invariant_gemm_kernel<WG, kTma>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) sized |= 1ull << dev;
  }
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (kTma && !(make_map(&maps[0], a.x, a.k, a.m, a.batch, C::kRows) &&
                make_map(&maps[1], a.w, a.n, a.k, a.batch, kBK)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the skinny route's S parts of a tile run as one cluster
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = a.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + kBN - 1) / kBN, (a.m + C::kRows - 1) / C::kRows,
                     WG == 1 ? a.batch * a.splits : a.batch);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = WG == 1 && a.splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, invariant_gemm_kernel<WG, kTma>, a, maps[0],
                         maps[1]);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [B, M, K] bf16, w: [B, K, N] bf16, y: [B, M, N] f32, all contiguous;
// wide: the route (0 skinny, 1 wide); `aligned`: K and N multiples of 8
// and x, w 16-byte aligned (TMA staging). Launches one kernel; returns
// the launch's error.
int repro_invariant_gemm(const void* x, const void* w, void* y, int batch,
                         int m, int n, int k, int splits, int cpg, int wide,
                         int aligned, void* stream) {
  const int kg = (k + 31) / 32;
  const int rows = wide ? 128 : 64;
  const long long z = wide ? batch : (long long)batch * splits;
  if (batch < 1 || m < 1 || n < 1 || k < 1 || splits < 1 || cpg < 1 ||
      splits > kMaxSplits || (long long)splits * cpg < kg ||
      (splits - 1) * cpg >= kg ||
      (m + rows - 1) / rows > 65535 || z > 65535 ||
      (long long)m * n >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const uint16_t*>(x);
  a.w = static_cast<const uint16_t*>(w);
  a.y = static_cast<float*>(y);
  a.batch = batch, a.m = m, a.n = n, a.k = k;
  a.splits = splits, a.cpg = cpg, a.kg = kg;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (wide)
    return aligned ? launch<2, true>(a, st) : launch<2, false>(a, st);
  return aligned ? launch<1, true>(a, st) : launch<1, false>(a, st);
}

}  // extern "C"
