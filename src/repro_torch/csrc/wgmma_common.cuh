// Hopper (sm_90a) tensor-core helpers shared by flash_attention_wgmma.cu,
// kahan_matmul.cu, paged_latent_attention.cu and invariant_gemm.cu:
// 16-byte cp.async with zero-fill, the proxy and wgmma fences, the
// shared-memory matrix descriptor of the 128-byte swizzle, the bf16 wgmma
// forms the kernels issue, mbarriers with 2-D and 3-D TMA loads, and the
// exact bf16 PLANES that carry f32 (and 8-bit) operands onto the bf16
// tensor cores.
//
// Planes: a bf16 value, an int8 payload (|q| <= 127: 7 bits) and an e4m3
// payload (3 mantissa bits, exponents inside bf16's) are one plane; an
// f32 value x is three, hi = bf16_rn(x), mid = bf16_rn(x - hi), lo = x -
// hi - mid, where both differences are exact in f32 and lo is exactly a
// bf16 value, so hi + mid + lo == x. That holds for every finite x with
// 2^-103 <= |x| < (2 - 2^-8) 2^127 (below, lo or mid falls under bf16's
// normal range; above, hi rounds to inf) and for x = 0; inf and NaN give
// NaN planes. Every bf16 x bf16 product is exact in f32. The CPU tests
// (tests/test_torch_kahan_matmul.py) pin the split.
//
// Tile layout the kernels use: a tile is stored in panels 64 bf16
// (128 bytes) wide; row r of a panel sits at r * 128 bytes, and its
// 16-byte chunk c at ((c ^ (r % 8)) << 4). One descriptor form (SBO
// 1024 bytes: eight rows) addresses such a panel as a K-major operand
// (rows are M or N, LBO unused: 16) or as an MN-major one (rows are K),
// 64 wide in N; a 128-wide MN-major operand is two such panels, LBO
// bytes apart.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "superkernel_common.cuh"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16_zfill(unsigned dst,
                                                 const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async and st.shared write through the generic proxy, wgmma reads
// through the async proxy: each writer fences before the barrier that
// publishes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads / writes across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(unsigned saddr, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d = A B + (accumulate ? d : 0), A and B bf16 from shared memory, both
// K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B + (accumulate ? d : 0), A bf16 K-major and B bf16 MN-major
// (transposed), both from shared memory
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B + (accumulate ? d : 0) over 64 x 128: A bf16 K-major, B bf16
// MN-major from shared memory (two 64-wide panels LBO bytes apart); d0
// holds columns 0-63 of the accumulator fragment, d1 columns 64-127
__device__ __forceinline__ void wgmma_ss_tb_n128(float (&d0)[32],
                                                 float (&d1)[32], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "0, 1;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]),
        "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]),
        "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]),
        "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]), "+f"(d1[8]), "+f"(d1[9]),
        "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]),
        "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]), "+f"(d1[24]),
        "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]),
        "+f"(d1[30]), "+f"(d1[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B + (accumulate ? d : 0), A bf16 from registers (the m64k16
// fragment), B bf16 from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// mbarrier: init (one thread), the fence that publishes it, a thread's
// arrival that also expects `bytes` of TMA traffic, and the wait for
// the phase of parity `parity` to complete
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
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
  } while (!done);
}

// TMA: the box of a 2-D tensor map at coordinates (c0 innermost, c1)
// into shared memory at dst, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(unsigned dst, const void* map,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same for a 3-D tensor map, coordinates (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_load_3d(unsigned dst, const void* map,
                                            int c0, int c1, int c2,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// ------------------------------------------------------------ planes --

template <int T>
__host__ __device__ constexpr int esize() {
  return T == POOL_F32 ? 4 : T == POOL_BF16 ? 2 : 1;
}

template <int T>
__host__ __device__ constexpr int planes() {
  return T == POOL_F32 ? 3 : 1;
}

// element e of a raw vector, widened to f32 (exact for every type)
template <int T, int NW>
__device__ __forceinline__ float widen(const uint32_t (&w)[NW], int e) {
  if constexpr (T == POOL_F32) {
    return __uint_as_float(w[e]);
  } else if constexpr (T == POOL_BF16) {
    return __uint_as_float(((w[e >> 1] >> (16 * (e & 1))) & 0xFFFFu) << 16);
  } else {
    const uint32_t u = (w[e >> 2] >> (8 * (e & 3))) & 0xFFu;
    if constexpr (T == POOL_INT8)
      return static_cast<float>(static_cast<int8_t>(u));
    else
      return e4m3_to_f32(static_cast<uint8_t>(u));
  }
}

// hi, mid, lo bf16 planes of an f32 x: hi + mid + lo == x exactly (for
// the range stated at the top of this file)
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = __fsub_rn(x, hi);
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = __fsub_rn(r, mid);
}

__device__ __forceinline__ void st_shared4(unsigned addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// 8 elements (raw words of type T) -> planes<T>() bf16 planes, each one
// 16-byte chunk stored at addr + p * plane_bytes (plane 0 hi, 1 mid, 2 lo)
template <int T>
__device__ __forceinline__ void store_planes(
    const uint32_t (&w)[2 * esize<T>()], unsigned addr, int plane_bytes) {
  if constexpr (T == POOL_BF16) {
    st_shared4(addr, w[0], w[1], w[2], w[3]);
  } else if constexpr (T == POOL_F32) {
    uint32_t h[4], m[4], l[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float h0, m0, l0, h1, m1, l1;
      split3(__uint_as_float(w[e]), h0, m0, l0);
      split3(__uint_as_float(w[e + 1]), h1, m1, l1);
      h[e / 2] = pack_bf16(h0, h1);
      m[e / 2] = pack_bf16(m0, m1);
      l[e / 2] = pack_bf16(l0, l1);
    }
    st_shared4(addr, h[0], h[1], h[2], h[3]);
    st_shared4(addr + plane_bytes, m[0], m[1], m[2], m[3]);
    st_shared4(addr + 2 * plane_bytes, l[0], l[1], l[2], l[3]);
  } else {
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      o[e / 2] = pack_bf16(widen<T>(w, e), widen<T>(w, e + 1));
    st_shared4(addr, o[0], o[1], o[2], o[3]);
  }
}

}  // namespace
