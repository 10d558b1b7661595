// Device helpers shared by the two paged-attention superkernels
// (paged_attention.cu, GQA form; paged_latent_attention.cu, MLA latent
// form) and by flash_attention_wgmma.cu, kahan_matmul.cu and kahan_acc.cu.
// All must follow the same compensation rules, so they live here once:
//
// * Neumaier chains use __fadd_rn / __fmul_rn: no FMA contraction, or
//   neumaier(s * corr, c * corr, x) would fuse the product into the add
//   and the carry would measure the wrong rounding;
// * pmax propagates NaN (jnp.maximum semantics);
// * fp8 (e4m3) pools are stored as u8 and widened by the bit trick of
//   repro.quant.core.e4m3_to_f32, so 0x7f / 0xff give +-480;
// * kNegInf is the reference's finite -1e30.
//
// Each source is compiled alone into its own shared library, so the
// extern "C" error-string entry point below is defined once per library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
