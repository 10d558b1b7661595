// Elementwise compensated accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/kahan_acc.py, `_kahan_acc_kernel`
// launched by `kahan_acc_flat`: (sum, carry, update) -> (sum, carry) with
// one Neumaier step per element, the gradient-accumulation primitive.
// The TPU kernel aliases its outputs onto its inputs; here the sum and
// carry streams are updated in place.
//
// Numerics: the exact operation sequence of repro.core.kahan.twosum
// followed by `carry + e`, all __fadd_rn / __fsub_rn, so the result is
// bitwise the reference's (adds only: no contraction is possible, and
// the explicit intrinsics keep it so). A bf16 update widens exactly.
//
// Bound: bytes. Per f32 element it reads sum, carry and update and
// writes sum and carry: 20 bytes for 8 flops, far below the card's
// ridge. Design: a grid-stride loop over float4 groups (16-byte loads
// and stores; a bf16 update is read 8 bytes per group), then a scalar
// tail; the wrapper takes the scalar path when a pointer is not 16-byte
// aligned. The grid covers the SMs a few times over.
//
// ptxas (sm_90a, -O3, CUDA 12.8): 40 and 32 registers for the two
// instantiations (f32 and bf16 updates); no spills.

#include "superkernel_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void acc_step(float& s, float& c, float u) {
  const Pair t = twosum(s, u);
  s = t.s;
  c = __fadd_rn(c, t.c);
}

__device__ __forceinline__ float bf16_bits_to_f32(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
kahan_acc_kernel(float* __restrict__ s, float* __restrict__ c,
                 const void* __restrict__ u, long long n, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = vec ? n / 4 : 0;
  float4* s4 = reinterpret_cast<float4*>(s);
  float4* c4 = reinterpret_cast<float4*>(c);
  for (long long i = first; i < groups; i += stride) {
    float4 sv = s4[i];
    float4 cv = c4[i];
    float4 uv;
    if (kBf16) {
      const uint2 raw = reinterpret_cast<const uint2*>(u)[i];
      uv = make_float4(bf16_bits_to_f32(raw.x & 0xFFFFu),
                       bf16_bits_to_f32(raw.x >> 16),
                       bf16_bits_to_f32(raw.y & 0xFFFFu),
                       bf16_bits_to_f32(raw.y >> 16));
    } else {
      uv = reinterpret_cast<const float4*>(u)[i];
    }
    acc_step(sv.x, cv.x, uv.x);
    acc_step(sv.y, cv.y, uv.y);
    acc_step(sv.z, cv.z, uv.z);
    acc_step(sv.w, cv.w, uv.w);
    s4[i] = sv;
    c4[i] = cv;
  }
  for (long long i = groups * 4 + first; i < n; i += stride) {
    const float ui =
        kBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[i])
              : static_cast<const float*>(u)[i];
    acc_step(s[i], c[i], ui);
  }
}

}  // namespace

extern "C" {

// In place: s[i], c[i] <- neumaier_step(s[i], c[i], u[i]) for i < n.
// update_bf16: the update is bf16 (else f32). vec: s, c and u are
// 16-byte aligned (8 for a bf16 u), so the float4 path may be taken.
// Launches on `stream`; returns cudaGetLastError().
int repro_kahan_acc(void* s, void* c, const void* u, long long n,
                    int update_bf16, int vec, int max_blocks, void* stream) {
  if (n <= 0) return 0;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (update_bf16) {
    kahan_acc_kernel<true><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        static_cast<float*>(s), static_cast<float*>(c), u, n, vec);
  } else {
    kahan_acc_kernel<false><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        static_cast<float*>(s), static_cast<float*>(c), u, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
