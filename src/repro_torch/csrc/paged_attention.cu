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
// Bound: bytes. Decode reads each resident K/V token once (bf16:
// 2 * Hkv * D * 2 bytes per token per layer) with ~4 flops per byte, far
// below the card's ridge; tensor cores would not help (one query row per
// kv head at decode). At the decode shape (B = 8, Hq = Hkv = 16, D = 64,
// bs = 16, 2304 live tokens) the bound is ~3 us, so what sets the time
// is latency: blocks in flight, global round trips and barriers.
//
// Design: a fixed split over table slots, two kernels.
// * split: grid (B, Hkv, ceil(mb / kSlots)). Partition p owns table
//   slots [p * kSlots, (p + 1) * kSlots); it is dead, and does nothing,
//   when its first slot starts at or past lens[b] (or past the table
//   width: idle slots' lengths drift past it and their tables point at
//   the null block). A live partition issues every slot's K / V tile
//   (and scales) at once with cp.async, 16 bytes a thread where rows
//   allow, one commit group per slot, so later slots are in flight while
//   the first is computed. Per slot: each score (r, t) is two 32-lane
//   halves of the D-long FMA chain (ascending e, 16-byte shared loads on
//   a padded row stride) joined by one xor shuffle; each row's max and
//   sum of p are xor-shuffle trees of one warp; each acc element is one
//   thread's bs-long FMA chain, folded by rescale_add. The partition
//   writes its (m, l_s, l_c, acc_s, acc_c) per row to the scratch.
// * merge: grid (B, Hkv). Each output element folds the live partitions
//   in partition index order: m is their max, each partition's sum AND
//   carry are scaled by exp(m_p - m) and TwoSum-folded, and
//   out = (acc_s + acc_c) / max(l_s + l_c, 1e-30).
// The split depends only on the absolute slot index, never on W, B, the
// table width or the other sequences, and every per-row and per-element
// chain is the same code whatever thread runs it. A key masked for a row
// (or a partition whose keys are all masked for it) is an exact identity
// update, as in the reference. So, bitwise: row w of a width-W call
// equals the width-1 call at q_offsets + w; a sequence alone equals the
// same sequence inside a batch; a table of mb slots equals a wider one
// holding the same slots.
//
// The compensated chains use __fmul_rn / __fadd_rn (no FMA contraction:
// neumaier(ls * corr, lc * corr, p_sum) would otherwise fuse the product
// into the add and the carry would measure the wrong rounding) and the
// IEEE expf. NEG_INF is the finite -1e30 of the reference; the `* mask`
// after exp makes a fully masked row an exact identity update.
//
// It replaces a first design of one block per (b, h) walking the whole
// table serially, one thread per score and one thread per row's softmax
// (times of both in PERF.md).
//
// ptxas (sm_90a, -O3, CUDA 12.8): the split kernel 64 registers for
// bf16 and f32 pools, 56 for int8 and fp8; the merge 40; no spills.

#include "superkernel_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;          // table slots per partition
constexpr int kRowPad = 16;        // bytes added to each staged K / V row
constexpr unsigned kFull = 0xffffffffu;

template <int PT> struct Pool;

template <> struct Pool<POOL_BF16> {
  static constexpr int kBytes = 2;
  __device__ static float at(const unsigned char* p, int i) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static void widen(uint4 raw, float* x) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct Pool<POOL_F32> {
  static constexpr int kBytes = 4;
  __device__ static float at(const unsigned char* p, int i) {
    return reinterpret_cast<const float*>(p)[i];
  }
  __device__ static void widen(uint4 raw, float* x) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z);
    x[3] = __uint_as_float(raw.w);
  }
};

template <> struct Pool<POOL_INT8> {
  static constexpr int kBytes = 1;
  __device__ static float at(const unsigned char* p, int i) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(p)[i]);
  }
  __device__ static void widen(uint4 raw, float* x) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = static_cast<float>(
          static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xffu));
  }
};

template <> struct Pool<POOL_FP8> {
  static constexpr int kBytes = 1;
  __device__ static float at(const unsigned char* p, int i) {
    return e4m3_to_f32(p[i]);
  }
  __device__ static void widen(uint4 raw, float* x) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = e4m3_to_f32(
          static_cast<uint8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xffu));
  }
};

__host__ __device__ inline int pool_bytes(int type) {
  return type == POOL_F32 ? 4 : type == POOL_BF16 ? 2 : 1;
}

__host__ __device__ inline int row_stride(int n, int eb) {
  return (n * eb + 15) / 16 * 16 + kRowPad;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` commit groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  static_assert(kSlots == 4, "one case per possible pending count");
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Copy `rows` rows of `row_bytes` bytes (source stride `src_stride`) to
// shared memory at stride `dst_stride`: 16-byte cp.async where the rows
// allow, 4-byte cp.async otherwise, byte loads as the last resort.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const unsigned char* src,
                                           long long src_stride,
                                           int dst_stride, int row_bytes,
                                           int rows) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(src);
  if (row_bytes % 16 == 0 && src_stride % 16 == 0 && a % 16 == 0) {
    const int per = row_bytes / 16;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int t = i / per, c = i - t * per;
      cp_async16(dst + t * dst_stride + 16 * c, src + t * src_stride + 16 * c);
    }
  } else if (row_bytes % 4 == 0 && src_stride % 4 == 0 && a % 4 == 0) {
    const int per = row_bytes / 4;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int t = i / per, c = i - t * per;
      cp_async4(dst + t * dst_stride + 4 * c, src + t * src_stride + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * row_bytes; i += kThreads) {
      const int t = i / row_bytes, c = i - t * row_bytes;
      dst[t * dst_stride + c] = src[t * src_stride + c];
    }
  }
}

// sum_{e0 <= e < e1} q[e] * k[e] as one ascending FMA chain; 16-byte
// shared loads when the span is 16-byte aligned (the same chain).
template <int PT>
__device__ __forceinline__ float span_dot(const float* q,
                                          const unsigned char* k, int e0,
                                          int e1) {
  constexpr int kB = Pool<PT>::kBytes;
  constexpr int kV = 16 / kB;
  float acc = 0.0f;
  if ((e0 * kB) % 16 == 0 && (e1 * kB) % 16 == 0) {
    for (int e = e0; e < e1; e += kV) {
      float x[kV];
      Pool<PT>::widen(*reinterpret_cast<const uint4*>(k + e * kB), x);
#pragma unroll
      for (int u = 0; u < kV; ++u) acc = __fmaf_rn(q[e + u], x[u], acc);
    }
  } else {
    for (int e = e0; e < e1; ++e) acc = __fmaf_rn(q[e], Pool<PT>::at(k, e), acc);
  }
  return acc;
}

struct Layout {
  int kstride, vstride;            // staged row strides (bytes)
  long long tiles;                 // bytes of the staged K / V tiles
  long long total;                 // bytes of dynamic shared memory
};

__host__ __device__ inline Layout layout(int rows, int d, int dv, int bs,
                                         int pool_type) {
  const int eb = pool_bytes(pool_type);
  Layout L;
  L.kstride = row_stride(d, eb);
  L.vstride = row_stride(dv, eb);
  L.tiles = (long long)kSlots * bs * (L.kstride + L.vstride);
  L.total = L.tiles + 4LL * (rows * d + rows * bs + 2LL * rows * dv +
                             4LL * rows + 2LL * kSlots * bs);
  return L;
}

__device__ __forceinline__ int live_slots(int length, int bs, int mb) {
  return length <= 0 ? 0 : min(mb, (length + bs - 1) / bs);
}

// q: [B, W, Hq, D]; pools: [nb, bs, Hkv, D(v)]; scales: [nb, bs, Hkv];
// table: [B, mb]; lens, offs: [B]; part: [B, Hkv, nparts, rows * (3 +
// 2 dv)] f32 (m, l_s, l_c per row, then acc_s, acc_c per element).
template <int PT>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const void* __restrict__ q,
                             const unsigned char* __restrict__ kpool,
                             const unsigned char* __restrict__ vpool,
                             const float* __restrict__ kscale,
                             const float* __restrict__ vscale,
                             const int* __restrict__ table,
                             const int* __restrict__ lens,
                             const int* __restrict__ offs,
                             float* __restrict__ part, int w, int hq,
                             int hkv, int d, int dv, int bs, int mb,
                             int nparts, float scale, int io_type) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int p = blockIdx.z;
  const int length = lens[b];
  const int j0 = p * kSlots;
  const int live = live_slots(length, bs, mb);
  if (j0 >= live) return;          // dead partition: the merge skips it
  const int nslots = min(kSlots, live - j0);
  const int groups = hq / hkv;
  const int rows = w * groups;
  const bool quant = kscale != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kB = Pool<PT>::kBytes;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(rows, d, dv, bs, PT);
  unsigned char* k_t = smem;                          // [kSlots][bs][kstride]
  unsigned char* v_t = k_t + (long long)kSlots * bs * L.kstride;
  float* q_s = reinterpret_cast<float*>(smem + L.tiles);  // [rows][d]
  float* p_s = q_s + rows * d;         // [rows][bs] scores, then p
  float* acc_s = p_s + rows * bs;      // [rows][dv] acc sum
  float* acc_c = acc_s + rows * dv;    // [rows][dv] acc carry
  float* m_s = acc_c + rows * dv;      // [rows]
  float* l_s = m_s + rows;             // [rows] l sum
  float* l_c = l_s + rows;             // [rows] l carry
  float* corr_s = l_c + rows;          // [rows]
  float* ks_s = corr_s + rows;         // [kSlots][bs]
  float* vs_s = ks_s + kSlots * bs;    // [kSlots][bs]

  // every slot's tiles in flight at once, one commit group per slot
  const long long tok_stride = (long long)hkv * d * kB;
  const long long vtok_stride = (long long)hkv * dv * kB;
  for (int s = 0; s < kSlots; ++s) {
    if (s < nslots) {
      const long long blk = table[(long long)b * mb + j0 + s];
      stage_rows(k_t + (long long)s * bs * L.kstride,
                 kpool + ((blk * bs) * hkv + h) * (long long)d * kB,
                 tok_stride, L.kstride, d * kB, bs);
      stage_rows(v_t + (long long)s * bs * L.vstride,
                 vpool + ((blk * bs) * hkv + h) * (long long)dv * kB,
                 vtok_stride, L.vstride, dv * kB, bs);
      if (quant) {
        for (int t = threadIdx.x; t < bs; t += kThreads) {
          cp_async4(ks_s + s * bs + t, kscale + (blk * bs + t) * hkv + h);
          cp_async4(vs_s + s * bs + t, vscale + (blk * bs + t) * hkv + h);
        }
      }
    }
    cp_async_commit();
  }

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
  const int off = offs[b];
  const int hd = d >> 1;

  for (int s = 0; s < nslots; ++s) {
    cp_async_wait(kSlots - 1 - s);     // this slot's group has landed
    __syncthreads();
    const int j = j0 + s;
    const unsigned char* kt = k_t + (long long)s * bs * L.kstride;
    const unsigned char* vt = v_t + (long long)s * bs * L.vstride;

    // scores s[r][t] = (q_r . k_t) * scale [* kscale_t], masked: lanes
    // 0-15 sum e < D/2 and lanes 16-31 the rest for 16 pairs (r, t)
    const int pairs = rows * bs;
    for (int base = warp * 16; base < pairs; base += kWarps * 16) {
      const int i = base + (lane & 15);
      const int half = lane >> 4;
      const int r = i / bs, t = i - r * bs;
      float dot = 0.0f;
      if (i < pairs)
        dot = span_dot<PT>(q_s + r * d, kt + t * L.kstride, half ? hd : 0,
                           half ? d : hd);
      dot = __fadd_rn(dot, __shfl_xor_sync(kFull, dot, 16));
      if (i < pairs && half == 0) {
        float sv = __fmul_rn(dot, scale);
        if (quant) sv = __fmul_rn(sv, ks_s[s * bs + t]);
        const int limit = off + 1 + r / groups;
        p_s[i] = (j * bs + t < limit) ? sv : kNegInf;
      }
    }
    __syncthreads();

    // per row (one warp): running max, p = exp(s - m_new) * mask, corr,
    // l update; p_s[r][t] becomes p (times vscale for quantized pools)
    for (int r = warp; r < rows; r += kWarps) {
      float* pr = p_s + r * bs;
      const int limit = off + 1 + r / groups;
      const float m_prev = m_s[r];
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = pmax(mx, pr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = pmax(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = pmax(m_prev, mx);
      float p_sum = 0.0f;
      for (int t = lane; t < bs; t += 32) {
        const float mask = (j * bs + t < limit) ? 1.0f : 0.0f;
        const float pv = __fmul_rn(expf(__fsub_rn(pr[t], m_new)), mask);
        p_sum = __fadd_rn(p_sum, pv);
        pr[t] = quant ? __fmul_rn(pv, vs_s[s * bs + t]) : pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        p_sum = __fadd_rn(p_sum, __shfl_xor_sync(kFull, p_sum, o));
      const float corr = expf(__fsub_rn(m_prev, m_new));
      __syncwarp();
      if (lane == 0) {
        rescale_add(l_s[r], l_c[r], corr, p_sum);
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc[r][e] <- neumaier(acc * corr, carry * corr, sum_t p[r][t] v[t][e])
    for (int i = threadIdx.x; i < rows * dv; i += kThreads) {
      const int r = i / dv, e = i - r * dv;
      const float* pr = p_s + r * bs;
      float pv = 0.0f;
      for (int t = 0; t < bs; ++t)
        pv = __fmaf_rn(pr[t], Pool<PT>::at(vt + t * L.vstride, e), pv);
      rescale_add(acc_s[i], acc_c[i], corr_s[r], pv);
    }
  }
  __syncthreads();

  const int stride = rows * (3 + 2 * dv);
  float* st = part + (((long long)b * hkv + h) * nparts + p) * stride;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    st[r] = m_s[r];
    st[rows + r] = l_s[r];
    st[2 * rows + r] = l_c[r];
  }
  for (int i = threadIdx.x; i < rows * dv; i += kThreads) {
    st[3 * rows + i] = acc_s[i];
    st[3 * rows + rows * dv + i] = acc_c[i];
  }
}

// (s, c) += (x, y): TwoSum of the sums, the carries added to the carry
__device__ __forceinline__ void fold(float& s, float& c, float x, float y) {
  const Pair t = twosum(s, x);
  s = t.s;
  c = __fadd_rn(c, __fadd_rn(t.c, y));
}

// grid (B, Hkv): out[b, wi, h*groups+g, e] from the live partitions of
// (b, h), folded in partition index order.
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ part,
                             const int* __restrict__ lens,
                             void* __restrict__ out, int w, int hq, int hkv,
                             int dv, int bs, int mb, int nparts,
                             int io_type) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int groups = hq / hkv;
  const int rows = w * groups;
  const int live = (live_slots(lens[b], bs, mb) + kSlots - 1) / kSlots;
  const int stride = rows * (3 + 2 * dv);
  const float* base = part + ((long long)b * hkv + h) * nparts * stride;
  for (int i = threadIdx.x; i < rows * dv; i += kThreads) {
    const int r = i / dv, e = i - r * dv;
    float m = kNegInf;
    for (int p = 0; p < live; ++p) m = pmax(m, base[(long long)p * stride + r]);
    float ls = 0.0f, lc = 0.0f, as = 0.0f, ac = 0.0f;
    for (int p = 0; p < live; ++p) {
      const float* st = base + (long long)p * stride;
      const float corr = expf(__fsub_rn(st[r], m));
      fold(ls, lc, __fmul_rn(st[rows + r], corr),
           __fmul_rn(st[2 * rows + r], corr));
      fold(as, ac, __fmul_rn(st[3 * rows + i], corr),
           __fmul_rn(st[3 * rows + rows * dv + i], corr));
    }
    const float l = fmaxf(__fadd_rn(ls, lc), 1e-30f);
    const float o = __fdiv_rn(__fadd_rn(as, ac), l);
    const int wi = r / groups, g = r % groups;
    const long long idx =
        (((long long)b * w + wi) * hq + h * groups + g) * dv + e;
    if (io_type == IO_BF16) {
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(o);
    } else {
      static_cast<float*>(out)[idx] = o;
    }
  }
}

template <int PT>
int launch_split(const void* q, const void* kpool, const void* vpool,
                 const void* kscale, const void* vscale, const void* table,
                 const void* lens, const void* offs, float* part, int batch,
                 int w, int hq, int hkv, int d, int dv, int bs, int mb,
                 int nparts, float scale, int io_type, long long smem,
                 cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_split_kernel<PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(batch, hkv, nparts);
  paged_attention_split_kernel<PT><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const unsigned char*>(kpool),
      static_cast<const unsigned char*>(vpool),
      static_cast<const float*>(kscale), static_cast<const float*>(vscale),
      static_cast<const int*>(table), static_cast<const int*>(lens),
      static_cast<const int*>(offs), part, w, hq, hkv, d, dv, bs, mb, nparts,
      scale, io_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Table slots per partition (the wrapper sizes its scratch with it).
int repro_paged_attention_slots() { return kSlots; }

// Shared memory (bytes) the split kernel needs for one partition.
long long repro_paged_attention_smem(int rows, int d, int dv, int bs,
                                     int pool_type) {
  return layout(rows, d, dv, bs, pool_type).total;
}

// Launch the split and the merge kernel on `stream`; kscale / vscale are
// null for unquantized pools; part is the f32 scratch of
// B * Hkv * ceil(mb / kSlots) * rows * (3 + 2 dv) floats. Returns the
// first nonzero cudaGetLastError().
int repro_paged_attention(const void* q, const void* kpool, const void* vpool,
                          const void* kscale, const void* vscale,
                          const void* table, const void* lens,
                          const void* offs, void* out, void* part, int batch,
                          int w, int hq, int hkv, int d, int dv, int bs,
                          int mb, float scale, int pool_type, int io_type,
                          void* stream) {
  const int rows = w * (hq / hkv);
  const int nparts = (mb + kSlots - 1) / kSlots;
  const long long smem = layout(rows, d, dv, bs, pool_type).total;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(part);
  int err;
  switch (pool_type) {
    case POOL_BF16:
      err = launch_split<POOL_BF16>(q, kpool, vpool, kscale, vscale, table,
                                    lens, offs, scratch, batch, w, hq, hkv,
                                    d, dv, bs, mb, nparts, scale, io_type,
                                    smem, st);
      break;
    case POOL_F32:
      err = launch_split<POOL_F32>(q, kpool, vpool, kscale, vscale, table,
                                   lens, offs, scratch, batch, w, hq, hkv, d,
                                   dv, bs, mb, nparts, scale, io_type, smem,
                                   st);
      break;
    case POOL_INT8:
      err = launch_split<POOL_INT8>(q, kpool, vpool, kscale, vscale, table,
                                    lens, offs, scratch, batch, w, hq, hkv,
                                    d, dv, bs, mb, nparts, scale, io_type,
                                    smem, st);
      break;
    default:
      err = launch_split<POOL_FP8>(q, kpool, vpool, kscale, vscale, table,
                                   lens, offs, scratch, batch, w, hq, hkv, d,
                                   dv, bs, mb, nparts, scale, io_type, smem,
                                   st);
      break;
  }
  if (err) return err;
  dim3 grid(batch, hkv);
  paged_attention_merge_kernel<<<grid, kThreads, 0, st>>>(
      scratch, static_cast<const int*>(lens), out, w, hq, hkv, dv, bs, mb,
      nparts, io_type);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
