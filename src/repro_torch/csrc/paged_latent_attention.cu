// Paged-attention superkernel, MLA latent form, for Hopper (sm_90a), on
// the bf16 tensor cores.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py,
// `_super_kernel` (mla=True) launched by `paged_latent_attention_pallas`.
// MLA decode is MQA-like: the W*H query rows of a sequence (row
// r = w * H + h) all attend ONE latent stream through the block table.
// Row r sees keys at positions < q_offsets[b] + 1 + r / H. Scores have two
// parts, s = (q_lat . c_kv + q_rope . k_rope) * scale, and the value IS
// the c_kv latent. int8 / fp8 pools carry one f32 scale per cached token
// for each stream: s = (q_lat . c_kv * cs + q_rope . k_rope * rs) * scale,
// and p is scaled by cs (the c_kv scale) before the PV product while the
// normaliser sums the unscaled p. l and acc are Neumaier (sum, carry)
// pairs; every rescale multiplies sum AND carry. The output is the f32
// context latent [B, W, H, C]; the caller applies the absorbed value
// projection. `scale` is passed: (nope + rope)^-0.5, not derivable from C.
//
// Bound: bytes. At the deepseek-v2 decode shape (B = 8, W = 1, H = 128,
// C = 512, R = 64, bs = 16, 2304 live tokens, bf16 pools) the call must
// move 7.04 MB (the live latent blocks once, the queries and the output),
// 0.0021 ms at 3.35 TB/s; its products, three bf16 tensor-core passes for
// the latent scores and for P V and three for the rope scores, are 1.85
// GFLOP, 0.0019 ms at 989 TFLOP/s (H100 SXM data sheet, 700 W). On the
// CUDA cores the f32 products alone would take 0.0096 ms.
//
// Products on the tensor cores, exact operand planes: a bf16 c_kv / k_rope
// tile is one bf16 plane; int8 and e4m3 payloads are exact in bf16 and
// are widened once into a bf16 tile; an f32 pool becomes three planes
// (hi, mid, lo: wgmma_common.cuh). The f32 absorbed query q_lat and
// q_rope enter as three planes each (a bf16 query splits into itself and
// two zero planes), and so does p for the P V product, split in
// registers (the register-A operand). With a one-plane pool each product
// is three passes, every plane product of the exact split; with an f32
// pool the six a_i.b_j with i + j <= 2. The tensor core's accumulation is
// not round-to-nearest, so hi.hi (the largest) has its own accumulator
// and the smaller products another; the two add round-to-nearest.
//
// Design: a fixed split over table slots, two kernels, as the GQA form's
// (paged_attention.cu).
// * split: grid (B, ceil(W*H / 64), ceil(mb / kSlots)), two warpgroups
//   per CTA on 64 query rows and partition p = table slots [p kSlots,
//   (p + 1) kSlots); a partition whose first slot starts at or past
//   lens[b] (or the table width) is dead and does nothing. It walks its
//   slots in GROUPS of KG padded keys (64 for one-plane pools, 16 for f32
//   pools; each slot padded to a multiple of 16 keys). A group's c_kv and
//   k_rope tiles reach shared memory ONCE (16-byte cp.async for bf16,
//   widened or split through registers otherwise), in the 128-byte
//   swizzle, and serve both products: the scores read c_kv K-major, P V
//   reads the same tile MN-major. Scores: the 64 x KG tile, q planes x
//   c_kvᵀ over C in 64-wide panels, then q_rope x k_ropeᵀ; the raw q
//   panels arrive by cp.async three ahead and each is split into its
//   planes while the products of the panel before run. Both warpgroups
//   compute the same scores and softmax, in registers: m_new = max(m,
//   the group's max), corr = exp(m - m_new), p = exp(s - m_new) * mask;
//   then per SLOT of the group, in order, the Neumaier fold l <- (l *
//   corr, lc * corr) + sum p and acc <- (acc * corr, carry * corr) + P V,
//   with corr for the group's first slot and 1 for the others. p's
//   planes go to shared memory (the A operand); the warpgroups take the
//   64-column chunks of C in turn, each slot's P V in fresh accumulators
//   (scale-d 0) folded in registers, and each chunk's sums and carries
//   pass through shared memory so that the scratch stores are 16-byte
//   and coalesced (scattered fragment stores took half the split's time;
//   with more than one group the partition's accumulators wait in the
//   scratch between groups). The partition writes its (m, l_s, l_c,
//   acc_s, acc_c) per row to an f32 scratch.
// * merge: grid (B, W*H). Each output element folds the live partitions
//   in partition index order: m is their max, each partition's sum AND
//   carry are scaled by exp(m_p - m) and TwoSum-folded, and out = (acc_s
//   + acc_c) / max(l_s + l_c, 1e-30); four columns a thread, eight
//   partitions' loads in flight.
// * chunks: the two kernels run once per chunk of kChunk partitions
//   (absolute indices, 128 table slots), so the scratch holds one chunk,
//   B * min(partitions, kChunk) * (3 + 2 C) * W*H floats (~0.5 MB per
//   partition per sequence at deepseek-v2's widths), whatever the
//   context. Past one chunk the merge folds the chunk into a state of
//   the chunks before it (one more partition's room per sequence), and
//   the last chunk writes the output. A table of at most 128 slots is one
//   chunk, one split and one merge launch.
// The partitions and chunks depend only on the absolute slot index,
// never on W, B, the table width or the other sequences; a row's scores, softmax chain
// and output are the same code whatever CTA, row tile or partition holds
// it, and a tensor-core output element depends only on its own row and
// column. A key masked for a row (or a group, partition or chunk whose
// keys are all masked for it) is an exact identity update. So, bitwise: row w of
// a width-W call equals the width-1 call at q_offsets + w; a sequence
// alone equals the same sequence inside a batch; a table of mb slots
// equals a wider one holding the same slots.
//
// The compensated chains use __fmul_rn / __fadd_rn (no FMA contraction)
// and the IEEE expf; NEG_INF is the reference's finite -1e30.
//
// It replaces a first design (grid (B, W*H / 16), every product on the
// CUDA cores, each 16-row block re-reading the sequence's whole table;
// times of both in PERF.md).
//
// ptxas (sm_90a, -O3, CUDA 12.8): the split kernel 231-236 registers
// over the four pool types, the merge 93; no stack frame (so no spill);
// 170 HGMMA instructions. chip_smoke.py's build phase reads them from
// the built library and fails on a spill.

#include "superkernel_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kRows = 64;          // query rows per CTA (the wgmma M)
constexpr int kRawQ = kRows * 64 * 4;  // a raw q panel: 64 rows x 64 f32
constexpr int kMergeThreads = 128;
constexpr int kStageRow = 68;      // floats per staged accumulator row
constexpr int kPanel = kRows * 128;    // 64 rows x 64 bf16, swizzled
constexpr int kMaxC = 512;
constexpr int kMaxR = 64;
constexpr int kSlots = 4;          // table slots per partition
constexpr int kChunk = 32;         // partitions per split launch
constexpr unsigned kFull = 0xffffffffu;

template <int PT>
struct Geo {
  static constexpr int PC = planes<PT>();       // c_kv / k_rope planes
  static constexpr int KG = PC == 3 ? 16 : 64;  // padded keys per group
};

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }

// Shared memory of the split kernel, from a 1024-aligned base: c_kv
// planes [PC][nC panels][KG rows][128 B], k_rope planes [PC][KG][128 B],
// two q plane slots [3 planes][64 rows][128 B], three raw q slots [64
// rows][64] (f32 or bf16, as the query comes), the p planes [3][64 rows]
// [128 B], the group's scales.
struct Smem {
  int ck_plane, kr_off, kr_plane, q_off, raw_off, p_off, cs_off, total;
};

__host__ __device__ inline Smem smem_layout(int pc, int kg, int c) {
  Smem L;
  const int npc = (c + 63) / 64;
  L.ck_plane = npc * kg * 128;
  L.kr_off = pc * L.ck_plane;
  L.kr_plane = kg * 128;
  // the q slots follow: with KG = 16 the score product's 64-key B operand
  // reads past the last k_rope panel into them (columns masked)
  L.q_off = (L.kr_off + pc * L.kr_plane + 1023) & ~1023;
  L.raw_off = L.q_off + 2 * 3 * kPanel;
  L.p_off = L.raw_off + 3 * kRawQ;
  L.cs_off = L.p_off + 3 * kPanel;
  L.total = 1024 + L.cs_off + 2 * 64 * 4;
  return L;
}

__device__ __forceinline__ int live_slots(int length, int bs, int mb) {
  return length <= 0 ? 0 : min(mb, (length + bs - 1) / bs);
}

__device__ __forceinline__ void fence_all(float (&a)[32], float (&b)[32],
                                          float (&c)[32]) {
  fence_regs(a);
  fence_regs(b);
  fence_regs(c);
}

// q: [B, rows, C] / [B, W*H, R]; pools [nb, bs, C] / [nb, bs, R]; scales
// [nb, bs]; table [B, mb]; lens, offs [B]; part [B, npa, round_up(3 rows,
// 4) + 2 rows C] f32 (m, l_s, l_c per row, padded to 16 bytes, then acc_s
// and acc_c per element, row-major): partition p0 + z of the chunk in
// slot z.
template <int PT>
__global__ void __launch_bounds__(kThreads, 1)
paged_latent_attention_split_kernel(
    const void* __restrict__ q_lat, const void* __restrict__ q_rope,
    const unsigned char* __restrict__ ck_pool,
    const unsigned char* __restrict__ kr_pool,
    const float* __restrict__ ck_scale, const float* __restrict__ kr_scale,
    const int* __restrict__ table, const int* __restrict__ lens,
    const int* __restrict__ offs, float* __restrict__ part, int rows, int h,
    int c, int r, int bs, int mb, int p0, int npa, float scale, int ql_type,
    int qr_type) {
  constexpr int PC = Geo<PT>::PC, KG = Geo<PT>::KG;
  constexpr int E = esize<PT>();
  constexpr int NJ = KG / 8;           // n8 blocks of the group's keys
  constexpr int NK = KG / 16;          // k16 steps of the group's keys
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int p = p0 + blockIdx.z;
  // loaded values broadcast from lane 0, so that ptxas sees the loops
  // around the products are warpgroup-uniform
  const int length = __shfl_sync(kFull, lens[b], 0);
  const int live = live_slots(length, bs, mb);
  const int j0 = p * kSlots;
  const int bsp = pad16(bs);           // a slot's keys, padded
  const int gs = KG / bsp;             // slots per group
  if (j0 >= live || gs == 0) return;   // dead partition: the merge skips it
  const int jend = min(j0 + kSlots, live);
  const bool quant = ck_scale != nullptr;
  const int npc = (c + 63) / 64;       // 64-wide panels of C
  const Smem L = smem_layout(PC, KG, c);

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  const unsigned ck_s = base;
  const unsigned kr_s = base + L.kr_off;
  const unsigned q_s = base + L.q_off;
  float* const cs_s =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L.cs_off);
  float* const rs_s = cs_s + 64;

  const int tid = threadIdx.x;
  // the warpgroup index, broadcast so that ptxas sees it is uniform
  const int wg = __shfl_sync(kFull, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);      // rows r_lo, r_lo + 8
  const int c_lane = 2 * (lane & 3);
  const int off = __shfl_sync(kFull, offs[b], 0);
  int limit[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    limit[hh] = off + 1 + (row0 + r_lo + 8 * hh) / h;
  const long long hdr = (3LL * rows + 3) & ~3LL;   // m, l_s, l_c, padded
  const long long stride = hdr + 2LL * rows * c;
  float* const st =
      part + (static_cast<long long>(b) * npa + blockIdx.z) * stride;

  // q panel kp (the C panels, then the rope panel): 64 rows x 64
  // columns of q_lat or q_rope, raw (f32 or bf16) by 16-byte cp.async into
  // raw slot rs, zero past the rows and the width
  auto issue_q = [&](int kp, int rs) {
    const bool lat = kp < npc;
    const int es = (lat ? ql_type : qr_type) == IO_F32 ? 4 : 2;
    const unsigned char* src = static_cast<const unsigned char*>(
        lat ? q_lat : q_rope);
    const int width = lat ? c : r;
    const int col0 = lat ? 64 * kp : 0;
    const int per = 64 * es / 16;            // 16-byte chunks a row
    const unsigned dst = q_s + 6 * kPanel + rs * kRawQ;
    for (int i = tid; i < kRows * per; i += kThreads) {
      const int rr = i / per, cc = i - rr * per;
      const int row = row0 + rr, col = col0 + cc * 16 / es;
      const bool ok = row < rows && col < width;
      cp_async16_zfill(
          dst + rr * 64 * es + cc * 16,
          ok ? src + ((static_cast<long long>(b) * rows + row) * width + col) *
                         es
             : src,
          ok ? 16 : 0);
    }
  };
  // raw slot rs (panel kp) -> its bf16 planes in plane slot ps
  auto split_q = [&](int kp, int rs, int ps) {
    const bool f32 = (kp < npc ? ql_type : qr_type) == IO_F32;
    const unsigned src = q_s + 6 * kPanel + rs * kRawQ;
    const unsigned dst = q_s + ps * 3 * kPanel;
    for (int i = tid; i < kRows * 8; i += kThreads) {
      const int rr = i >> 3, cc = i & 7;
      uint32_t w[8];
      if (f32) {
        const unsigned at = src + (rr * 64 + 8 * cc) * 4;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                     : "r"(at));
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(w[4]), "=r"(w[5]), "=r"(w[6]), "=r"(w[7])
                     : "r"(at + 16));
      } else {
        uint32_t h[4];
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(h[0]), "=r"(h[1]), "=r"(h[2]), "=r"(h[3])
                     : "r"(src + (rr * 64 + 8 * cc) * 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[2 * e] = h[e] << 16;
          w[2 * e + 1] = h[e] & 0xffff0000u;
        }
      }
      store_planes<POOL_F32>(w, dst + rr * 128 + ((cc ^ (rr & 7)) << 4),
                             kPanel);
    }
  };

  // a group's tiles: padded key t of slot t / bsp; zeros for padding,
  // dead slots and columns past the width
  auto stage_tile = [&](const unsigned char* pool, int width, unsigned dst,
                        int plane, int jg) {
    const int chunks = (width + 63) / 64 * 8;      // 16-byte chunks a row
    for (int i = tid; i < KG * chunks; i += kThreads) {
      const int t = i / chunks, ci = i - t * chunks;
      const int s = t / bsp, within = t - s * bsp, j = jg + s;
      const int col = 8 * ci;
      const bool ok = s < gs && j < jend && within < bs && col < width;
      const long long tok =
          ok ? static_cast<long long>(table[static_cast<long long>(b) * mb +
                                            j]) * bs + within
             : 0;
      const unsigned at = dst + (ci >> 3) * (KG * 128) + t * 128 +
                          (((ci & 7) ^ (t & 7)) << 4);
      const unsigned char* from = pool + (tok * width + col) * E;
      if constexpr (PT == POOL_BF16) {
        cp_async16_zfill(at, ok ? from : pool, ok ? 16 : 0);
      } else {
        uint32_t w[2 * E];
#pragma unroll
        for (int e = 0; e < 2 * E; ++e) w[e] = 0u;
        if (ok) {
          if constexpr (E == 1) {
            const uint2 v = *reinterpret_cast<const uint2*>(from);
            w[0] = v.x, w[1] = v.y;
          } else {
            const uint4 a = reinterpret_cast<const uint4*>(from)[0];
            const uint4 v = reinterpret_cast<const uint4*>(from)[1];
            w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
            w[4] = v.x, w[5] = v.y, w[6] = v.z, w[7] = v.w;
          }
        }
        store_planes<PT>(w, at, plane);
      }
    }
  };

  float m[2] = {kNegInf, kNegInf};
  float l_s[2] = {0.0f, 0.0f}, l_c[2] = {0.0f, 0.0f};

  for (int jg = j0; jg < jend; jg += gs) {
    const bool first_group = jg == j0;
    // ---- stage the group's c_kv / k_rope tiles and scales; raw q panels
    // three ahead, each split into its planes while the products of the
    // panel before run. cp.async groups, in order: the tiles, then one
    // per q panel (empty past the last), so that "all but the newest
    // two" is always the next panel
    const int npt = npc + 1;
    stage_tile(ck_pool, c, ck_s, L.ck_plane, jg);
    stage_tile(kr_pool, r, kr_s, L.kr_plane, jg);
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < npt) issue_q(k, k);
      cp_async_commit();
    }
    if (tid < 64) {
      const int s = tid / bsp, within = tid - s * bsp, j = jg + s;
      const bool ok = quant && tid < KG && s < gs && j < jend && within < bs;
      const long long tok =
          ok ? static_cast<long long>(table[static_cast<long long>(b) * mb +
                                            j]) * bs + within
             : 0;
      cs_s[tid] = ok ? ck_scale[tok] : 0.0f;
      rs_s[tid] = ok ? kr_scale[tok] : 0.0f;
    }
    cp_async_wait<2>();                // the tiles and q panel 0
    __syncthreads();
    split_q(0, 0, 0);
    fence_proxy_async();
    __syncthreads();

    // ---- scores: big = q_hi . ck_hi, small = the other latent products
    // (smallest first), rope = every rope product (smallest first); both
    // warpgroups compute the same scores
    float sb[32], ss[32], sr[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sb[i] = ss[i] = sr[i] = 0.0f;
    for (int kp = 0; kp < npt; ++kp) {
      const unsigned qb = q_s + (kp & 1) * 3 * kPanel;
      const bool lat = kp < npc;
      fence_all(sb, ss, sr);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint64_t dq[3], dk[PC];
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          dq[pl] = make_desc(qb + pl * kPanel + kk * 32, 16, 1024);
        if (lat) {
          const int first = kp == 0 && kk == 0;
#pragma unroll
          for (int pl = 0; pl < PC; ++pl)
            dk[pl] = make_desc(ck_s + pl * L.ck_plane + kp * (KG * 128) +
                                   kk * 32,
                               16, 1024);
          if constexpr (PC == 3) {
            wgmma_ss(ss, dq[2], dk[0], !first);
            wgmma_ss(ss, dq[1], dk[1], 1);
            wgmma_ss(ss, dq[0], dk[2], 1);
            wgmma_ss(ss, dq[1], dk[0], 1);
            wgmma_ss(ss, dq[0], dk[1], 1);
          } else {
            wgmma_ss(ss, dq[2], dk[0], !first);
            wgmma_ss(ss, dq[1], dk[0], 1);
          }
          wgmma_ss(sb, dq[0], dk[0], !first);
        } else {
          const int first = kk == 0;
#pragma unroll
          for (int pl = 0; pl < PC; ++pl)
            dk[pl] = make_desc(kr_s + pl * L.kr_plane + kk * 32, 16, 1024);
          if constexpr (PC == 3) {
            wgmma_ss(sr, dq[2], dk[0], !first);
            wgmma_ss(sr, dq[1], dk[1], 1);
            wgmma_ss(sr, dq[0], dk[2], 1);
            wgmma_ss(sr, dq[1], dk[0], 1);
            wgmma_ss(sr, dq[0], dk[1], 1);
            wgmma_ss(sr, dq[0], dk[0], 1);
          } else {
            wgmma_ss(sr, dq[2], dk[0], !first);
            wgmma_ss(sr, dq[1], dk[0], 1);
            wgmma_ss(sr, dq[0], dk[0], 1);
          }
        }
      }
      wgmma_commit();
      if (kp + 1 < npt) {
        // raw slot kp % 3 was split before the last barrier
        if (kp + 3 < npt) issue_q(kp + 3, kp % 3);
        cp_async_commit();
        cp_async_wait<2>();            // q panel kp + 1 has landed
        wgmma_wait1();                 // the products of kp - 1 are done
        __syncthreads();               // in every warp: slot kp + 1 is free
        split_q(kp + 1, (kp + 1) % 3, (kp + 1) & 1);
        fence_proxy_async();
        __syncthreads();
      }
    }
    wgmma_wait0();
    fence_all(sb, ss, sr);

    // ---- softmax over the group: scores, mask, the group's max
    float gmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = 8 * (i >> 2) + c_lane + (i & 1);
      const int hh = (i >> 1) & 1;
      const int s = t / bsp, within = t - s * bsp, j = jg + s;
      const bool ok = s < gs && j < jend && within < bs &&
                      j * bs + within < limit[hh];
      const float lat = __fadd_rn(sb[i], ss[i]);
      const float sum =
          quant ? __fadd_rn(__fmul_rn(lat, cs_s[t & 63]),
                            __fmul_rn(sr[i], rs_s[t & 63]))
                : __fadd_rn(lat, sr[i]);
      sb[i] = ok ? __fmul_rn(sum, scale) : kNegInf;
      ss[i] = ok ? 1.0f : 0.0f;                   // the mask
      gmax[hh] = pmax(gmax[hh], sb[i]);
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      gmax[hh] = pmax(gmax[hh], __shfl_xor_sync(kFull, gmax[hh], 1));
      gmax[hh] = pmax(gmax[hh], __shfl_xor_sync(kFull, gmax[hh], 2));
      const float m_new = pmax(m[hh], gmax[hh]);
      corr[hh] = expf(__fsub_rn(m[hh], m_new));
      m[hh] = m_new;
    }
    // p (unscaled, for l) in sb; p times the c_kv scale (for P V) in sr
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int t = 8 * (i >> 2) + c_lane + (i & 1);
      sb[i] = __fmul_rn(expf(__fsub_rn(sb[i], m[hh])), ss[i]);
      sr[i] = quant ? __fmul_rn(sb[i], cs_s[t & 63]) : sb[i];
    }
    // l: per live slot of the group, in order
    for (int s = 0; s < gs && jg + s < jend; ++s) {
      float ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jb = 0; jb < NJ; ++jb)
        if (jb * 8 >= s * bsp && jb * 8 < (s + 1) * bsp) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            ps[u >> 1] = __fadd_rn(ps[u >> 1], sb[4 * jb + u]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        ps[hh] = __fadd_rn(ps[hh], __shfl_xor_sync(kFull, ps[hh], 1));
        ps[hh] = __fadd_rn(ps[hh], __shfl_xor_sync(kFull, ps[hh], 2));
        rescale_add(l_s[hh], l_c[hh], s == 0 ? corr[hh] : 1.0f, ps[hh]);
      }
    }
    // P planes into shared memory (both warpgroups hold the same p; the
    // first writes), the K-major A operand of P V
    const unsigned p_s = base + L.p_off;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int t = 8 * (i >> 2) + c_lane;
        const int rr = r_lo + 8 * ((i >> 1) & 1);
        float h0, m0, o0, h1, m1, o1;
        split3(sr[i], h0, m0, o0);
        split3(sr[i + 1], h1, m1, o1);
        const unsigned at = p_s + rr * 128 + (((t >> 3) ^ (rr & 7)) << 4) +
                            (t & 7) * 2;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16(h0, h1)) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + kPanel),
                     "r"(pack_bf16(m0, m1)) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 2 * kPanel),
                     "r"(pack_bf16(o0, o1)) : "memory");
      }
    }
    fence_proxy_async();
    __syncthreads();

    // ---- P V over C in 64-column chunks (the warpgroups alternate),
    // per slot, folded
    for (int ch = wg; ch < npc; ch += 2) {
      float as[32], ac[32], pvb[32], pvs[32];
      float* const acc_s_g = st + hdr;
      float* const acc_c_g = acc_s_g + static_cast<long long>(rows) * c;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        as[i] = ac[i] = 0.0f;
        pvb[i] = pvs[i] = 0.0f;
      }
      if (!first_group) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = row0 + r_lo + 8 * ((i >> 1) & 1);
          const int col = 64 * ch + 8 * (i >> 2) + c_lane;
          if (row < rows && col < c) {
            const long long at = static_cast<long long>(row) * c + col;
            as[i] = acc_s_g[at], as[i + 1] = acc_s_g[at + 1];
            ac[i] = acc_c_g[at], ac[i + 1] = acc_c_g[at + 1];
          }
        }
      }
      for (int s = 0; s < gs && jg + s < jend; ++s) {
        fence_regs(pvb);
        fence_regs(pvs);
        wgmma_fence();
        const int k0 = s * bsp / 16, k1 = (s + 1) * bsp / 16;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (kk < k0 || kk >= k1) continue;
          const int first = kk == k0;
          uint64_t dv[PC];
#pragma unroll
          for (int pl = 0; pl < PC; ++pl)
            dv[pl] = make_desc(ck_s + pl * L.ck_plane + ch * (KG * 128) +
                                   kk * (16 * 128),
                               1024, 1024);
          uint64_t dp[3];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            dp[pl] = make_desc(p_s + pl * kPanel + kk * 32, 16, 1024);
          if constexpr (PC == 3) {
            wgmma_ss_tb(pvs, dp[2], dv[0], !first);
            wgmma_ss_tb(pvs, dp[1], dv[1], 1);
            wgmma_ss_tb(pvs, dp[0], dv[2], 1);
            wgmma_ss_tb(pvs, dp[1], dv[0], 1);
            wgmma_ss_tb(pvs, dp[0], dv[1], 1);
          } else {
            wgmma_ss_tb(pvs, dp[2], dv[0], !first);
            wgmma_ss_tb(pvs, dp[1], dv[0], 1);
          }
          wgmma_ss_tb(pvb, dp[0], dv[0], !first);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(pvb);
        fence_regs(pvs);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          rescale_add(as[i], ac[i], s == 0 ? corr[(i >> 1) & 1] : 1.0f,
                      __fadd_rn(pvb[i], pvs[i]));
      }
      // the chunk's sums and carries to the scratch through shared memory
      // (the q buffers, idle during P V; each warpgroup its own part), so
      // that the global stores are 16 bytes a thread and coalesced
      float* const stage = reinterpret_cast<float*>(
          smem_raw + (base - raw) + L.q_off) + wg * (2 * 64 * kStageRow);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int rr = r_lo + 8 * ((i >> 1) & 1);
        const int cc = 8 * (i >> 2) + c_lane;
        *reinterpret_cast<float2*>(stage + rr * kStageRow + cc) =
            make_float2(as[i], as[i + 1]);
        *reinterpret_cast<float2*>(stage + (64 + rr) * kStageRow + cc) =
            make_float2(ac[i], ac[i + 1]);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int wt = tid & 127;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int q = wt + 128 * k;          // 2 x 64 rows x 16 chunks of 4
        const int half = q >> 10, rr = (q >> 4) & 63, cc = 4 * (q & 15);
        const int row = row0 + rr, col = 64 * ch + cc;
        if (row < rows && col < c)
          *reinterpret_cast<float4*>(
              (half ? acc_c_g : acc_s_g) + static_cast<long long>(row) * c +
              col) = *reinterpret_cast<const float4*>(
              stage + (64 * half + rr) * kStageRow + cc);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    __syncthreads();                   // the tiles are free for the next group
  }

  if (wg == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + r_lo + 8 * hh;
      if (row < rows) {
        st[row] = m[hh];
        st[rows + row] = l_s[hh];
        st[2 * rows + row] = l_c[hh];
      }
    }
  }
}

// (s, c) += (x, y): TwoSum of the sums, the carries added to the carry
__device__ __forceinline__ void fold(float& s, float& c, float x, float y) {
  const Pair t = twosum(s, x);
  s = t.s;
  c = __fadd_rn(c, __fadd_rn(t.c, y));
}

// grid (B, rows): the live partitions of b among [p0, p0 + np), folded
// in partition index order after the state of the partitions before p0
// (when p0 > 0 and b has any): the last chunk of the table writes out[b,
// row, :] = (acc_s + acc_c) / max(l_s + l_c, 1e-30), the others the
// state, which has a partition's layout; each scale exp(m_p - m) once in
// shared memory, four columns a thread, and eight partitions' loads in
// flight at a time. A chunk with no live partition leaves the state as it
// is (the last one copies it exactly: exp(0) = 1, and a fold into (0, 0)
// is exact).
__global__ void __launch_bounds__(kMergeThreads)
paged_latent_attention_merge_kernel(const float* __restrict__ part,
                                    float* __restrict__ state,
                                    const int* __restrict__ lens,
                                    float* __restrict__ out, int rows, int c,
                                    int bs, int mb, int p0, int np, int npa,
                                    int last) {
  extern __shared__ float corr_s[];           // [np]
  const int b = blockIdx.x;
  const int row = blockIdx.y;
  const int all = (live_slots(lens[b], bs, mb) + kSlots - 1) / kSlots;
  const int live = min(max(all - p0, 0), np);
  if (live == 0 && !last) return;
  const bool held = p0 > 0 && all > 0;        // partitions [0, p0) folded
  const long long hdr = (3LL * rows + 3) & ~3LL;
  const long long stride = hdr + 2LL * rows * c;
  const float* base = part + static_cast<long long>(b) * npa * stride;
  float* const sb = state + static_cast<long long>(b) * stride;
  const float m_h = held ? sb[row] : kNegInf;
  const float ls_h = held ? sb[rows + row] : 0.0f;
  const float lc_h = held ? sb[2 * rows + row] : 0.0f;
  float m = m_h;
  for (int p = 0; p < live; ++p) m = pmax(m, base[p * stride + row]);
  for (int p = threadIdx.x; p < live; p += kMergeThreads)
    corr_s[p] = expf(__fsub_rn(base[p * stride + row], m));
  const float corr_h = held ? expf(__fsub_rn(m_h, m)) : 0.0f;
  __syncthreads();
  float ls = 0.0f, lc = 0.0f;
  if (held) fold(ls, lc, __fmul_rn(ls_h, corr_h), __fmul_rn(lc_h, corr_h));
  for (int p = 0; p < live; ++p) {
    const float* st = base + p * stride;
    fold(ls, lc, __fmul_rn(st[rows + row], corr_s[p]),
         __fmul_rn(st[2 * rows + row], corr_s[p]));
  }
  const float l = fmaxf(__fadd_rn(ls, lc), 1e-30f);
  const long long r_off = hdr + static_cast<long long>(row) * c;
  const long long c_off = static_cast<long long>(rows) * c;
  for (int e = 4 * threadIdx.x; e < c; e += 4 * kMergeThreads) {
    float as[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ac[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (held) {
      const float4 hs = *reinterpret_cast<const float4*>(sb + r_off + e);
      const float4 hc =
          *reinterpret_cast<const float4*>(sb + r_off + c_off + e);
      const float xs[4] = {hs.x, hs.y, hs.z, hs.w};
      const float xc[4] = {hc.x, hc.y, hc.z, hc.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        fold(as[k], ac[k], __fmul_rn(xs[k], corr_h), __fmul_rn(xc[k], corr_h));
    }
    for (int q0 = 0; q0 < live; q0 += 8) {
      float4 vs[8], vc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* st = base + (q0 + u) * stride + r_off + e;
        const bool ok = q0 + u < live;
        vs[u] = ok ? *reinterpret_cast<const float4*>(st)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        vc[u] = ok ? *reinterpret_cast<const float4*>(st + c_off)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u < live) {
          const float cr = corr_s[q0 + u];
          const float xs[4] = {vs[u].x, vs[u].y, vs[u].z, vs[u].w};
          const float xc[4] = {vc[u].x, vc[u].y, vc[u].z, vc[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            fold(as[k], ac[k], __fmul_rn(xs[k], cr), __fmul_rn(xc[k], cr));
        }
    }
    if (last) {
      float4 o;
      o.x = __fdiv_rn(__fadd_rn(as[0], ac[0]), l);
      o.y = __fdiv_rn(__fadd_rn(as[1], ac[1]), l);
      o.z = __fdiv_rn(__fadd_rn(as[2], ac[2]), l);
      o.w = __fdiv_rn(__fadd_rn(as[3], ac[3]), l);
      *reinterpret_cast<float4*>(
          out + (static_cast<long long>(b) * rows + row) * c + e) = o;
    } else {
      *reinterpret_cast<float4*>(sb + r_off + e) =
          make_float4(as[0], as[1], as[2], as[3]);
      *reinterpret_cast<float4*>(sb + r_off + c_off + e) =
          make_float4(ac[0], ac[1], ac[2], ac[3]);
    }
  }
  if (!last && threadIdx.x == 0) {
    sb[row] = m;
    sb[rows + row] = ls;
    sb[2 * rows + row] = lc;
  }
}

__host__ __device__ inline long long part_stride(int rows, int c) {
  return ((3LL * rows + 3) & ~3LL) + 2LL * rows * c;
}

// The table's partitions in chunks of kChunk: per chunk the split kernel
// into the chunk's scratch slots, then the merge into the state (or, for
// the last chunk, the output). The scratch holds one chunk and, when there
// is more than one, the state: its size does not grow with the table.
template <int PT>
int run(const void* q_lat, const void* q_rope, const void* ck_pool,
        const void* kr_pool, const void* ck_scale, const void* kr_scale,
        const void* table, const void* lens, const void* offs, float* out,
        float* part, int batch, int rows, int h, int c, int r, int bs, int mb,
        float scale, int ql_type, int qr_type, cudaStream_t stream) {
  const Smem L = smem_layout(Geo<PT>::PC, Geo<PT>::KG, c);
  cudaError_t e = cudaFuncSetAttribute(
      paged_latent_attention_split_kernel<PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nparts = (mb + kSlots - 1) / kSlots;
  const int npa = nparts < kChunk ? nparts : kChunk;
  float* const state =
      part + static_cast<long long>(batch) * npa * part_stride(rows, c);
  for (int p0 = 0; p0 < nparts; p0 += kChunk) {
    const int np = nparts - p0 < kChunk ? nparts - p0 : kChunk;
    dim3 grid(batch, (rows + kRows - 1) / kRows, np);
    paged_latent_attention_split_kernel<PT><<<grid, kThreads, L.total,
                                              stream>>>(
        q_lat, q_rope, static_cast<const unsigned char*>(ck_pool),
        static_cast<const unsigned char*>(kr_pool),
        static_cast<const float*>(ck_scale),
        static_cast<const float*>(kr_scale), static_cast<const int*>(table),
        static_cast<const int*>(lens), static_cast<const int*>(offs), part,
        rows, h, c, r, bs, mb, p0, npa, scale, ql_type, qr_type);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_latent_attention_merge_kernel<<<dim3(batch, rows), kMergeThreads,
                                          np * sizeof(float), stream>>>(
        part, state, static_cast<const int*>(lens), out, rows, c, bs, mb, p0,
        np, npa, p0 + kChunk >= nparts);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

// Table slots per partition and partitions per chunk (the CPU emulation
// of the tests holds copies, which the GPU tests check).
int repro_paged_latent_attention_slots() { return kSlots; }
int repro_paged_latent_attention_chunk() { return kChunk; }

// f32 scratch (floats) of one call: B * min(ceil(mb / kSlots), kChunk)
// partitions, plus the state (one more per sequence) past one chunk.
long long repro_paged_latent_attention_scratch(int batch, int rows, int c,
                                               int mb) {
  const int nparts = (mb + kSlots - 1) / kSlots;
  const int npa = nparts < kChunk ? nparts : kChunk;
  return static_cast<long long>(batch) * part_stride(rows, c) *
         (npa + (nparts > npa ? 1 : 0));
}

// Shared memory (bytes) of the split kernel, or -1 for a shape it does
// not take: C, R multiples of 8, C <= 512, R <= 64, and a block of bs
// keys, padded to 16, within a group (64 keys for a one-plane pool, 16
// for an f32 pool).
long long repro_paged_latent_attention_smem(int c, int r, int pool_type,
                                            int bs) {
  const int pc = pool_type == POOL_F32 ? 3 : 1;
  const int kg = pc == 3 ? Geo<POOL_F32>::KG : Geo<POOL_BF16>::KG;
  if (c % 8 || r % 8 || c <= 0 || r <= 0 || c > kMaxC || r > kMaxR ||
      bs <= 0 || pad16(bs) > kg)
    return -1;
  return smem_layout(pc, kg, c).total;
}

// Launch the split and the merge kernels on `stream`; ck_scale / kr_scale
// are null for unquantized pools; part is the f32 scratch of
// repro_paged_latent_attention_scratch floats. Returns the first nonzero
// cudaGetLastError().
int repro_paged_latent_attention(const void* q_lat, const void* q_rope,
                                 const void* ck_pool, const void* kr_pool,
                                 const void* ck_scale, const void* kr_scale,
                                 const void* table, const void* lens,
                                 const void* offs, void* out, void* part,
                                 int batch, int w, int h, int c, int r,
                                 int bs, int mb, float scale, int pool_type,
                                 int ql_type, int qr_type, void* stream) {
  const int rows = w * h;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* const o = static_cast<float*>(out);
  float* const scratch = static_cast<float*>(part);
  switch (pool_type) {
    case POOL_BF16:
      return run<POOL_BF16>(q_lat, q_rope, ck_pool, kr_pool, ck_scale,
                            kr_scale, table, lens, offs, o, scratch, batch,
                            rows, h, c, r, bs, mb, scale, ql_type, qr_type,
                            st);
    case POOL_F32:
      return run<POOL_F32>(q_lat, q_rope, ck_pool, kr_pool, ck_scale,
                           kr_scale, table, lens, offs, o, scratch, batch,
                           rows, h, c, r, bs, mb, scale, ql_type, qr_type, st);
    case POOL_INT8:
      return run<POOL_INT8>(q_lat, q_rope, ck_pool, kr_pool, ck_scale,
                            kr_scale, table, lens, offs, o, scratch, batch,
                            rows, h, c, r, bs, mb, scale, ql_type, qr_type,
                            st);
    default:
      return run<POOL_FP8>(q_lat, q_rope, ck_pool, kr_pool, ck_scale,
                           kr_scale, table, lens, offs, o, scratch, batch,
                           rows, h, c, r, bs, mb, scale, ql_type, qr_type, st);
  }
}

}  // extern "C"
