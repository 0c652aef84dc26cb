// int8 flash attention for Hopper (sm_90a): SageAttention-style int8 QK^T,
// online softmax in fp32, PV in bf16 or (pv_int8) in int8.
//
// Replaces the Pallas kernel _flash_kernel_int8 of
// diffusionrenderer_tpu/ops/flash_attention.py (:317-381), reached through
// flash_attention(qk_int8=True[, pv_int8=True]) and
// attention(backend='pallas_pv_int8').  The wrapper's pre-passes
// (ops/flash_attention.py: q pre-scaled by bf16(scale*log2 e), per-(b, token,
// head) int8 q and k with fp32 row scales, and with pv_int8 per-(b, head,
// channel) int8 V) run before the launch.  Per key tile of BK keys, for each
// query row i and key j:
//   s     = (f32(sum_d qi*ki) * sq_i) * sk_j      (keys past Lk: s = -1e30)
//   m_new = max(m, max_j s);  alpha = exp2(m - m_new)
//   p     = exp2(s - m_new)                       (bf16 PV:  acc += bf16(p) @ v)
//   p     = exp2((s - m_new) + log2 127)          (int8 PV:  acc += f32(round(p) @ vi) * sv)
//   l     = l * alpha + sum_j p                   (the unrounded fp32 p, in both modes)
// and out = acc / l, no clamp.  P is rounded relative to the running max of
// the tiles seen so far, so the result depends on BK; the plain version
// (flash_attention_int8_plain) walks the keys in the same tiles.
//
// What bounds it on an H100: 2*Lq*Lk*H*D int8 QK^T operations (and as many
// PV operations, int8 with pv_int8, bf16 without) against the int8 q, k and
// the V operand read once; at the DiT's (5, 1024, 32, 128) it is operation
// bound, with the per-score fp32 work (dequant, max, exp2, sum) next.
//
// One wgmma body at every head dim (flash_int8_wgmma_kernel), BK = 64.
//   * a block owns 64 query rows: one warpgroup at D = 64, 128, 256; two at
//     D = 512, where a 64-row fp32 accumulator over all of D would take 256
//     registers a thread, so each warpgroup owns D/2 = 256 output columns;
//   * the int8 q tile, the int8 K tiles and the V tiles arrive by TMA (64-
//     or 128-byte swizzle, rows past L zero-filled) into shared memory, K
//     and V in rings of S stages with one mbarrier each, issued by thread 0
//     ahead of use;
//   * QK^T is wgmma m64n64k32 .s32.s8.s8 with both operands K-major in
//     shared memory (int8 q and k are D-contiguous).  At D = 512 each
//     warpgroup forms the whole 512-deep product itself: int32 sums are
//     exact, so both hold the same S, hence the same m, l and P, with no
//     exchange of partial scores and no barrier for one; the doubled int8
//     QK^T costs what one bf16 PV of its columns does.  Summing the two
//     warpgroups' int32 partials through shared memory instead measured
//     slower on the H100 at int8 PV, and would not fit at BK = 64 beside
//     qk8's two 64 KB bf16 V stages (Q 32 KB, K 2 x 32 KB, V 2 x 64 KB: 224
//     KB of the 227 KB a block may have); each thread holds what one
//     warpgroup at D = 256 holds;
//   * bf16 PV (qk8): bf16 P is the register A operand of wgmma m64n{DS}k16
//     over the warpgroup's DS output columns, V read MN-major by descriptor
//     (the transpose bit), as in kernel 2;
//   * int8 PV (pv8): int8 P is the register A operand of wgmma m64n{N}k32
//     .s32.s8.s8 (N = DS at D <= 128, 32 at a time where DS = 256, so a
//     DS-wide int32 product never sits beside the fp32 accumulator), and B
//     is the pre-pass's transposed int8 V, (B, H, D, lk_pad), K-major.
//     wgmma's 8-bit A fragment is, per warp, mma.sync m16n8k32's, and its
//     s32 accumulator mma.sync's C fragment, so the pre-pass's key
//     permutation of each 32-key group (position 16h + 4t + 2a + b holds key
//     16h + 8a + 2t + b) still lets each thread pack its own four P values;
//   * bf16 PV, and int8 PV where DS = 256: tile j's QK^T and tile j-1's PV
//     are in flight together while tile j's dequant and softmax run
//     (FlashAttention-3's intra-warpgroup overlap), two stages;
//   * int8 PV at D <= 128: one tile at a time (QK^T, softmax, PV, the
//     per-tile dequant acc = acc * alpha + f32(pv) * sv), three stages.  The
//     overlapped form keeps the int32 product beside the fp32 accumulator
//     and the next scores (221 registers: two blocks per SM); this one takes
//     167, three blocks per SM overlap each other, and it measured faster
//     on the H100;
//   * int32 <-> fp32 conversions of the scores (at D <= 256), the P codes and
//     the int8 PV go through the FP32 and integer pipes (exact for |x| <
//     2^22), not the quarter-rate conversion unit; exp2 is one SFU
//     instruction.  At D = 512 a score's int32 sum reaches 512 * 127^2 >
//     2^22, so it takes the conversion unit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::smem_u32;

constexpr float kNegInf = -1e30f;  // the JAX kernel's padded-key bias
constexpr float kLog2_127 = 6.988684686772166f;
constexpr int kUnsupported = 10002;

struct Args {
  const int8_t* q;     // (B, Lq, H, D)
  const int8_t* k;     // (B, Lk, H, D)
  const void* v;       // bf16 (B, Lk, H, D), or int8 (B, H, D, lk_pad) with pv8
  const float* sq;     // (B, H, Lq)
  const float* sk;     // (B, H, Lk)
  const float* sv;     // (B, H, D), pv8 only
  __nv_bfloat16* o;    // (B, Lq, H, D)
  int B, Lq, Lk, H, lk_pad;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, bool kPv8> struct Wg {
  static constexpr int WGS = D == 512 ? 2 : 1;   // warpgroups, each owning DS output columns
  static constexpr int THREADS = 128 * WGS;
  static constexpr int DS = D / WGS;
  static constexpr int BQ = 64, BK = 64;         // query rows, keys per tile
  static constexpr int S = kPv8 && D <= 128 ? 3 : 2;  // K and V tiles in flight
  static constexpr int W = D < 128 ? D : 128;    // swizzle span = box row of int8 q and k
  static constexpr int VR = D < 256 ? D : 256;   // channel rows per TMA box of int8 V
  static constexpr int Q_BYTES = BQ * D;
  static constexpr int K_BYTES = BK * D;
  static constexpr int V_BYTES = kPv8 ? D * BK : BK * D * 2;
  static constexpr int NP = kPv8 && DS == 256 ? 32 : DS;  // output columns per PV wgmma
  // No slack: the dynamic shared memory starts 1024-aligned (checked in the
  // kernel); D = 256 qk8 needs all but a few bytes of half an SM, D = 512
  // qk8 all but 3 KB of a whole one.
  static constexpr size_t smem_bytes =
      Q_BYTES + S * (K_BYTES + V_BYTES) + (kPv8 ? D * 4 : 0) + 8 * (1 + 2 * S);
  static_assert(smem_bytes <= 232448, "more than the 227 KB of shared memory a block may have");
};

// K-major int8 tile of `rows` rows in W-byte boxes: the k32 step ks.
template <int W>
__device__ __forceinline__ uint64_t kmajor8(uint32_t base, int rows, int ks) {
  return hopper::make_desc(base + (ks * 32 / W) * rows * W + (ks * 32) % W, 16, 8 * W, W);
}

template <int N>
__device__ __forceinline__ void mma_pv_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) hopper::wgmma_rs_bf16_tb_n64(d, a, b, 1);
  else if constexpr (N == 128) hopper::wgmma_rs_bf16_tb_n128(d, a, b, 1);
  else hopper::wgmma_rs_bf16_tb_n256(d, a, b, 1);
}

template <int N>
__device__ __forceinline__ void mma_pv_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  if constexpr (N == 32) hopper::wgmma_rs_s8_n32(d, a, b, scale_d);
  else if constexpr (N == 64) hopper::wgmma_rs_s8_n64(d, a, b, scale_d);
  else hopper::wgmma_rs_s8_n128(d, a, b, scale_d);
}

// Four p in [0, 127] -> four int8 codes (round half to even), lowest key
// first, without the conversion unit (exact there, as |int32 sums| < 2^22
// are for small_i2f: at most 256 * 127 * 127 in QK^T at D <= 256, 64 * 127 *
// 127 in PV).
__device__ __forceinline__ uint32_t pack_codes(float a, float b, float c, float d) {
  using hopper::round_byte;
  return __byte_perm(__byte_perm(round_byte(a), round_byte(b), 0x0040),
                     __byte_perm(round_byte(c), round_byte(d), 0x0040), 0x5410);
}

// A score's int32 sum as fp32: small_i2f where it is exact (D <= 256).
template <int D> __device__ __forceinline__ float score_i2f(int x) {
  if constexpr (D <= 256) return hopper::small_i2f(x);
  else return __int2float_rn(x);
}

template <int D, bool kPv8>
__global__ void __launch_bounds__(Wg<D, kPv8>::THREADS)
    flash_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const Args p) {
  using namespace hopper;
  using C = Wg<D, kPv8>;
  constexpr int BK = C::BK, S = C::S, W = C::W, NP = C::NP, DS = C::DS;
  constexpr int NS = BK / 2;             // S accumulator registers (s32, then fp32 bits)
  constexpr int NO = DS / 2;             // output accumulator registers
  constexpr int KP = kPv8 ? BK / 32 : BK / 16;  // k-steps of PV
  // int8 PV at D <= 128: one tile at a time (see the file's head).
  constexpr bool kSerial = kPv8 && D <= 128;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  if (smem_u32(smem_wg) & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  unsigned char* Qs = smem_wg;
  unsigned char* Ks = Qs + C::Q_BYTES;
  unsigned char* Vs = Ks + S * C::K_BYTES;
  float* sv_s = reinterpret_cast<float*>(Vs + S * C::V_BYTES);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sv_s + (kPv8 ? D : 0));
  uint64_t* kbar = qbar + 1;
  uint64_t* vbar = kbar + S;

  // Warpgroup wg owns output columns wg * DS..+DS; both hold the same S.
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::BQ;
  const long long bh = (long long)b * p.H + h;
  const int nk = (p.Lk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(kbar + s, 1);
      mbar_init(vbar + s, 1);
    }
    fence_barrier_init();
  }
  if constexpr (kPv8) {
    for (int c = tid; c < D; c += C::THREADS) sv_s[c] = p.sv[bh * D + c];
  }
  __syncthreads();

  auto load_k = [&](int t) {
    const int s = t % S;
    mbar_expect_tx(kbar + s, C::K_BYTES);
#pragma unroll
    for (int nb = 0; nb < D / W; ++nb)
      tma_load_4d(Ks + s * C::K_BYTES + nb * BK * W, &tk, kbar + s, nb * W, h, t * BK, b);
  };
  auto load_v = [&](int t) {
    const int s = t % S;
    mbar_expect_tx(vbar + s, C::V_BYTES);
    if constexpr (kPv8) {  // D channel rows of BK (permuted) keys, in boxes of VR rows
#pragma unroll
      for (int r = 0; r < D / C::VR; ++r)
        tma_load_2d(Vs + s * C::V_BYTES + r * C::VR * BK, &tv, vbar + s, t * BK,
                    (int)(bh * D) + r * C::VR);
    } else {
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
        tma_load_4d(Vs + s * C::V_BYTES + nb * BK * 128, &tv, vbar + s, nb * 64, h, t * BK, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
    for (int nb = 0; nb < D / W; ++nb)
      tma_load_4d(Qs + nb * C::BQ * W, &tq, qbar, nb * W, h, q0, b);
    for (int t = 0; t < S && t < nk; ++t) load_k(t);
    for (int t = 0; t < (kSerial ? S : S - 1) && t < nk; ++t) load_v(t);
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float sq0 = r0 < p.Lq ? p.sq[bh * p.Lq + r0] : 0.f;
  const float sq1 = r1 < p.Lq ? p.sq[bh * p.Lq + r1] : 0.f;
  const float* skb = p.sk + bh * p.Lk;
  // V of this warpgroup's columns: its bf16 boxes of 64 columns, or its int8 channel rows.
  const uint32_t q_addr = smem_u32(Qs), k_addr = smem_u32(Ks),
                 v_addr = smem_u32(Vs) + wg * (kPv8 ? DS * BK : DS / 64 * BK * 128);

  int si[NS];
  float o[NO];
#pragma unroll
  for (int i = 0; i < NS; ++i) si[i] = 0;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // si = q k_t^T over all of D, one commit group.  At D = 512 the q address
  // is made opaque here, so the compiler rebuilds its 16 descriptors at each
  // call rather than holding them in 32 registers across the loop.
  auto issue_qk = [&](int t) {
    const uint32_t kb = k_addr + (t % S) * C::K_BYTES;
    uint32_t qa = q_addr;
    if constexpr (D == 512) asm volatile("" : "+r"(qa));
#pragma unroll
    for (int ks = 0; ks < D / 32; ++ks)
      wgmma_ss_s8_n64(si, kmajor8<W>(qa, C::BQ, ks), kmajor8<W>(kb, BK, ks), ks);
    wg_commit();
  };
  // The sk of this thread's keys 8n + 2 t4 (+1) of tile t (0 past Lk).
  float skr[BK / 4];
  auto load_sk = [&](int t) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * BK + n * 8 + 2 * t4 + e;
        skr[2 * n + e] = key < p.Lk ? __ldg(skb + key) : 0.f;
      }
  };
  // Tile t's int32 scores in si -> dequant, mask, running max, P in place
  // (as fp32 bits), the row sums; returns alpha of both rows.
  auto softmax = [&](int t, float& a0, float& a1) {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(__fmul_rn(score_i2f<D>(si[4 * n + e]), e < 2 ? sq0 : sq1),
                            skr[2 * n + (e & 1)]);
        if (t * BK + n * 8 + 2 * t4 + (e & 1) >= p.Lk) x = kNegInf;  // ragged last tile
        si[4 * n + e] = __float_as_int(x);
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    a0 = ex2(__fsub_rn(m0, mx0));
    a1 = ex2(__fsub_rn(m1, mx1));
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = __fsub_rn(__int_as_float(si[4 * n + e]), e < 2 ? m0 : m1);
        pe[e] = ex2(kPv8 ? __fadd_rn(d, kLog2_127) : d);
        si[4 * n + e] = __float_as_int(pe[e]);
      }
      ps0 = __fadd_rn(ps0, __fadd_rn(pe[0], pe[1]));
      ps1 = __fadd_rn(ps1, __fadd_rn(pe[2], pe[3]));
    }
    l0 = __fadd_rn(__fmul_rn(l0, a0), ps0);
    l1 = __fadd_rn(__fmul_rn(l1, a1), ps1);
  };
  auto pf = [&](int i) { return __int_as_float(si[i]); };
  // P as the PV wgmma's register A operand: bf16 k16 fragments (two n8
  // tiles each), or int8 k32 fragments in the permuted key order of V.
  auto pack_p = [&](uint32_t (&pa)[KP][4]) {
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      if constexpr (kPv8) {
        const int n = 4 * kp;
        pa[kp][0] = pack_codes(pf(4 * n), pf(4 * n + 1), pf(4 * n + 4), pf(4 * n + 5));
        pa[kp][1] = pack_codes(pf(4 * n + 2), pf(4 * n + 3), pf(4 * n + 6), pf(4 * n + 7));
        pa[kp][2] = pack_codes(pf(4 * n + 8), pf(4 * n + 9), pf(4 * n + 12), pf(4 * n + 13));
        pa[kp][3] = pack_codes(pf(4 * n + 10), pf(4 * n + 11), pf(4 * n + 14), pf(4 * n + 15));
      } else {
        pa[kp][0] = pack_bf16(pf(8 * kp), pf(8 * kp + 1));
        pa[kp][1] = pack_bf16(pf(8 * kp + 2), pf(8 * kp + 3));
        pa[kp][2] = pack_bf16(pf(8 * kp + 4), pf(8 * kp + 5));
        pa[kp][3] = pack_bf16(pf(8 * kp + 6), pf(8 * kp + 7));
      }
    }
  };
  // bf16 PV of tile t into o, one commit group.
  auto issue_pv_bf16 = [&](const uint32_t (&pa)[KP][4], int t) {
    const uint32_t vb = v_addr + (t % S) * C::V_BYTES;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp)
      mma_pv_bf16<DS>(o, pa[kp], make_desc(vb + kp * 16 * 128, BK * 128, 1024, 128));
    wg_commit();
  };
  // int8 PV of tile t for output columns part*NP..+NP into pv, one commit group.
  int pv[kPv8 ? NP / 2 : 1];
  auto issue_pv_s8 = [&](const uint32_t (&pa)[KP][4], int t, int part) {
    const uint32_t vb = v_addr + (t % S) * C::V_BYTES + part * NP * BK;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      if constexpr (kPv8) mma_pv_s8<NP>(pv, pa[kp], make_desc(vb + kp * 32, 16, 8 * BK, BK), kp);
    }
    wg_commit();
  };
  // acc = acc * alpha + f32(pv) * sv over one part's columns.
  auto dequant_acc = [&](int part, float a0, float a1) {
    if constexpr (kPv8) {
#pragma unroll
      for (int n = 0; n < NP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = part * (NP / 2) + 4 * n + e;
          const float sv = sv_s[wg * DS + part * NP + n * 8 + 2 * t4 + (e & 1)];
          o[i] = __fadd_rn(__fmul_rn(o[i], e < 2 ? a0 : a1), __fmul_rn(small_i2f(pv[4 * n + e]), sv));
        }
    }
  };
  // All of tile t's PV: the parts after the first run here, each waited.
  auto pv_rest = [&](const uint32_t (&pa)[KP][4], int t, float a0, float a1) {
    if constexpr (kPv8) {
#pragma unroll
      for (int part = 1; part < DS / NP; ++part) {
        wg_fence();
        fence_regs(pv);
        issue_pv_s8(pa, t, part);
        wg_wait<0>();
        fence_regs(pv);
        dequant_acc(part, a0, a1);
      }
    }
  };

  uint32_t pa[KP][4];
  float a0, a1, ap0 = 0.f, ap1 = 0.f;  // alpha of this tile, and of the tile before (pv8)
  mbar_wait(qbar, 0);
  if constexpr (kSerial) {
    // One tile at a time (QK^T, softmax, PV): fewer live registers, so three
    // blocks per SM overlap each other's work instead.
    for (int j = 0; j < nk; ++j) {
      mbar_wait(kbar + j % S, (j / S) & 1);
      wg_fence();
      issue_qk(j);
      load_sk(j);
      wg_wait<0>();
      fence_regs(si);
      softmax(j, a0, a1);
      pack_p(pa);
      mbar_wait(vbar + j % S, (j / S) & 1);
#pragma unroll
      for (int part = 0; part < DS / NP; ++part) {
        wg_fence();
        fence_regs(pv);
        fence_regs(pa);
        issue_pv_s8(pa, j, part);
        wg_wait<0>();
        fence_regs(pv);
        dequant_acc(part, a0, a1);
      }
      __syncthreads();  // K_j's and V_j's stages are free
      if (tid == 0 && j + S < nk) {
        load_k(j + S);
        load_v(j + S);
      }
    }
  } else {
    mbar_wait(kbar, 0);
    wg_fence();
    issue_qk(0);
    load_sk(0);
    wg_wait<0>();
    fence_regs(si);
    softmax(0, a0, a1);
    pack_p(pa);
    ap0 = a0;
    ap1 = a1;
    __syncthreads();  // every warp is done with K_0's stage
    if (tid == 0) {
      if (S < nk) load_k(S);
      if (S - 1 < nk) load_v(S - 1);
    }
    for (int j = 1; j < nk; ++j) {
      mbar_wait(kbar + j % S, (j / S) & 1);
      wg_fence();
      fence_regs(o);
      fence_regs(pa);
      issue_qk(j);
      mbar_wait(vbar + (j - 1) % S, ((j - 1) / S) & 1);
      if constexpr (kPv8) issue_pv_s8(pa, j - 1, 0);
      else issue_pv_bf16(pa, j - 1);
      load_sk(j);
      wg_wait<1>();  // S_j has landed; PV_{j-1} may still run
      fence_regs(si);
      softmax(j, a0, a1);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if constexpr (kPv8) {
        fence_regs(pv);
        dequant_acc(0, ap0, ap1);
        pv_rest(pa, j - 1, ap0, ap1);
        ap0 = a0;
        ap1 = a1;
      } else {
#pragma unroll
        for (int n = 0; n < DS / 8; ++n) {
          o[4 * n] = __fmul_rn(o[4 * n], a0);
          o[4 * n + 1] = __fmul_rn(o[4 * n + 1], a0);
          o[4 * n + 2] = __fmul_rn(o[4 * n + 2], a1);
          o[4 * n + 3] = __fmul_rn(o[4 * n + 3], a1);
        }
      }
      pack_p(pa);
      __syncthreads();  // K_j's and V_{j-1}'s stages are free
      if (tid == 0) {
        if (j + S < nk) load_k(j + S);
        if (j + S - 1 < nk) load_v(j + S - 1);
      }
    }
    mbar_wait(vbar + (nk - 1) % S, ((nk - 1) / S) & 1);
    wg_fence();
    fence_regs(o);
    fence_regs(pa);
    if constexpr (kPv8) {
      fence_regs(pv);
      issue_pv_s8(pa, nk - 1, 0);
      wg_wait<0>();
      fence_regs(pv);
      dequant_acc(0, ap0, ap1);
      pv_rest(pa, nk - 1, ap0, ap1);
    } else {
      issue_pv_bf16(pa, nk - 1);
      wg_wait<0>();
    }
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const long long row_stride = (long long)p.H * D;
  __nv_bfloat16* ob = p.o + (long long)b * p.Lq * row_stride + (long long)h * D + wg * DS;
#pragma unroll
  for (int n = 0; n < DS / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * row_stride + col) =
          pack_bf16(o[4 * n] / l0, o[4 * n + 1] / l0);
    if (r1 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * row_stride + col) =
          pack_bf16(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
}

template <int D, bool kPv8> int launch_wgmma(const Args& a, cudaStream_t stream) {
  using C = Wg<D, kPv8>;
  if (kPv8 && (a.lk_pad < a.Lk || a.lk_pad % C::BK)) return kUnsupported;
  CUtensorMap mq, mk, mv;
  int e = hopper::encode_bshd(&mq, a.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.B, a.Lq, a.H, D,
                              C::W, C::BQ);
  if (e == 0)
    e = hopper::encode_bshd(&mk, a.k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.B, a.Lk, a.H, D, C::W,
                            C::BK);
  if (e == 0)
    e = kPv8 ? hopper::encode_rows_u8(&mv, a.v, (long long)a.B * a.H * D, a.lk_pad, C::BK, C::VR)
             : hopper::encode_bshd(&mv, a.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.Lk, a.H,
                                   D, 128, C::BK);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(flash_int8_wgmma_kernel<D, kPv8>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(C::smem_bytes));
  if (ce != cudaSuccess) return ce;
  const dim3 grid((a.Lq + C::BQ - 1) / C::BQ, a.H, a.B);
  flash_int8_wgmma_kernel<D, kPv8><<<grid, C::THREADS, C::smem_bytes, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <int D, bool kPv8> int occupancy(int* out) {
  const auto fn = flash_int8_wgmma_kernel<D, kPv8>;
  const size_t smem = Wg<D, kPv8>::smem_bytes;
  constexpr int threads = Wg<D, kPv8>::THREADS;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = threads;
  return 0;
}

}  // namespace

extern "C" {

const char* drt_flash_int8_error_string(int code) {
  if (code == kUnsupported) return "unsupported head dim or sizes (D in {64, 128, 256, 512})";
  if (code == hopper::kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Keys per tile at head dim D (the plain version walks the same tiles), or
// -1 for a head dim the kernel does not take.
int drt_flash_int8_block_k(int D) {
  switch (D) {
    case 64: return Wg<64, false>::BK;
    case 128: return Wg<128, false>::BK;
    case 256: return Wg<256, false>::BK;
    case 512: return Wg<512, false>::BK;
    default: return -1;
  }
}

int drt_flash_attention_int8(const void* q, const void* k, const void* v, const void* sq,
                             const void* sk, const void* sv, void* o, int B, int Lq, int Lk,
                             int H, int D, int lk_pad, int pv8, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || B > 65535 || H > 65535) return kUnsupported;
  const Args a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v,
               static_cast<const float*>(sq), static_cast<const float*>(sk),
               static_cast<const float*>(sv), static_cast<__nv_bfloat16*>(o),
               B, Lq, Lk, H, lk_pad};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (pv8 ? 1 : 0)) {
    case 128: return launch_wgmma<64, false>(a, st);
    case 129: return launch_wgmma<64, true>(a, st);
    case 256: return launch_wgmma<128, false>(a, st);
    case 257: return launch_wgmma<128, true>(a, st);
    case 512: return launch_wgmma<256, false>(a, st);
    case 513: return launch_wgmma<256, true>(a, st);
    case 1024: return launch_wgmma<512, false>(a, st);
    case 1025: return launch_wgmma<512, true>(a, st);
    default: return kUnsupported;
  }
}

// out = {registers, local (spill) bytes, dynamic shared bytes, resident blocks per SM,
// threads per block}.
int drt_flash_int8_occupancy(int D, int pv8, int* out) {
  switch (D * 2 + (pv8 ? 1 : 0)) {
    case 128: return occupancy<64, false>(out);
    case 129: return occupancy<64, true>(out);
    case 256: return occupancy<128, false>(out);
    case 257: return occupancy<128, true>(out);
    case 512: return occupancy<256, false>(out);
    case 513: return occupancy<256, true>(out);
    case 1024: return occupancy<512, false>(out);
    case 1025: return occupancy<512, true>(out);
    default: return kUnsupported;
  }
}

}  // extern "C"
