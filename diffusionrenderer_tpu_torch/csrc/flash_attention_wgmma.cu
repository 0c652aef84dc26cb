// Kernels 1, 2, 3, 6 and 7 for Hopper (sm_90a): flash attention on wgmma,
// TMA and mbarriers, at every head dim: 64, 128, and the wide heads 256 and
// 512 (the VAE's mid-block attention) on attend_wide.
//
// Replaces, of diffusionrenderer_tpu/ops/flash_attention.py:
//   * _flash_kernel_noshift (:185-259) - p = exp2(s) with no max shift, taken
//     when the headroom rule of _bounded_cond_call (:488-491) holds (kernel 1);
//   * _flash_kernel / _flash_kernel_nobias (:58-118; pallas_call at :478 and
//     :675) - the online softmax (kernel 2): flash_attention(bounded=False),
//     attention(backend='pallas_onlinemax'), flash_sp, and the online branch
//     of every bounded call;
//   * _flash_kernel_partial / _flash_kernel_partial_bias (:121, :384, through
//     flash_attention_partial :766) - kernel 2 plus the per-row running max m
//     (log2 domain) and the unclamped normalizer l, the inner block of ring
//     attention (kernel 3, partial_kernel, at the wide heads
//     partial_kernel_wide);
//   * _flash_kernel_bounded_pipe (:262-314) - p = exp2(s - mb_i) with the
//     caller's row bound mb_i = ||q'_i|| * max_j ||k_j|| and the score tile
//     carried one key tile ahead (kernel 6, flash_attention(bounded=True,
//     pipelined=True));
//   * _flash_kernel_bounded (:130-182) - the same function without the
//     carried tile (kernel 7, flash_attention_bounded_shift; no JAX code
//     path calls it).
// Kernels 1 and 2 are one launch (attention_kernel, attention_kernel_wide):
// every block evaluates the headroom rule (headroom_rule.cuh) on the stats
// buffer that csrc/flash_attention.cu's headroom_kernel fills, then runs the
// no-shift or the online body; block (0, 0, 0) tallies the branch.  An
// unbounded call runs the online body and tallies it.  Kernels 3, 6 and 7
// are launches of their own (partial_kernel<D>, bounded_kernel<D, kBoundedPipe
// | kBounded>, at the wide heads partial_kernel_wide<D> and
// bounded_kernel_wide<D, ...>), with no rule and no tally; kernel 3 is the
// online body, so unsplit its output equals the unbounded call's bit for
// bit.  With
// q' = bf16(q * bf16(scale * log2 e)), per key tile of BK keys and row i:
//   no-shift  p = exp2(s),                  l += sum_j p,  acc += bf16(p) v
//   online    m_new = max(m, max_j s_ij),   alpha = exp2(m - m_new),
//             p = exp2(s - m_new),  l = l * alpha + sum_j p,
//             acc = acc * alpha + bf16(p) v
//             (kernel 3 also stores m and l per row)
//   bounded   p = exp2(s - mb_i),           l += sum_j p,  acc += bf16(p) v
//             (kernels 6 and 7)
// and out = acc / l, l clamped at 1e-37 in the no-shift and bounded modes
// (keys past Lk: s = -1e30): the rounding points of the JAX kernels.  exp2
// is one SFU instruction (ex2.approx.ftz): weights below 2^-126 flush to
// zero, as on XLA's CPU backend; the plain versions flush them too.  The
// wide heads' online branch keeps exp2f: in the online softmax a flushed
// weight could not show.
//
// What bounds them on an H100: 4*Lq*Lk*H*D bf16 tensor-core operations (0.087
// ms at the DiT's (5, 1024, 32, 128)), then Lq*Lk*H exp2 on the SFUs, and
// the K and V tiles every block streams from L2 (each query block reads all
// of its head's keys).  The design at D = 64, 128:
//   * two warpgroups (256 threads) per block, 64 query rows each (wgmma m64),
//     sharing every K and V tile: 128 query rows per block halve the L2
//     traffic of one warpgroup per block; grid (ceil(Lq / 128), H, B),
//     (B, L, H, D) read through 4-D tensor maps;
//   * Q arrives once by TMA and is pre-scaled in place in shared memory (the
//     q_prescale rounding point), then a proxy fence before the first wgmma;
//   * K and V tiles arrive by TMA (128-byte swizzle, keys past Lk zero-filled)
//     in rings of two stages with one mbarrier each; thread 0 issues the
//     copies into a stage once both warpgroups' wgmma reading it completed;
//   * S = Q K^T is wgmma m64nBKk16 (BK = 128 keys a tile, 64 for kernel 6)
//     with both operands in shared memory
//     (K-major); P, converted to bf16 in registers, is the register A operand
//     of the PV wgmma m64n{D}k16, V read MN-major (the transpose bit);
//   * the overlap follows what each softmax must wait for.  Online (kernels
//     2 and 3): FlashAttention-3's intra-warpgroup pipelining, tile j's QK^T
//     and tile j-1's PV in flight during tile j's softmax, then a wait for the
//     PV before the alpha rescale.  No-shift: nothing rescales the accumulator,
//     so P is double-buffered and tile j-1's PV stays in flight across tile
//     j's softmax and tile j+1's QK^T; kernel 7 is that body with the row
//     bound as its shift.  Kernel 6: the score tile is carried, as the TPU
//     kernel's scratch carries it: tile j+1's QK^T is issued before tile j's
//     exp2, into a second S accumulator, so the tensor cores compute S_{j+1}
//     while the SFUs take exp2 of S_j.  Kernels 6 and 7 sum l per thread in
//     key order and issue PV in k16 order, so the two agree bit for bit at
//     either tile size;
//   * 160 / 80 KB of shared memory at D = 128 / 64 with 128-key tiles (96 /
//     48 KB with 64-key tiles: kernel 6, and kernel 7 at D = 64), one block
//     of 8 warps per SM (two of kernel 7 at D = 64).
// The wide heads' design is described at attend_wide below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "headroom_rule.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWGS = 2;  // warpgroups per block, 64 query rows each, sharing K and V
constexpr int kThreads = 128 * kWGS;
constexpr float kNegInf = -1e30f;  // the JAX kernels' padded-key bias
constexpr int kUnsupported = 10020;

enum Mode { kNoShift, kOnline, kPartial, kBoundedPipe, kBounded };

// Keys per tile, the QK^T wgmma's N: 128, and 64 for kernel 6, which holds
// two score tiles, the accumulator and P in registers (at 128 keys ptxas
// spills it: 224 of 255 registers before addresses and temporaries).
// Kernel 7's tile is chosen by measurement, 128 at D = 128 and 64 at D = 64
// (scripts/torch_kernel7_tile.py builds this source with
// DRT_KERNEL7_BLOCK_K = 64 and = 128 and times both at each head dim).
#ifdef DRT_KERNEL7_BLOCK_K
template <int D> constexpr int kKernel7BlockK = DRT_KERNEL7_BLOCK_K;
#else
template <int D> constexpr int kKernel7BlockK = D == 128 ? 128 : 64;
#endif
template <Mode M, int D>
constexpr int kBlockK = M == kBoundedPipe ? 64 : M == kBounded ? kKernel7BlockK<D> : 128;

template <int D, int BK_> struct Cfg {
  static constexpr int BQ = 64 * kWGS;           // query rows: one wgmma m64 per warpgroup
  static constexpr int BK = BK_;
  static constexpr int NB = D / 64;              // 128-byte boxes per bf16 row
  static constexpr int STAGES = 2;               // K and V tiles in flight
  static constexpr int Q_BYTES = NB * BQ * 128;
  static constexpr int T_BYTES = NB * BK * 128;  // one K or V tile
  // The tiles from the 1024-aligned start, then the barriers and the
  // rule's scratch.
  static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * T_BYTES;
  static constexpr int SCRATCH_OFFSET = BAR_OFFSET + 8 * (1 + 2 * STAGES);
  static constexpr size_t smem_bytes = SCRATCH_OFFSET + 4 * (kThreads / 32 + 1);
};

struct Args {
  __nv_bfloat16* o;
  const float* stats;  // the headroom stats, read when bounded (kernels 1 and 2)
  int* tally;          // [no-shift launches, online launches]
  const float* mb;     // (B, H, Lq) row bound (kernels 6 and 7)
  int B, Lq, Lk, H;
  float q_scale;       // softmax_scale * log2(e), rounded to bf16
  float log2_lk_pad;
  int bounded;
  float* m_out;        // (B, H, Lq) running max and normalizer (kernel 3)
  float* l_out;
  int split;           // kernels 3, 6 and 7 at the wide heads: keys split over 2-block clusters
};

template <int N> struct Buf { static constexpr int value = N; };

template <int I, typename T> __device__ __forceinline__ T& pick(T& a, T& b) {
  if constexpr (I == 0) return a;
  else return b;
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_ss_bf16_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_ss_bf16_n64(d, a, b, scale_d);
  else wgmma_ss_bf16_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  if constexpr (N == 64) wgmma_rs_bf16_tb_n64(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_rs_bf16_tb_n128(d, a, b, scale_d);
  else wgmma_rs_bf16_tb_n256(d, a, b, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(f32(x) * qs) for both halves of a bf16 pair.
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float qs) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__bfloat162float(v.x) * qs, __bfloat162float(v.y) * qs);
}

// K-major tile of `rows` rows in 128-byte boxes: the k16 step ks.
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int ks) {
  return make_desc(base + (ks / 4) * rows * 128 + (ks % 4) * 32, 16, 1024, 128);
}

// q' = bf16(q * q_scale) in place, by every thread of a block: elementwise,
// so the swizzle is immaterial.  Then the proxy fence and the barrier before
// the first wgmma reads it.
template <int kBytes>
__device__ __forceinline__ void prescale_q(unsigned char* Qs, float q_scale) {
  for (int i = threadIdx.x; i < kBytes / 16; i += kThreads) {
    uint4 x = reinterpret_cast<uint4*>(Qs)[i];
    x.x = scale_pair(x.x, q_scale);
    x.y = scale_pair(x.y, q_scale);
    x.z = scale_pair(x.z, q_scale);
    x.w = scale_pair(x.w, q_scale);
    reinterpret_cast<uint4*>(Qs)[i] = x;
  }
  fence_proxy_async();
  __syncthreads();
}

// P = exp2(x - shift) of a tile's scores as bf16 A fragments of PV, summed
// into l0 / l1 (the no-shift and bounded modes); x is only read.  This
// thread's keys 8n + 2 t4 + (e & 1) of the tile are below Lk when
// 8n + (e & 1) < lim.  Two adjacent n8 tiles of the accumulator are one k16
// A fragment.
template <int BK>
__device__ __forceinline__ void exp_pack(const float (&x)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                         float sh0, float sh1, int lim, float& l0, float& l1) {
#pragma unroll
  for (int kp = 0; kp < BK / 16; ++kp) {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = ex2(x[8 * kp + i] - ((i & 2) ? sh1 : sh0));
      e[i] = (2 * kp + i / 4) * 8 + (i & 1) < lim ? y : 0.f;
    }
    l0 += e[0] + e[1];
    l1 += e[2] + e[3];
    l0 += e[4] + e[5];
    l1 += e[6] + e[7];
    pa[kp][0] = pack_bf16(e[0], e[1]);
    pa[kp][1] = pack_bf16(e[2], e[3]);
    pa[kp][2] = pack_bf16(e[4], e[5]);
    pa[kp][3] = pack_bf16(e[6], e[7]);
  }
}

// The online softmax of one tile: s (scores, keys >= Lk masked with -1e30
// where the tile is ragged, `key0` its first key) -> P in place (fp32), the
// running max m and l updated, and the rescale of acc in a0 / a1 (applied
// by the caller once the previous tile's PV has landed).  kExp2f: exp2f in
// place of the SFU's ex2.approx.ftz.
template <int BK, bool kExp2f>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], int key0, int Lk, int t4,
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& a0, float& a1) {
  auto exp2_ = [](float x) { return kExp2f ? exp2f(x) : ex2(x); };
  if (key0 + BK > Lk) {  // ragged last tile: mask keys >= Lk
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + n * 8 + 2 * t4 + (e & 1) >= Lk) s[4 * n + e] = kNegInf;
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  a0 = exp2_(m0 - mx0);
  a1 = exp2_(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    s[4 * n] = exp2_(s[4 * n] - m0);
    s[4 * n + 1] = exp2_(s[4 * n + 1] - m0);
    s[4 * n + 2] = exp2_(s[4 * n + 2] - m1);
    s[4 * n + 3] = exp2_(s[4 * n + 3] - m1);
    l0 += s[4 * n] + s[4 * n + 1];
    l1 += s[4 * n + 2] + s[4 * n + 3];
  }
}

// P to bf16: two adjacent n8 tiles of the accumulator are one k16 A fragment.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kp = 0; kp < BK / 16; ++kp) {
    pa[kp][0] = pack_bf16(s[8 * kp], s[8 * kp + 1]);
    pa[kp][1] = pack_bf16(s[8 * kp + 2], s[8 * kp + 3]);
    pa[kp][2] = pack_bf16(s[8 * kp + 4], s[8 * kp + 5]);
    pa[kp][3] = pack_bf16(s[8 * kp + 6], s[8 * kp + 7]);
  }
}

// acc *= alpha, row by row.
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], float a0, float a1) {
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    o[4 * n] *= a0;
    o[4 * n + 1] *= a0;
    o[4 * n + 2] *= a1;
    o[4 * n + 3] *= a1;
  }
}

// The quad's sums of l: each row's four threads hold a quarter of its keys.
__device__ __forceinline__ void quad_sum(float& l0, float& l1) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
}

// One block's 128 query rows against every key, in mode kMode.  Every thread
// of the block calls it; smem is 1024-byte aligned and Cfg<D, kBlockK<kMode, D>>
// ::smem_bytes long.
template <int D, Mode kMode>
__device__ __forceinline__ void attend(const CUtensorMap* tq, const CUtensorMap* tk,
                                       const CUtensorMap* tv, const Args& p, unsigned char* smem) {
  using C = Cfg<D, kBlockK<kMode, D>>;
  constexpr int BK = C::BK, S = C::STAGES;
  constexpr int NS = BK / 2;  // S accumulator registers
  constexpr int NO = D / 2;   // output accumulator registers
  constexpr int KP = BK / 16; // k16 steps of PV
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + C::Q_BYTES;
  unsigned char* Vs = Ks + S * C::T_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* kbar = qbar + 1;
  uint64_t* vbar = kbar + S;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::BQ;
  const int nk = (p.Lk + BK - 1) / BK;
  // Thread (g, t4) of warp w of its warpgroup holds rows 16w+g and 16w+g+8,
  // keys 8n + 2 t4 (+1) of each n8 tile of S.
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(kbar + s, 1);
      mbar_init(vbar + s, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Key tile t of K or V into its stage, by one thread.
  auto load_tile = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* bars, int t) {
    const int s = t % S;
    mbar_expect_tx(bars + s, C::T_BYTES);
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
      tma_load_4d(ring + s * C::T_BYTES + nb * BK * 128, map, bars + s, nb * 64, h, t * BK, b);
  };
  // V tiles loaded ahead of the loop: the online body refills V_{j-1}'s
  // stage at the end of iteration j, the others one iteration later.
  constexpr bool kRunningMax = kMode == kOnline || kMode == kPartial;
  constexpr int kVAhead = kRunningMax ? S - 1 : S;
  if (tid == 0) {
    mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
      tma_load_4d(Qs + nb * C::BQ * 128, tq, qbar, nb * 64, h, q0, b);
    for (int t = 0; t < S && t < nk; ++t) load_tile(tk, Ks, kbar, t);
    for (int t = 0; t < kVAhead && t < nk; ++t) load_tile(tv, Vs, vbar, t);
  }

  // The bounded mode's fixed per-row shift (padded rows are never stored).
  float mb0 = 0.f, mb1 = 0.f;
  if constexpr (kMode == kBoundedPipe || kMode == kBounded) {
    const long long rows = ((long long)b * p.H + h) * p.Lq;
    if (r0 < p.Lq) mb0 = p.mb[rows + r0];
    if (r1 < p.Lq) mb1 = p.mb[rows + r1];
  }

  mbar_wait(qbar, 0);
  prescale_q<C::Q_BYTES>(Qs, p.q_scale);

  // This warpgroup's 64 rows of each Q box.
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128, k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f, m0 = kNegInf, m1 = kNegInf;

  auto wait_k = [&](int t) { mbar_wait(kbar + t % S, (t / S) & 1); };
  auto wait_v = [&](int t) { mbar_wait(vbar + t % S, (t / S) & 1); };
  // dst = q' K_t^T; one commit group.
  auto issue_qk = [&](float (&dst)[NS], int t) {
    const uint32_t kb = k_addr + (t % S) * C::T_BYTES;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss<BK>(dst, kmajor(q_addr, C::BQ, ks), kmajor(kb, BK, ks), ks);
    wg_commit();
  };
  // acc += P V_t, V MN-major: LBO steps 64 output columns (one box), SBO 8 keys.
  auto issue_pv = [&](const uint32_t (&pa)[KP][4], int t) {
    const uint32_t vb = v_addr + (t % S) * C::T_BYTES;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp)
      mma_rs_tb<D>(o, pa[kp], make_desc(vb + kp * 16 * 128, BK * 128, 1024, 128), 1);
    wg_commit();
  };
  // Tile t's keys below Lk of this thread: 8n + (e & 1) < lim (exp_pack).
  auto lim = [&](int t) { return (t + 1) * BK > p.Lk ? p.Lk - t * BK - 2 * t4 : BK; };
  auto exp_tile = [&](const float (&x)[NS], uint32_t (&pa)[KP][4], int t) {
    exp_pack<BK>(x, pa, mb0, mb1, lim(t), l0, l1);
  };

  if constexpr (kRunningMax) {
    float s[NS];
    uint32_t pa[KP][4];
    float a0, a1;
    auto softmax = [&](int t) { online_softmax<BK, false>(s, t * BK, p.Lk, t4, m0, m1, l0, l1, a0, a1); };

    wait_k(0);
    wg_fence();
    issue_qk(s, 0);
    wg_wait<0>();
    fence_regs(s);
    softmax(0);
    pack_p<BK>(s, pa);
    __syncthreads();  // every warp is done with K_0's stage
    if (tid == 0) {
      if (S < nk) load_tile(tk, Ks, kbar, S);
      if (S - 1 < nk) load_tile(tv, Vs, vbar, S - 1);
    }
    for (int j = 1; j < nk; ++j) {
      wait_k(j);
      wg_fence();
      fence_regs(o);
      fence_regs(pa);
      issue_qk(s, j);
      wait_v(j - 1);
      issue_pv(pa, j - 1);
      wg_wait<1>();  // S_j has landed; PV_{j-1} may still run
      fence_regs(s);
      softmax(j);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      rescale(o, a0, a1);
      pack_p<BK>(s, pa);
      __syncthreads();  // K_j's and V_{j-1}'s stages are free
      if (tid == 0) {
        if (j + S < nk) load_tile(tk, Ks, kbar, j + S);
        if (j + S - 1 < nk) load_tile(tv, Vs, vbar, j + S - 1);
      }
    }
    wait_v(nk - 1);
    wg_fence();
    fence_regs(o);
    fence_regs(pa);
    issue_pv(pa, nk - 1);
  } else if constexpr (kMode == kNoShift || kMode == kBounded) {
    // P of tile j in pa0 (j even) or pa1 (j odd): PV_{j-1} reads one buffer
    // while tile j's softmax fills the other, so it is waited for only when
    // tile j+1's QK^T lands (and V_{j-1}'s stage is refilled after that).
    // The shift is 0 (kernel 1) or the row bound (kernel 7).
    float s[NS];
    uint32_t pa0[KP][4], pa1[KP][4];
    wait_k(0);
    wg_fence();
    issue_qk(s, 0);
    wg_wait<0>();
    fence_regs(s);
    __syncthreads();  // every warp is done with K_0's stage
    if (tid == 0 && S < nk) load_tile(tk, Ks, kbar, S);
    exp_tile(s, pa0, 0);
    auto step = [&](int j, auto buf) {
      constexpr int B = decltype(buf)::value;  // j & 1
      auto& cur = pick<B>(pa0, pa1);
      auto& prev = pick<1 - B>(pa0, pa1);
      wait_k(j);
      wg_fence();
      fence_regs(o);
      fence_regs(cur);
      fence_regs(prev);
      issue_qk(s, j);
      wait_v(j - 1);
      issue_pv(prev, j - 1);
      wg_wait<1>();  // S_j and PV_{j-2} have landed; PV_{j-1} may still run
      fence_regs(s);
      fence_regs(cur);
      __syncthreads();  // K_j's and V_{j-2}'s stages are free
      if (tid == 0) {
        if (j + S < nk) load_tile(tk, Ks, kbar, j + S);
        if (j >= S) load_tile(tv, Vs, vbar, j);
      }
      exp_tile(s, cur, j);
    };
    int j = 1;
    for (; j + 1 < nk; j += 2) {
      step(j, Buf<1>{});
      step(j + 1, Buf<0>{});
    }
    if (j < nk) step(j, Buf<1>{});
    wait_v(nk - 1);
    wg_fence();
    fence_regs(o);
    fence_regs(pa0);
    fence_regs(pa1);
    if ((nk - 1) & 1) issue_pv(pa1, nk - 1);
    else issue_pv(pa0, nk - 1);
  } else {
    // Kernel 6: tile j's scores in s0 (j even) or s1 (j odd); tile j+1's
    // QK^T is in flight in the other while tile j's exp2 runs.  Whether a
    // next tile exists is a compile-time argument of the step: every wgmma
    // is issued on every path through the loop, as ptxas needs to keep the
    // wgmma pipelined.
    float s0[NS], s1[NS];
    uint32_t pa[KP][4];
    wait_k(0);
    fence_regs(o);  // acc's zeros are defined before the first wgmma is in flight
    wg_fence();
    issue_qk(s0, 0);
    auto step = [&](int j, auto buf, auto next) {
      constexpr int B = decltype(buf)::value;  // j & 1
      constexpr bool kNext = decltype(next)::value;  // j + 1 < nk
      auto& cur = pick<B>(s0, s1);
      auto& nxt = pick<1 - B>(s0, s1);
      if constexpr (kNext) {
        wait_k(j + 1);
        wg_fence();
        fence_regs(nxt);
        fence_regs(o);
        fence_regs(pa);
        issue_qk(nxt, j + 1);
        wg_wait<1>();  // S_j and PV_{j-1} have landed; S_{j+1} runs on
      } else {
        wg_wait<0>();
      }
      fence_regs(cur);
      fence_regs(o);
      fence_regs(pa);
      __syncthreads();  // K_j's and V_{j-1}'s stages are free
      if (tid == 0) {
        if (j + S < nk) load_tile(tk, Ks, kbar, j + S);
        if (j + 1 >= S && j + 1 < nk) load_tile(tv, Vs, vbar, j + 1);
      }
      exp_tile(cur, pa, j);
      wait_v(j);
      wg_fence();
      fence_regs(o);
      fence_regs(pa);
      issue_pv(pa, j);
    };
    int j = 0;
    for (; j + 2 < nk; j += 2) {
      step(j, Buf<0>{}, Buf<1>{});
      step(j + 1, Buf<1>{}, Buf<1>{});
    }
    if (j + 1 < nk) {
      step(j, Buf<0>{}, Buf<1>{});
      step(j + 1, Buf<1>{}, Buf<0>{});
    } else {
      step(j, Buf<0>{}, Buf<0>{});
    }
  }
  wg_wait<0>();
  fence_regs(o);

  quad_sum(l0, l1);
  if constexpr (kMode == kPartial) {
    // JAX's partial stats: the running max (log2 domain) and the unclamped
    // normalizer, one value per query row, held alike by the row's quad.
    const long long rows = ((long long)b * p.H + h) * p.Lq;
    if (t4 == 0 && r0 < p.Lq) p.m_out[rows + r0] = m0, p.l_out[rows + r0] = l0;
    if (t4 == 0 && r1 < p.Lq) p.m_out[rows + r1] = m1, p.l_out[rows + r1] = l1;
  }
  if constexpr (!kRunningMax) {
    l0 = fmaxf(l0, 1e-37f);
    l1 = fmaxf(l1, 1e-37f);
  }
  const long long row_stride = (long long)p.H * D;
  __nv_bfloat16* ob = p.o + (long long)b * p.Lq * row_stride + (long long)h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * row_stride + col) =
          pack_bf16(o[4 * n] / l0, o[4 * n + 1] / l0);
    if (r1 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * row_stride + col) =
          pack_bf16(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
}

// ---------------------------------------------------------------------------
// Kernels 1, 2, 3, 6 and 7 at the wide heads, D = 256 and 512 (the VAE's
// mid-block attention, one head at D = 512; JAX's kernels take it at
// block_k <= 512).  Kernels 6 and 7 are the no-shift body shifted by the
// row bound; both run the one schedule below (it already carries the score
// tile, as kernel 6 must), under two launch names, so they agree bit for bit.
// Kernel 3 is the online body (kernel 2's) plus the stores of m and l.
//
// A 64-row fp32 accumulator over all of D = 512 is 256 registers a thread,
// more than a thread has, and rows per block set the L2 traffic (every block
// streams its head's whole K and V).  So a block holds 64 query rows and its
// two warpgroups split D:
//   * warpgroup w forms the partial scores of its D/2 columns, Q K^T from
//     shared memory (wgmma m64nBKk16 over D/32 k16 steps);
//   * the two partial tiles are summed through shared memory: each thread
//     writes its 16 partial scores and reads the other warpgroup's thread of
//     the same (warp, lane), which holds the same elements; s0 + s1 is one
//     fp32 addition, the same in either order, so both warpgroups hold
//     identical scores bit for bit, hence the same P, m and l.  Two buffers,
//     alternating by tile, so one barrier per tile suffices; that barrier
//     also frees K_t's stage (both QK^T_t have landed) and V_{t-2}'s;
//   * each warpgroup runs the softmax on the whole tile (every score's exp2
//     is taken twice, once per warpgroup, against 2 D products) and issues
//     PV for its own D/2 output columns (m64n{D/2}k16, P from registers, V
//     MN-major).  The score tile is carried, as kernel 6 carries it: tile
//     t+1's QK^T is issued before tile t's softmax, so the tensor cores run
//     it while the warps exchange and exponentiate tile t, and PV_t is issued
//     a step later, so V_{t+1} is requested a whole step before it is read
//     (with two stages, V_{t+1} waits for PV_{t-1}'s stage);
//   * BK = 32 keys a tile at D = 512.  Shared memory: Q 64 rows x D (64 KB at
//     D = 512, pre-scaled in place), K and V tiles BK x D (32 KB each) in two
//     stages, and the score buffers 2 x 2 x 64 x BK x 4 B (32 KB): 224 KB of
//     the 227 KB a block may have; 64-key tiles would need 288 KB.  At D = 256
//     (no path launches it) the same template takes BK = 64 in 224 KB,
//     measured faster than 32 (scripts/torch_wide_attention_tile.py);
//   * every block streams its head's K and V from L2 itself.  Two-block
//     clusters sharing each K and V tile by TMA multicast (half the L2
//     reads) measured slower at every shape: the L2 stream does not bound
//     this body; shared-memory traffic per key (Q re-read by every QK^T
//     wgmma, the tiles' TMA writes, the exchange) is the likelier limit;
//   * the key split (kernels 3, 6 and 7): one block per SM and 64 query rows
//     a block leave most SMs idle where B * H * ceil(Lq / 64) is small (64
//     blocks on 132 SMs at the VAE's encode shape).  Where half-length
//     blocks in pairs take fewer waves (key_split_rule: where the grid fits
//     the card's resident clusters, or its last wave of whole blocks is less
//     than half full), the launch pairs each query tile's block with a
//     second one in a cluster, rank r taking the r-th half of the key tiles;
//     after both last PVs, rank 1 stores its acc, l (and m) into rank 0's
//     K / V rings and score buffers (distributed shared memory: 64 x 512
//     fp32 is exactly the rings' 128 KB), and after a cluster barrier rank
//     0 merges them in one fixed order and writes the output.  The bounded
//     softmax's shift is fixed per row, so the l and acc of disjoint key
//     ranges add with no rescale: out = (acc_0 + acc_1) / (l_0 + l_1).
//     Kernel 3's running maxima differ between the halves, so its merge
//     rescales, as ring attention's _merge does: m = max(m_0, m_1), a_r =
//     exp2(m_r - m), acc = acc_0 a_0 + acc_1 a_1, l = l_0 a_0 + l_1 a_1.
//     No atomics: the same bits every run.
// ---------------------------------------------------------------------------
#ifdef DRT_WIDE_BLOCK_K_D256
template <int D> constexpr int kWideBlockK = D == 256 ? DRT_WIDE_BLOCK_K_D256 : 32;
#else
template <int D> constexpr int kWideBlockK = D == 256 ? 64 : 32;
#endif

template <int D> struct WideCfg {
  static constexpr int BQ = 64;              // one wgmma m64, shared by both warpgroups
  static constexpr int BK = kWideBlockK<D>;
  static constexpr int DS = D / kWGS;        // a warpgroup's head-dim slice
  static constexpr int NB = D / 64;          // 128-byte boxes per bf16 row
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = NB * BQ * 128;
  static constexpr int T_BYTES = NB * BK * 128;
  static constexpr int X_BYTES = BQ * BK * 4;  // one warpgroup's partial scores
  static constexpr int X_OFFSET = Q_BYTES + 2 * STAGES * T_BYTES;
  static constexpr int BAR_OFFSET = X_OFFSET + 2 * kWGS * X_BYTES;
  static constexpr int SCRATCH_OFFSET = BAR_OFFSET + 8 * (1 + 2 * STAGES);
  static constexpr size_t smem_bytes = SCRATCH_OFFSET + 4 * (kThreads / 32 + 1);
  static_assert(smem_bytes <= 232448, "more than the 227 KB of shared memory a block may have");
  // The key split's merge: rank 1's acc (two warpgroups x 128 threads x
  // DS / 2 fp32) into rank 0's K and V rings, its l and m (four fp32 a
  // thread) into the score buffers.
  static_assert(kThreads * (DS / 2) * 4 <= 2 * STAGES * T_BYTES, "acc does not fit the rings");
  static_assert(kThreads * 16 <= 2 * kWGS * X_BYTES, "l and m do not fit the score buffers");
};

// The key split's merge, by every thread of both blocks of the cluster once
// each block's last PV has landed.  Fixed shift (kRescale false): rank 0's
// o and l (row sums, quad-summed) become acc_0 + acc_1 and l_0 + l_1.
// Running max (kRescale, kernel 3): with m = max(m_0, m_1) and a_r =
// exp2(m_r - m), they become acc_0 a_0 + acc_1 a_1 and l_0 a_0 + l_1 a_1,
// and m0 / m1 become m.  Thread tid of either block holds the same rows and
// columns, so rank 1's thread tid stores to the slots rank 0's thread tid
// reads.
template <typename C, bool kRescale, int NO>
__device__ __forceinline__ void merge_key_split(unsigned char* smem, float (&o)[NO], float& l0,
                                                float& l1, float& m0, float& m1, int rank) {
  float4* acc = reinterpret_cast<float4*>(smem + C::Q_BYTES);  // the K and V rings
  float4* ls = reinterpret_cast<float4*>(smem + C::X_OFFSET);  // the score buffers
  const int tid = threadIdx.x;
  cluster_sync();  // both blocks are done with their rings and score buffers
  if (rank == 1) {
    const uint32_t racc = map_shared_rank(smem_u32(acc), 0);
#pragma unroll
    for (int i = 0; i < NO / 4; ++i)
      st_cluster_v4(racc + (i * kThreads + tid) * 16, o[4 * i], o[4 * i + 1], o[4 * i + 2],
                    o[4 * i + 3]);
    st_cluster_v4(map_shared_rank(smem_u32(ls), 0) + tid * 16, l0, l1, m0, m1);
  }
  cluster_sync();  // rank 1's stores are visible in rank 0
  if (rank == 0) {
    const float4 y = ls[tid];  // rank 1's l0, l1, m0, m1
    float a0 = 1.f, a1 = 1.f, b0 = 1.f, b1 = 1.f;
    if constexpr (kRescale) {
      const float mx0 = fmaxf(m0, y.z), mx1 = fmaxf(m1, y.w);
      a0 = exp2f(m0 - mx0);
      b0 = exp2f(y.z - mx0);
      a1 = exp2f(m1 - mx1);
      b1 = exp2f(y.w - mx1);
      m0 = mx0;
      m1 = mx1;
    }
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      const float4 x = acc[i * kThreads + tid];
      if constexpr (kRescale) {
        o[4 * i] = o[4 * i] * a0 + x.x * b0;
        o[4 * i + 1] = o[4 * i + 1] * a0 + x.y * b0;
        o[4 * i + 2] = o[4 * i + 2] * a1 + x.z * b1;
        o[4 * i + 3] = o[4 * i + 3] * a1 + x.w * b1;
      } else {
        o[4 * i] += x.x;
        o[4 * i + 1] += x.y;
        o[4 * i + 2] += x.z;
        o[4 * i + 3] += x.w;
      }
    }
    if constexpr (kRescale) {
      l0 = l0 * a0 + y.x * b0;
      l1 = l1 * a1 + y.y * b1;
    } else {
      l0 += y.x;
      l1 += y.y;
    }
  }
}

template <int D, Mode kMode>
__device__ __forceinline__ void attend_wide(const CUtensorMap* tq, const CUtensorMap* tk,
                                            const CUtensorMap* tv, const Args& p,
                                            unsigned char* smem) {
  using C = WideCfg<D>;
  constexpr bool kRowBound = kMode == kBoundedPipe || kMode == kBounded;
  constexpr bool kRunningMax = kMode == kOnline || kMode == kPartial;
  constexpr int BK = C::BK, S = C::STAGES;
  constexpr int NS = BK / 2;       // S accumulator registers
  constexpr int NO = C::DS / 2;    // output accumulator registers
  constexpr int KP = BK / 16;      // k16 steps of PV
  constexpr int KQ = C::DS / 16;   // k16 steps of a warpgroup's partial QK^T
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + C::Q_BYTES;
  unsigned char* Vs = Ks + S * C::T_BYTES;
  float4* xs = reinterpret_cast<float4*>(smem + C::X_OFFSET);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* kbar = qbar + 1;
  uint64_t* vbar = kbar + S;

  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  // The key split: the block of cluster rank `rank` takes key tiles [t0, t0
  // + nk) of the nk_all; blocks 2i and 2i+1 share query tile i.  Unsplit,
  // every block takes them all.  The loop numbers this block's tiles from 0
  // (stages, barrier parities); its tile t holds keys from (t0 + t) * BK.
  const bool split = (kRowBound || kMode == kPartial) && p.split;
  const int nk_all = (p.Lk + BK - 1) / BK;
  int rank = 0, t0 = 0, nk = nk_all;
  if (split) {
    rank = __shfl_sync(0xffffffffu, (int)cluster_ctarank(), 0);
    const int half = (nk_all + 1) / 2;
    t0 = rank * half;
    nk = rank ? nk_all - half : half;
  }
  const int q0 = (split ? blockIdx.x >> 1 : blockIdx.x) * C::BQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(kbar + s, 1);
      mbar_init(vbar + s, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // This block's key tile t (key tile t0 + t) of K or V into its stage, by one thread.
  auto load_tile = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* bars, int t) {
    const int s = t % S;
    mbar_expect_tx(bars + s, C::T_BYTES);
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
      tma_load_4d(ring + s * C::T_BYTES + nb * BK * 128, map, bars + s, nb * 64, h,
                  (t0 + t) * BK, b);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
      tma_load_4d(Qs + nb * C::BQ * 128, tq, qbar, nb * 64, h, q0, b);
    for (int t = 0; t < S && t < nk; ++t) {
      load_tile(tk, Ks, kbar, t);
      load_tile(tv, Vs, vbar, t);
    }
  }
  // Kernels 6 and 7's fixed per-row shift (padded rows are never stored);
  // 0 for kernel 1.
  float mb0 = 0.f, mb1 = 0.f;
  if constexpr (kRowBound) {
    const long long rows = ((long long)b * p.H + h) * p.Lq;
    if (r0 < p.Lq) mb0 = p.mb[rows + r0];
    if (r1 < p.Lq) mb1 = p.mb[rows + r1];
  }
  mbar_wait(qbar, 0);
  prescale_q<C::Q_BYTES>(Qs, p.q_scale);

  // This warpgroup's D slice: the boxes from D / 128 * wg on of Q, K and V.
  const uint32_t box0 = wg * (C::DS / 64);
  const uint32_t q_addr = smem_u32(Qs) + box0 * C::BQ * 128, k_addr = smem_u32(Ks) + box0 * BK * 128,
                 v_addr = smem_u32(Vs) + box0 * BK * 128;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  auto wait_k = [&](int t) { mbar_wait(kbar + t % S, (t / S) & 1); };
  auto wait_v = [&](int t) { mbar_wait(vbar + t % S, (t / S) & 1); };
  // dst = q' K_t^T over this warpgroup's D slice; one commit group.
  auto issue_qk = [&](float (&dst)[NS], int t) {
    const uint32_t kb = k_addr + (t % S) * C::T_BYTES;
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks)
      mma_ss<BK>(dst, kmajor(q_addr, C::BQ, ks), kmajor(kb, BK, ks), ks);
    wg_commit();
  };
  // acc += P V_t over this warpgroup's D / 2 output columns.
  auto issue_pv = [&](const uint32_t (&pa)[KP][4], int t) {
    const uint32_t vb = v_addr + (t % S) * C::T_BYTES;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp)
      mma_rs_tb<C::DS>(o, pa[kp], make_desc(vb + kp * 16 * 128, BK * 128, 1024, 128), 1);
    wg_commit();
  };
  // s += the other warpgroup's partial scores of tile t.  The barrier finds
  // QK^T_t and PV_{t-1} landed in both warpgroups, so K_t's and V_{t-1}'s
  // stages are refilled: K_{t+2} and V_{t+1}.
  auto exchange = [&](float (&x)[NS], int t) {
    float4* mine = xs + ((t & 1) * kWGS + wg) * (C::X_BYTES / 16);
    const float4* other = xs + ((t & 1) * kWGS + (wg ^ 1)) * (C::X_BYTES / 16);
#pragma unroll
    for (int i = 0; i < NS / 4; ++i)
      mine[i * 128 + tw] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
      const float4 y = other[i * 128 + tw];
      x[4 * i] += y.x;
      x[4 * i + 1] += y.y;
      x[4 * i + 2] += y.z;
      x[4 * i + 3] += y.w;
    }
    if (tid == 0) {
      if (t + 2 < nk) load_tile(tk, Ks, kbar, t + 2);
      if (t >= 1 && t + 1 < nk) load_tile(tv, Vs, vbar, t + 1);
    }
  };

  // Tile j's scores in s0 (j even) or s1 (j odd).  Step j issues PV_{j-1}
  // and then QK^T_{j+1}, waits for PV_{j-1} and S_j (issued a step earlier),
  // and runs tile j's softmax while QK^T_{j+1} is in flight: the tensor cores
  // take tile j+1's products while the warps take tile j's exp2, and V_{j+1}
  // is requested a whole step before PV_{j+1} reads it.  Whether a previous
  // PV and a next QK^T exist are compile-time arguments, so every wgmma is
  // issued on every path through the loop (ptxas keeps them pipelined).
  float s0[NS], s1[NS], m0 = kNegInf, m1 = kNegInf;
  uint32_t pa[KP][4];
  auto step = [&](int j, auto buf, auto prev, auto next) {
    constexpr int B = decltype(buf)::value;        // j & 1
    constexpr bool kPrev = decltype(prev)::value;  // j >= 1
    constexpr bool kNext = decltype(next)::value;  // j + 1 < nk
    auto& cur = pick<B>(s0, s1);
    auto& nxt = pick<1 - B>(s0, s1);
    wg_fence();
    if constexpr (kPrev) {
      wait_v(j - 1);
      fence_regs(o);
      fence_regs(pa);
      issue_pv(pa, j - 1);
    }
    if constexpr (kNext) {
      wait_k(j + 1);
      fence_regs(nxt);
      issue_qk(nxt, j + 1);
      wg_wait<1>();  // S_j and PV_{j-1} have landed; S_{j+1} runs on
    } else {
      wg_wait<0>();
    }
    fence_regs(cur);
    fence_regs(o);
    fence_regs(pa);
    exchange(cur, j);
    const int key0 = (t0 + j) * BK;
    if constexpr (kRunningMax) {
      float a0, a1;
      online_softmax<BK, true>(cur, key0, p.Lk, t4, m0, m1, l0, l1, a0, a1);
      rescale(o, a0, a1);  // no PV is in flight
      pack_p<BK>(cur, pa);
    } else {
      const int lim = key0 + BK > p.Lk ? p.Lk - key0 - 2 * t4 : BK;
      exp_pack<BK>(cur, pa, mb0, mb1, lim, l0, l1);
    }
  };

  wait_k(0);
  fence_regs(o);  // acc's zeros are defined before the first wgmma is in flight
  wg_fence();
  issue_qk(s0, 0);
  if (nk == 1) {
    step(0, Buf<0>{}, Buf<0>{}, Buf<0>{});
  } else {
    step(0, Buf<0>{}, Buf<0>{}, Buf<1>{});
    int j = 1;
    for (; j + 2 < nk; j += 2) {
      step(j, Buf<1>{}, Buf<1>{}, Buf<1>{});
      step(j + 1, Buf<0>{}, Buf<1>{}, Buf<1>{});
    }
    if (j + 1 < nk) {
      step(j, Buf<1>{}, Buf<1>{}, Buf<1>{});
      step(j + 1, Buf<0>{}, Buf<1>{}, Buf<0>{});
    } else {
      step(j, Buf<1>{}, Buf<1>{}, Buf<0>{});
    }
  }
  wait_v(nk - 1);
  wg_fence();
  fence_regs(o);
  fence_regs(pa);
  issue_pv(pa, nk - 1);
  wg_wait<0>();
  fence_regs(o);

  quad_sum(l0, l1);
  if (split) {
    merge_key_split<C, kRunningMax>(smem, o, l0, l1, m0, m1, rank);
    if (rank == 1) return;
  }
  if constexpr (kMode == kPartial) {
    // JAX's partial stats, as attend's: both warpgroups hold the same m and
    // l bit for bit (the score exchange), so warpgroup 0 stores them.
    const long long rows = ((long long)b * p.H + h) * p.Lq;
    if (wg == 0 && t4 == 0 && r0 < p.Lq) p.m_out[rows + r0] = m0, p.l_out[rows + r0] = l0;
    if (wg == 0 && t4 == 0 && r1 < p.Lq) p.m_out[rows + r1] = m1, p.l_out[rows + r1] = l1;
  }
  if constexpr (!kRunningMax) {
    l0 = fmaxf(l0, 1e-37f);
    l1 = fmaxf(l1, 1e-37f);
  }
  const long long row_stride = (long long)p.H * D;
  __nv_bfloat16* ob = p.o + (long long)b * p.Lq * row_stride + (long long)h * D + wg * C::DS;
#pragma unroll
  for (int n = 0; n < C::DS / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * row_stride + col) =
          pack_bf16(o[4 * n] / l0, o[4 * n + 1] / l0);
    if (r1 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * row_stride + col) =
          pack_bf16(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
}

// Kernels 1 and 2 in one launch: bounded, every block evaluates the headroom
// rule and runs the branch it picks; unbounded, the online body.  Block
// (0, 0, 0) tallies the branch.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args p) {
  using C = Cfg<D, kBlockK<kNoShift, D>>;
  static_assert(kBlockK<kNoShift, D> == kBlockK<kOnline, D>, "both branches share one layout");
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  const int noshift =
      p.bounded ? rule::block_noshift<kThreads>(p.stats, p.B * p.H, p.log2_lk_pad,
                                                reinterpret_cast<float*>(smem + C::SCRATCH_OFFSET))
                : 0;
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(p.tally + (noshift ? 0 : 1), 1);
  if (noshift)
    attend<D, kNoShift>(&tq, &tk, &tv, p, smem);
  else
    attend<D, kOnline>(&tq, &tk, &tv, p, smem);
}

// The same at the wide heads (D = 256, 512), on attend_wide.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Args p) {
  using C = WideCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  const int noshift =
      p.bounded ? rule::block_noshift<kThreads>(p.stats, p.B * p.H, p.log2_lk_pad,
                                                reinterpret_cast<float*>(smem + C::SCRATCH_OFFSET))
                : 0;
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(p.tally + (noshift ? 0 : 1), 1);
  if (noshift)
    attend_wide<D, kNoShift>(&tq, &tk, &tv, p, smem);
  else
    attend_wide<D, kOnline>(&tq, &tk, &tv, p, smem);
}

// Kernel 3: the online body over this call's keys, with the per-row m and l
// a cross-shard merge needs.
template <int D>
__global__ void __launch_bounds__(kThreads)
    partial_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  attend<D, kPartial>(&tq, &tk, &tv, p, smem);
}

// Kernels 6 (kBoundedPipe) and 7 (kBounded): the bounded softmax on the
// caller's row bound.
template <int D, Mode kMode>
__global__ void __launch_bounds__(kThreads)
    bounded_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  attend<D, kMode>(&tq, &tk, &tv, p, smem);
}

// Kernel 3 at the wide heads, on attend_wide; with p.split, launched in
// 2-block clusters that split the keys and merge with a rescale.
template <int D>
__global__ void __launch_bounds__(kThreads)
    partial_kernel_wide(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  attend_wide<D, kPartial>(&tq, &tk, &tv, p, smem);
}

// Kernels 6 and 7 at the wide heads, on attend_wide; with p.split, launched
// in 2-block clusters that split the keys.
template <int D, Mode kMode>
__global__ void __launch_bounds__(kThreads)
    bounded_kernel_wide(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  attend_wide<D, kMode>(&tq, &tk, &tv, p, smem);
}

typedef void (*KernelFn)(CUtensorMap, CUtensorMap, CUtensorMap, Args);

// The launch configuration of a key split: 2-block clusters along x.
struct PairClusters {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  PairClusters(dim3 grid, size_t smem, cudaStream_t stream) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// One launch of `kernel` laid out by C (Cfg or WideCfg): BQ query rows a
// block, BK-key tiles; with a.split, two blocks a query tile in 2-block
// clusters.
template <int D, typename C>
int launch(KernelFn kernel, const void* q, const void* k, const void* v, const Args& a,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int e = encode_bshd(&mq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.Lq, a.H, D, 128, C::BQ);
  if (e == 0) e = encode_bshd(&mk, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.Lk, a.H, D, 128, C::BK);
  if (e == 0) e = encode_bshd(&mv, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.Lk, a.H, D, 128, C::BK);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(C::smem_bytes));
  if (ce != cudaSuccess) return ce;
  const dim3 grid((a.Lq + C::BQ - 1) / C::BQ * (a.split ? 2 : 1), a.H, a.B);
  if (a.split) {
    PairClusters pc(grid, C::smem_bytes, stream);
    return cudaLaunchKernelEx(&pc.cfg, kernel, mq, mk, mv, a);
  }
  kernel<<<grid, kThreads, C::smem_bytes, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

// The kernel of `which` and its dynamic shared bytes: 0 = kernels 1 and 2's
// launch, 1 = kernel 6, 2 = kernel 7, 3 = kernel 3.
int kernel_of(int which, int D, KernelFn* fn, size_t* smem) {
  if (which == 0 && D == 64) *fn = attention_kernel<64>, *smem = Cfg<64, kBlockK<kOnline, 64>>::smem_bytes;
  else if (which == 0 && D == 128) *fn = attention_kernel<128>, *smem = Cfg<128, kBlockK<kOnline, 128>>::smem_bytes;
  else if (which == 0 && D == 256) *fn = attention_kernel_wide<256>, *smem = WideCfg<256>::smem_bytes;
  else if (which == 0 && D == 512) *fn = attention_kernel_wide<512>, *smem = WideCfg<512>::smem_bytes;
  else if (which == 3 && D == 64) *fn = partial_kernel<64>, *smem = Cfg<64, kBlockK<kPartial, 64>>::smem_bytes;
  else if (which == 3 && D == 128) *fn = partial_kernel<128>, *smem = Cfg<128, kBlockK<kPartial, 128>>::smem_bytes;
  else if (which == 3 && D == 256) *fn = partial_kernel_wide<256>, *smem = WideCfg<256>::smem_bytes;
  else if (which == 3 && D == 512) *fn = partial_kernel_wide<512>, *smem = WideCfg<512>::smem_bytes;
  else if (which == 1 && D == 64) *fn = bounded_kernel<64, kBoundedPipe>, *smem = Cfg<64, kBlockK<kBoundedPipe, 64>>::smem_bytes;
  else if (which == 1 && D == 128) *fn = bounded_kernel<128, kBoundedPipe>, *smem = Cfg<128, kBlockK<kBoundedPipe, 128>>::smem_bytes;
  else if (which == 2 && D == 64) *fn = bounded_kernel<64, kBounded>, *smem = Cfg<64, kBlockK<kBounded, 64>>::smem_bytes;
  else if (which == 2 && D == 128) *fn = bounded_kernel<128, kBounded>, *smem = Cfg<128, kBlockK<kBounded, 128>>::smem_bytes;
  else if (which == 1 && D == 256) *fn = bounded_kernel_wide<256, kBoundedPipe>, *smem = WideCfg<256>::smem_bytes;
  else if (which == 1 && D == 512) *fn = bounded_kernel_wide<512, kBoundedPipe>, *smem = WideCfg<512>::smem_bytes;
  else if (which == 2 && D == 256) *fn = bounded_kernel_wide<256, kBounded>, *smem = WideCfg<256>::smem_bytes;
  else if (which == 2 && D == 512) *fn = bounded_kernel_wide<512, kBounded>, *smem = WideCfg<512>::smem_bytes;
  else return kUnsupported;
  return 0;
}

bool bad_sizes(int B, int Lq, int Lk, int H) {
  return B < 1 || Lq < 1 || Lk < 1 || H < 1 || B > 65535 || H > 65535;
}

// How many blocks of kernel 6, 7 or 3 (`which` 1, 2, 3) at D = 256 or 512 the
// current card holds at once, whole and as 2-block clusters; asked of the
// runtime once per kernel (a process drives one kind of card).
struct Residency {
  int blocks, pairs;
};

int wide_residency(int which, int D, Residency* r) {
  static Residency cached[3][2] = {};
  Residency& c = cached[which - 1][D == 512];
  if (c.blocks == 0) {
    KernelFn fn;
    size_t smem;
    const int e = kernel_of(which, D, &fn, &smem);
    if (e != 0) return e;
    const void* f = reinterpret_cast<const void*>(fn);
    int per_sm = 0, sms = 0, dev = 0, pairs = 0;
    cudaError_t ce = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (ce == cudaSuccess) ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, kThreads, smem);
    if (ce == cudaSuccess) ce = cudaGetDevice(&dev);
    if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    PairClusters pc(dim3(2), smem, nullptr);
    if (ce == cudaSuccess) ce = cudaOccupancyMaxActiveClusters(&pairs, f, &pc.cfg);
    if (ce != cudaSuccess) return ce;
    if (per_sm * sms == 0) return kUnsupported;
    c = {per_sm * sms, pairs};
  }
  *r = c;
  return 0;
}

// Whether kernels 3, 6 and 7 can split these keys: at the wide heads, with
// two key tiles or more (one for each block of a cluster).
bool key_split_fits(int Lk, int D) {
  if (D != 256 && D != 512) return false;
  const int bk = D == 256 ? WideCfg<256>::BK : WideCfg<512>::BK;
  return (Lk + bk - 1) / bk >= 2;
}

// The key split rule of kernels 6, 7 and 3 (`which` 1, 2, 3), where
// key_split_fits: split where the
// n = B * H * ceil(Lq / 64) query tiles, as 2-block clusters of half-length
// blocks, take fewer waves than twice the waves of whole blocks,
// ceil(n / pairs) < 2 ceil(n / blocks).  That holds where n
// fits the resident clusters (the VAE's encode shape, 64 blocks on 132 SMs)
// and where the last wave of whole blocks is less than half full (its decode
// shape, 320 blocks); where the waves come out even, the split would only
// add the merge.
int key_split_rule(int which, int B, int Lq, int Lk, int H, int D, int* split) {
  *split = 0;
  if (!key_split_fits(Lk, D)) return 0;
  Residency r;
  const int e = wide_residency(which, D, &r);
  if (e != 0) return e;
  const long long n = (long long)B * H * ((Lq + WideCfg<512>::BQ - 1) / WideCfg<512>::BQ);
  *split = r.pairs > 0 && (n + r.pairs - 1) / r.pairs < 2 * ((n + r.blocks - 1) / r.blocks);
  return 0;
}

// Whether the launch of `which` splits these keys: key_split -1 the rule of
// drt_flash_wgmma_key_split, 0 never, 1 always (D = 256, 512, two key tiles
// or more).
int split_of(int which, int key_split, int B, int Lq, int Lk, int H, int D, int* split) {
  *split = 0;
  if (key_split < 0) return key_split_rule(which, B, Lq, Lk, H, D, split);
  if (key_split > 0) {
    if (!key_split_fits(Lk, D)) return kUnsupported;
    *split = 1;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* drt_flash_wgmma_error_string(int code) {
  if (code == kUnsupported)
    return "unsupported head dim or sizes (kernels 1, 2, 3, 6 and 7 take D = 64, 128, 256, 512; "
           "a key split D = 256, 512 and two key tiles or more)";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernels 1 and 2 in one launch on (B, L, H, D) bf16 q, k, v.  bounded:
// stats is flash_headroom's buffer and the rule picks the branch; otherwise
// stats is unused and the online branch runs.  tally: int32[2], one added to
// the branch taken.
int drt_flash_wgmma_attention(const void* q, const void* k, const void* v, void* o,
                              const void* stats, void* tally, int B, int Lq, int Lk, int H, int D,
                              float q_scale, float log2_lk_pad, int bounded, void* stream) {
  if (bad_sizes(B, Lq, Lk, H)) return kUnsupported;
  Args a{static_cast<__nv_bfloat16*>(o), static_cast<const float*>(stats), static_cast<int*>(tally),
         nullptr, B, Lq, Lk, H, q_scale, log2_lk_pad, bounded};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64, Cfg<64, kBlockK<kOnline, 64>>>(attention_kernel<64>, q, k, v, a, st);
    case 128: return launch<128, Cfg<128, kBlockK<kOnline, 128>>>(attention_kernel<128>, q, k, v, a, st);
    case 256: return launch<256, WideCfg<256>>(attention_kernel_wide<256>, q, k, v, a, st);
    case 512: return launch<512, WideCfg<512>>(attention_kernel_wide<512>, q, k, v, a, st);
    default: return kUnsupported;
  }
}

// Kernel 3 on (B, L, H, D) bf16 q, k, v: out, and fp32 (B, H, Lq) m and l
// written for every query row.  key_split as drt_flash_wgmma_bounded's.
int drt_flash_wgmma_partial(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                            int B, int Lq, int Lk, int H, int D, float q_scale, int key_split,
                            void* stream) {
  KernelFn fn;
  size_t smem;
  if (bad_sizes(B, Lq, Lk, H) || kernel_of(3, D, &fn, &smem) != 0) return kUnsupported;
  Args a{static_cast<__nv_bfloat16*>(o), nullptr, nullptr, nullptr, B, Lq, Lk, H, q_scale, 0.f, 0,
         static_cast<float*>(m), static_cast<float*>(l)};
  const int e = split_of(3, key_split, B, Lq, Lk, H, D, &a.split);
  if (e != 0) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64, Cfg<64, kBlockK<kPartial, 64>>>(fn, q, k, v, a, st);
    case 128: return launch<128, Cfg<128, kBlockK<kPartial, 128>>>(fn, q, k, v, a, st);
    case 256: return launch<256, WideCfg<256>>(fn, q, k, v, a, st);
    default: return launch<512, WideCfg<512>>(fn, q, k, v, a, st);
  }
}

// Keys per tile of the wide body (attend_wide) at D = 256, 512, where the
// key split cuts between tiles; -1 at another head dim.
int drt_flash_wgmma_block_k(int D) {
  switch (D) {
    case 256: return WideCfg<256>::BK;
    case 512: return WideCfg<512>::BK;
    default: return -1;
  }
}

// The key split of these sizes for kernel 6, 7 or 3 (`which` 1, 2, 3):
// *split = 1 where drt_flash_wgmma_bounded or drt_flash_wgmma_partial splits
// the keys by default (key_split_rule).
int drt_flash_wgmma_key_split(int B, int Lq, int Lk, int H, int D, int which, int* split) {
  if (bad_sizes(B, Lq, Lk, H) || which < 1 || which > 3) return kUnsupported;
  return key_split_rule(which, B, Lq, Lk, H, D, split);
}

// Kernel 6 (pipelined) or 7 on (B, L, H, D) bf16 q, k, v and the fp32
// (B, H, Lq) row bound mb.  key_split: -1 the rule of
// drt_flash_wgmma_key_split, 0 never, 1 always (D = 256, 512, two key tiles
// or more).
int drt_flash_wgmma_bounded(const void* q, const void* k, const void* v, void* o, const void* mb,
                            int B, int Lq, int Lk, int H, int D, float q_scale, int pipelined,
                            int key_split, void* stream) {
  KernelFn fn;
  size_t smem;
  const int which = pipelined ? 1 : 2;
  if (bad_sizes(B, Lq, Lk, H) || kernel_of(which, D, &fn, &smem) != 0) return kUnsupported;
  Args a{static_cast<__nv_bfloat16*>(o), nullptr, nullptr, static_cast<const float*>(mb),
         B, Lq, Lk, H, q_scale, 0.f, 0};
  const int e = split_of(which, key_split, B, Lq, Lk, H, D, &a.split);
  if (e != 0) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return pipelined ? launch<64, Cfg<64, kBlockK<kBoundedPipe, 64>>>(fn, q, k, v, a, st)
                              : launch<64, Cfg<64, kBlockK<kBounded, 64>>>(fn, q, k, v, a, st);
    case 128: return pipelined ? launch<128, Cfg<128, kBlockK<kBoundedPipe, 128>>>(fn, q, k, v, a, st)
                               : launch<128, Cfg<128, kBlockK<kBounded, 128>>>(fn, q, k, v, a, st);
    case 256: return launch<256, WideCfg<256>>(fn, q, k, v, a, st);
    default: return launch<512, WideCfg<512>>(fn, q, k, v, a, st);
  }
}

// which: 0 = kernels 1 and 2's launch, 1 = kernel 6, 2 = kernel 7, 3 = kernel 3 (D = 64,
// 128, 256, 512).  out = {registers, local (spill) bytes, dynamic shared bytes, resident
// blocks per SM, threads per block, resident 2-block clusters of the key split (kernels 3,
// 6 and 7 at D = 256, 512; else 0)}.
int drt_flash_wgmma_occupancy(int which, int D, int* out) {
  KernelFn fn;
  size_t smem;
  const int err = kernel_of(which, D, &fn, &smem);
  if (err != 0) return err;
  const void* f = reinterpret_cast<const void*>(fn);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, f);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = kThreads;
  out[5] = 0;
  if (which >= 1 && (D == 256 || D == 512)) {
    Residency r;
    const int err2 = wide_residency(which, D, &r);
    if (err2 != 0) return err2;
    out[5] = r.pairs;
  }
  return 0;
}

}  // extern "C"
