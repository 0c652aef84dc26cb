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
// bound.  This first version keeps the design simple, as the bf16 kernel in
// flash_attention.cu does:
//   * one 128-thread block per (query tile, head, batch) and a loop over key
//     tiles, K and V double-buffered in shared memory with cp.async,
//     zero-filled past Lk;
//   * QK^T on mma.sync.m16n8k32.row.col.s32.s8.s8.s32: q (Lq x D, row-major)
//     is the A operand straight from device memory, k (Lk x D, D-contiguous)
//     is already the "col" B operand, read with plain ldmatrix;
//   * bf16 PV: the S accumulator of two adjacent n8 tiles is the A operand of
//     one m16n8k16 step (as in flash_attention.cu), V read with ldmatrix.trans;
//   * int8 PV: ldmatrix.trans cannot transpose bytes, so the V pre-pass writes
//     int8 V transposed per (b, h), (B, H, D, Lk_pad), channel rows with keys
//     contiguous.  The P fragment: an s32/f32 accumulator of m16n8k32 holds
//     keys 2*t4, 2*t4+1 (+8, +16, +24) of a 32-key step, while the s8 A
//     operand wants keys 4*t4..+3 and 16+4*t4..+3.  Rather than shuffle P
//     within the quad, the pre-pass PERMUTES THE KEY ORDER of each 32-key
//     group of transposed V (position 16h + 4t + 2a + b holds key
//     16h + 8a + 2t + b), so each thread packs its own four P values into an
//     A register as they lie; the sum over keys does not depend on their order.
//   * wide heads (D = 256, 512) split D across warps (Tile<D>): a warp holding
//     all D output columns would need D/2 fp32 accumulator registers (256 at
//     D = 512, past the 255 cap) plus D/8 for its q fragments.  Warp (wr, wd)
//     owns query rows wr*16..+16 and head-dim slice wd*DS..+DS: it forms the
//     int32 partial QK^T of its slice, the WD partials of a row group are
//     summed in shared memory (int32 sums are exact, so every warp of the group
//     holds the same S, and so the same m, l and P, whatever the order), and it
//     accumulates PV for its own DS output columns.  Per warp the work is then
//     that of D = 128.  At D = 512 the key tile is 32 (shared memory: two
//     stages of 64-key bf16 V would take 220 KB and one block per SM; 32 keys
//     take 112 KB and leave two), so the plain version walks 32-key tiles there.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the JAX kernel's padded-key bias
constexpr float kLog2_127 = 6.988684686772166f;
constexpr int kUnsupported = 10002;

template <int D> struct Tile;
// WD: warps splitting the head dim; BK: keys per shared-memory tile.
template <> struct Tile<64> { static constexpr int WD = 1, BK = 64; };
template <> struct Tile<128> { static constexpr int WD = 1, BK = 64; };
template <> struct Tile<256> { static constexpr int WD = 2, BK = 64; };
template <> struct Tile<512> { static constexpr int WD = 4, BK = 32; };

template <int D, bool kPv8> struct Cfg {
  static constexpr int WD = Tile<D>::WD;
  static constexpr int BK = Tile<D>::BK;
  static constexpr int WR = 4 / WD;                    // warps along the query rows
  static constexpr int BQ = 16 * WR;                   // query rows per block
  static constexpr int DS = D / WD;                    // head-dim slice of one warp
  static constexpr int KPITCH = D + 16;                // int8 K rows (bytes)
  static constexpr int VPITCH = kPv8 ? BK + 16 : (D + 8) * 2;  // bytes per V smem row
  static constexpr int VROWS = kPv8 ? D : BK;
  static constexpr int RED_PITCH = BK + 4;             // int32 partial S rows
  static constexpr int k_bytes = BK * KPITCH;
  static constexpr int v_bytes = VROWS * VPITCH;
  static constexpr int stage_bytes = k_bytes + v_bytes + BK * 4;  // + the tile's sk
  static constexpr int red_bytes = WD > 1 ? WR * WD * 16 * RED_PITCH * 4 : 0;
  static constexpr size_t smem_bytes = size_t(2) * stage_bytes + red_bytes + D * 4;  // + sv
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four p in [0, 127] -> four int8 codes (round half to even), lowest key first.
__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c, float d) {
  return (uint32_t)(__float2int_rn(a) & 0xff) | ((uint32_t)(__float2int_rn(b) & 0xff) << 8) |
         ((uint32_t)(__float2int_rn(c) & 0xff) << 16) | ((uint32_t)(__float2int_rn(d) & 0xff) << 24);
}

__device__ __forceinline__ uint32_t load_q4(const int8_t* p, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

template <int D, bool kPv8>
__global__ void __launch_bounds__(kThreads) flash_int8_kernel(Args p) {
  using C = Cfg<D, kPv8>;
  constexpr int BK = C::BK, DS = C::DS;
  constexpr int NS = BK / 8;   // S n-tiles per key tile
  constexpr int KS = DS / 32;  // k32 steps of QK^T over the warp's D slice
  constexpr int NO = DS / 8;   // output n-tiles of the warp's D slice
  static_assert(NO % 2 == 0 && (BK == 32 || BK == 64), "tile shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  int* red = reinterpret_cast<int*>(smem + 2 * C::stage_bytes);
  float* sv_s = reinterpret_cast<float*>(smem + 2 * C::stage_bytes + C::red_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp / C::WD, wd = warp % C::WD;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * C::BQ + wr * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < p.Lq, ok1 = r1 < p.Lq;
  const long long row_stride = (long long)p.H * D;
  const long long bh = (long long)b * p.H + h;
  const int8_t* qb = p.q + (long long)b * p.Lq * row_stride + (long long)h * D;
  const int8_t* kb = p.k + (long long)b * p.Lk * row_stride + (long long)h * D;
  const float* skb = p.sk + bh * p.Lk;

  if constexpr (kPv8) {
    for (int c = tid; c < D; c += kThreads) sv_s[c] = p.sv[bh * D + c];
  }

  // q fragments (A operand) for this warp's 16 rows and D slice stay in registers.
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int d = wd * DS + ks * 32 + 4 * t4;
    qf[ks][0] = load_q4(qb + (long long)r0 * row_stride + d, ok0);
    qf[ks][1] = load_q4(qb + (long long)r1 * row_stride + d, ok1);
    qf[ks][2] = load_q4(qb + (long long)r0 * row_stride + d + 16, ok0);
    qf[ks][3] = load_q4(qb + (long long)r1 * row_stride + d + 16, ok1);
  }
  const float sq0 = ok0 ? p.sq[bh * p.Lq + r0] : 0.f;
  const float sq1 = ok1 ? p.sq[bh * p.Lq + r1] : 0.f;

  auto load_tile = [&](int stage, int tile) {
    unsigned char* Ks = smem + stage * C::stage_bytes;
    unsigned char* Vs = Ks + C::k_bytes;
    float* sks = reinterpret_cast<float*>(Vs + C::v_bytes);
    const int k0 = tile * BK;
    constexpr int KCPR = D / 16;  // 16-byte chunks per K row
    for (int c = tid; c < BK * KCPR; c += kThreads) {
      const int r = c / KCPR, col = (c % KCPR) * 16;
      const bool ok = k0 + r < p.Lk;
      cp_async_16(smem_u32(Ks + r * C::KPITCH + col),
                  kb + (ok ? (long long)(k0 + r) * row_stride + col : 0), ok);
    }
    if constexpr (kPv8) {
      // Transposed int8 V: D channel rows of BK (permuted) keys; lk_pad is a
      // multiple of BK, zero past Lk, so every chunk is in bounds.
      const int8_t* vt = static_cast<const int8_t*>(p.v) + bh * D * (long long)p.lk_pad + k0;
      constexpr int VCPR = BK / 16;
      for (int c = tid; c < D * VCPR; c += kThreads) {
        const int r = c / VCPR, col = (c % VCPR) * 16;
        cp_async_16(smem_u32(Vs + r * C::VPITCH + col), vt + (long long)r * p.lk_pad + col, true);
      }
    } else {
      const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                                (long long)b * p.Lk * row_stride + (long long)h * D;
      constexpr int VCPR = D / 8;  // 16-byte chunks (8 bf16) per V row
      for (int c = tid; c < BK * VCPR; c += kThreads) {
        const int r = c / VCPR, col = (c % VCPR) * 8;
        const bool ok = k0 + r < p.Lk;
        cp_async_16(smem_u32(Vs + r * C::VPITCH + col * 2),
                    vb + (ok ? (long long)(k0 + r) * row_stride + col : 0), ok);
      }
    }
    cp_async_commit();
    if (tid < BK) sks[tid] = k0 + tid < p.Lk ? skb[k0 + tid] : 0.f;
  };

  float o[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // ldmatrix.x4 lane addresses of two 8-row groups x two 16-byte columns.
  const int kb_row = (lane & 7) + (lane >> 4) * 8, kb_col = ((lane >> 3) & 1) * 16;
  const int nk = (p.Lk + BK - 1) / BK;
  load_tile(0, 0);
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      load_tile((j + 1) & 1, j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* Ks = smem + (j & 1) * C::stage_bytes;
    const unsigned char* Vs = Ks + C::k_bytes;
    const float* sks = reinterpret_cast<const float*>(Vs + C::v_bytes);

    // S = qi ki^T in int32 over this warp's D slice.
    int si[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(Ks + (n * 8 + kb_row) * C::KPITCH + wd * DS + ks * 32 + kb_col));
        mma_s8(si[n], qf[ks], r[0], r[1]);
        mma_s8(si[n + 1], qf[ks], r[2], r[3]);
      }
    }
    if constexpr (C::WD > 1) {
      // The D-slice partials of a row group, summed in shared memory: exact
      // int32 sums, so every warp of the group holds the same S.
      int* mine = red + (wr * C::WD + wd) * 16 * C::RED_PITCH;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int col = n * 8 + 2 * t4;
        mine[g * C::RED_PITCH + col] = si[n][0];
        mine[g * C::RED_PITCH + col + 1] = si[n][1];
        mine[(g + 8) * C::RED_PITCH + col] = si[n][2];
        mine[(g + 8) * C::RED_PITCH + col + 1] = si[n][3];
      }
      __syncthreads();
      const int* grp = red + wr * C::WD * 16 * C::RED_PITCH;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = (g + (e >> 1) * 8) * C::RED_PITCH + n * 8 + 2 * t4 + (e & 1);
          int acc = 0;
#pragma unroll
          for (int w = 0; w < C::WD; ++w) acc += grp[w * 16 * C::RED_PITCH + idx];
          si[n][e] = acc;
        }
      }
    }
    // The rank-1 dequant (s * sq_i) * sk_j.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int key = n * 8 + 2 * t4;
      const float k0s = sks[key], k1s = sks[key + 1];
      s[n][0] = __fmul_rn(__fmul_rn(__int2float_rn(si[n][0]), sq0), k0s);
      s[n][1] = __fmul_rn(__fmul_rn(__int2float_rn(si[n][1]), sq0), k1s);
      s[n][2] = __fmul_rn(__fmul_rn(__int2float_rn(si[n][2]), sq1), k0s);
      s[n][3] = __fmul_rn(__fmul_rn(__int2float_rn(si[n][3]), sq1), k1s);
    }
    if ((j + 1) * BK > p.Lk) {  // ragged last tile: keys >= Lk
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * BK + n * 8 + 2 * t4 + (e & 1) >= p.Lk) s[n][e] = kNegInf;
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(__fsub_rn(m0, mx0)), a1 = exp2f(__fsub_rn(m1, mx1));
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = __fsub_rn(s[n][e], e < 2 ? m0 : m1);
        s[n][e] = exp2f(kPv8 ? __fadd_rn(d, kLog2_127) : d);
      }
      ps0 = __fadd_rn(ps0, __fadd_rn(s[n][0], s[n][1]));
      ps1 = __fadd_rn(ps1, __fadd_rn(s[n][2], s[n][3]));
    }
    l0 = __fadd_rn(__fmul_rn(l0, a0), ps0);
    l1 = __fadd_rn(__fmul_rn(l1, a1), ps1);

    if constexpr (kPv8) {
      // P as int8 A fragments, in the permuted key order of transposed V.
      uint32_t pa[BK / 32][4];
#pragma unroll
      for (int kp = 0; kp < BK / 32; ++kp) {
        const int n = 4 * kp;
        pa[kp][0] = pack_s8(s[n][0], s[n][1], s[n + 1][0], s[n + 1][1]);
        pa[kp][1] = pack_s8(s[n][2], s[n][3], s[n + 1][2], s[n + 1][3]);
        pa[kp][2] = pack_s8(s[n + 2][0], s[n + 2][1], s[n + 3][0], s[n + 3][1]);
        pa[kp][3] = pack_s8(s[n + 2][2], s[n + 2][3], s[n + 3][2], s[n + 3][3]);
      }
      // acc = acc * alpha + f32(P_i8 V_i8) * sv for output n-tile t.
      auto dequant_acc = [&](float (&acc)[4], const int (&pv)[4], int t) {
        const int c = wd * DS + t * 8 + 2 * t4;
        const float sv0 = sv_s[c], sv1 = sv_s[c + 1];
        acc[0] = __fadd_rn(__fmul_rn(acc[0], a0), __fmul_rn(__int2float_rn(pv[0]), sv0));
        acc[1] = __fadd_rn(__fmul_rn(acc[1], a0), __fmul_rn(__int2float_rn(pv[1]), sv1));
        acc[2] = __fadd_rn(__fmul_rn(acc[2], a1), __fmul_rn(__int2float_rn(pv[2]), sv0));
        acc[3] = __fadd_rn(__fmul_rn(acc[3], a1), __fmul_rn(__int2float_rn(pv[3]), sv1));
      };
      const unsigned char* Vw = Vs + wd * DS * C::VPITCH;  // this warp's channel rows
      if constexpr (BK == 64) {
        const int v_row = lane & 7, v_col = (lane >> 3) * 16;
#pragma unroll
        for (int t = 0; t < NO; ++t) {
          uint32_t r[4];  // b0, b1 of key steps 0 and 1 for channels 8t..8t+7
          ldmatrix_x4(r, smem_u32(Vw + (t * 8 + v_row) * C::VPITCH + v_col));
          int pv[4] = {0, 0, 0, 0};
          mma_s8(pv, pa[0], r[0], r[1]);
          mma_s8(pv, pa[1], r[2], r[3]);
          dequant_acc(o[t], pv, t);
        }
      } else {
#pragma unroll
        for (int t = 0; t < NO; t += 2) {
          uint32_t r[4];  // b0, b1 of the one key step for channels 8t.. and 8(t+1)..
          ldmatrix_x4(r, smem_u32(Vw + (t * 8 + kb_row) * C::VPITCH + kb_col));
          int pv0[4] = {0, 0, 0, 0}, pv1[4] = {0, 0, 0, 0};
          mma_s8(pv0, pa[0], r[0], r[1]);
          mma_s8(pv1, pa[0], r[2], r[3]);
          dequant_acc(o[t], pv0, t);
          dequant_acc(o[t + 1], pv1, t + 1);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < NO; ++t) {
        o[t][0] = __fmul_rn(o[t][0], a0);
        o[t][1] = __fmul_rn(o[t][1], a0);
        o[t][2] = __fmul_rn(o[t][2], a1);
        o[t][3] = __fmul_rn(o[t][3], a1);
      }
      const __nv_bfloat16* Vt = reinterpret_cast<const __nv_bfloat16*>(Vs);
      constexpr int VP = C::VPITCH / 2;  // pitch in bf16 elements
      const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int vcol = wd * DS + (lane >> 4) * 8;
#pragma unroll
      for (int kp = 0; kp < BK / 16; ++kp) {
        const uint32_t a[4] = {pack_bf16(s[2 * kp][0], s[2 * kp][1]),
                               pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                               pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                               pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
        const __nv_bfloat16* vrow = Vt + (kp * 16 + vkey) * VP + vcol;
#pragma unroll
        for (int t = 0; t < NO; t += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_u32(vrow + t * 8));
          mma_bf16(o[t], a, r[0], r[1]);
          mma_bf16(o[t + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __nv_bfloat16* ob = p.o + (long long)b * p.Lq * row_stride + (long long)h * D;
#pragma unroll
  for (int t = 0; t < NO; ++t) {
    const int d = wd * DS + t * 8 + 2 * t4;
    if (ok0)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * row_stride + d) =
          pack_bf16(o[t][0] / l0, o[t][1] / l0);
    if (ok1)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * row_stride + d) =
          pack_bf16(o[t][2] / l1, o[t][3] / l1);
  }
}

template <int D, bool kPv8> int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<D, kPv8>;
  if (kPv8 && (a.lk_pad < a.Lk || a.lk_pad % C::BK)) return kUnsupported;
  cudaError_t e = cudaFuncSetAttribute(flash_int8_kernel<D, kPv8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(C::smem_bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Lq + C::BQ - 1) / C::BQ, a.H, a.B);
  flash_int8_kernel<D, kPv8><<<grid, kThreads, C::smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* drt_flash_int8_error_string(int code) {
  if (code == kUnsupported) return "unsupported head dim or sizes (D in {64, 128, 256, 512})";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Keys per tile at head dim D (the plain version walks the same tiles), or
// -1 for a head dim the kernel does not take.
int drt_flash_int8_block_k(int D) {
  switch (D) {
    case 64: return Tile<64>::BK;
    case 128: return Tile<128>::BK;
    case 256: return Tile<256>::BK;
    case 512: return Tile<512>::BK;
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
    case 128: return launch<64, false>(a, st);
    case 129: return launch<64, true>(a, st);
    case 256: return launch<128, false>(a, st);
    case 257: return launch<128, true>(a, st);
    case 512: return launch<256, false>(a, st);
    case 513: return launch<256, true>(a, st);
    case 1024: return launch<512, false>(a, st);
    case 1025: return launch<512, true>(a, st);
    default: return kUnsupported;
  }
}

}  // extern "C"
