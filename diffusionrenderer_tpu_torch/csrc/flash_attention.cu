// Bounded flash attention for Hopper (sm_90a), bf16 in, fp32 softmax state.
//
// Replaces the two Pallas kernels of diffusionrenderer_tpu/ops/flash_attention.py
// that the inverse render runs:
//   * _flash_kernel_noshift (:185-259) - p = exp2(s) with no max shift, taken
//     when the headroom rule of _bounded_cond_call (:488-491) holds;
//   * _flash_kernel / _flash_kernel_nobias (:58-118) - the online-softmax
//     fallback, and the whole of backend='pallas_onlinemax'.
// Both are one templated body (attend<D, kNoShift>).  The branch is chosen on
// the device, without a host sync: headroom_kernel reduces the Cauchy-Schwarz
// bound (max ||q_i|| * max ||k_j|| per (b, h)) and max |v| into a small stats
// buffer, and every block of flash_attention_kernel reads the same buffer and
// so takes the same branch.
//
// What bounds it on an H100: 4*Lq*Lk*H*D matmul operations against (Lq + 2 Lk)
// *H*D*2 bytes, so at the DiT's D=128 it is tensor-core bound (13 TFLOP at the
// 28,160-token flagship shape, ~13 ms at 989 TFLOP/s), with Lq*Lk*H exp2 on the
// SFUs next (~6-7 ms).  This first version keeps the design simple:
//   * one 128-thread block per (query tile, head, batch), a loop over key
//     tiles in place of the TPU's sequential grid axis;
//   * K and V tiles double-buffered in shared memory with cp.async, keys past
//     Lk zero-filled and masked in-kernel (no padded copies of q, k, v);
//   * QK^T and PV on mma.sync m16n8k16 bf16 with fp32 accumulation; S stays in
//     registers and becomes the A operand of PV directly;
//   * (B, L, H, D) read through its strides, no transposed copies;
//   * wide heads (D = 256, 512: the VAE's mid-block attention) split D across
//     warps: each warp forms the partial S of its D slice, the slices are
//     summed in shared memory in a fixed order, and each warp accumulates PV
//     for its own D slice, so the fp32 accumulator fits in registers.
// wgmma, TMA and warp specialisation are left for later work.
//
// Rounding points follow the JAX kernels: q is pre-scaled by the bf16-rounded
// softmax_scale*log2(e) and rounded back to bf16; P is cast to bf16 before PV;
// l and acc are fp32; max(l, 1e-37) only in the no-shift branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;      // the JAX kernels' padded-key bias
constexpr float kHeadroomLimit = 120.f;
constexpr int kUnsupportedHeadDim = 10000;

template <int D> struct Tile;
// WD: warps splitting the head dim; BK: keys per shared-memory tile.
template <> struct Tile<64> { static constexpr int WD = 1, BK = 64; };
template <> struct Tile<128> { static constexpr int WD = 1, BK = 64; };
template <> struct Tile<256> { static constexpr int WD = 2, BK = 64; };
template <> struct Tile<512> { static constexpr int WD = 4, BK = 32; };

template <int D> struct Cfg {
  static constexpr int WD = Tile<D>::WD;
  static constexpr int BK = Tile<D>::BK;
  static constexpr int WR = 4 / WD;      // warps along the query rows
  static constexpr int BQ = 16 * WR;     // query rows per block
  static constexpr int DS = D / WD;      // head-dim slice of one warp
  static constexpr int PITCH = D + 8;    // bf16 row pitch: +16 B keeps ldmatrix conflict-free
  static constexpr int RED_PITCH = BK + 4;
  static constexpr size_t kv_bytes = size_t(2) * 2 * BK * PITCH * sizeof(__nv_bfloat16);
  static constexpr size_t red_bytes =
      WD > 1 ? size_t(WR) * WD * 16 * RED_PITCH * sizeof(float) : 0;
  static constexpr size_t smem_bytes = kv_bytes + red_bytes;
};

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* stats;   // [qmax(B*H), kmax(B*H), vmax], read when bounded
  int* tally;           // [no-shift blocks(0,0,0), online blocks(0,0,0)]
  int B, Lq, Lk, H;
  float q_scale;        // softmax_scale * log2(e), rounded to bf16
  float log2_lk_pad;
  int bounded;
};

struct HeadArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* stats;
  int B, Lq, Lk, H, rows_per_block;
  float q_scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// Two floats -> one register of two bf16 (lo in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q pre-scaling as the JAX wrapper does it: bf16(q * bf16(scale*log2e)).
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* p, bool valid, float qs) {
  if (!valid) return 0u;
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
  return pack_bf16(__bfloat162float(x.x) * qs, __bfloat162float(x.y) * qs);
}

// max that propagates NaN (fmaxf drops it), so a NaN input selects the online
// branch as jnp.max + lax.cond do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------------------
// Headroom statistics: per (b, h) max_i ||q'_i|| and max_j ||k_j||, and the
// global max |v|, merged with integer atomicMax on the float bits (valid for
// non-negative floats; stats are zeroed before the launch).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) headroom_kernel(HeadArgs p) {
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row_stride = (long long)p.H * D;
  const int rows = max(p.Lq, p.Lk);
  const int r_begin = blockIdx.y * p.rows_per_block;
  const int r_end = min(rows, r_begin + p.rows_per_block);
  float qmax = 0.f, kmax = 0.f, vmax = 0.f;
  for (int r = r_begin + warp; r < r_end; r += kThreads / 32) {
    if (r < p.Lq) {
      const __nv_bfloat16* row = p.q + ((long long)b * p.Lq + r) * row_stride + (long long)h * D;
      float ss = 0.f;
#pragma unroll
      for (int d = lane * 2; d < D; d += 64) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(row + d);
        const float a = __bfloat162float(__float2bfloat16_rn(__bfloat162float(x.x) * p.q_scale));
        const float c = __bfloat162float(__float2bfloat16_rn(__bfloat162float(x.y) * p.q_scale));
        ss += a * a + c * c;
      }
      qmax = nan_max(qmax, sqrtf(warp_sum(ss)));
    }
    if (r < p.Lk) {
      const long long off = ((long long)b * p.Lk + r) * row_stride + (long long)h * D;
      float ss = 0.f;
#pragma unroll
      for (int d = lane * 2; d < D; d += 64) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p.k + off + d);
        const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(p.v + off + d);
        const float a = __bfloat162float(x.x), c = __bfloat162float(x.y);
        ss += a * a + c * c;
        vmax = nan_max(vmax, nan_max(fabsf(__bfloat162float(y.x)), fabsf(__bfloat162float(y.y))));
      }
      kmax = nan_max(kmax, sqrtf(warp_sum(ss)));
    }
  }
  vmax = warp_max(vmax);
  if (lane == 0) {
    int* s = reinterpret_cast<int*>(p.stats);
    const int n = p.B * p.H;
    atomicMax(s + bh, __float_as_int(qmax));
    atomicMax(s + n + bh, __float_as_int(kmax));
    atomicMax(s + 2 * n, __float_as_int(vmax));
  }
}

// ---------------------------------------------------------------------------
// Attention body.  Warp (wr, wd) owns query rows wr*16..+16 and head-dim slice
// wd*DS..+DS.  Fragment layouts are those of mma.m16n8k16: thread (g, t4) =
// (lane / 4, lane % 4) holds rows g and g+8, columns t4*2 and t4*2+1 of each
// 8-wide n-tile.
// ---------------------------------------------------------------------------
template <int D, bool kNoShift>
__device__ __forceinline__ void attend(const AttnArgs& p, unsigned char* smem) {
  using C = Cfg<D>;
  constexpr int NS = C::BK / 8;   // S n-tiles
  constexpr int KS = C::DS / 16;  // k-steps of QK^T over the warp's D slice
  constexpr int NO = C::DS / 8;   // output n-tiles
  constexpr int KP = C::BK / 16;  // k-steps of PV
  static_assert(NO % 2 == 0, "ldmatrix.x4 loads two output n-tiles");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp / C::WD, wd = warp % C::WD;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * C::BQ + wr * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < p.Lq, ok1 = r1 < p.Lq;
  const long long row_stride = (long long)p.H * D;
  const __nv_bfloat16* qb = p.q + (long long)b * p.Lq * row_stride + (long long)h * D;
  const __nv_bfloat16* kb = p.k + (long long)b * p.Lk * row_stride + (long long)h * D;
  const __nv_bfloat16* vb = p.v + (long long)b * p.Lk * row_stride + (long long)h * D;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + 2 * C::BK * C::PITCH;
  float* red = reinterpret_cast<float*>(Vs + 2 * C::BK * C::PITCH);

  // Q fragments for this warp's rows and D slice stay in registers.
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int d = wd * C::DS + ks * 16 + t4 * 2;
    qf[ks][0] = load_q_pair(qb + (long long)r0 * row_stride + d, ok0, p.q_scale);
    qf[ks][1] = load_q_pair(qb + (long long)r1 * row_stride + d, ok1, p.q_scale);
    qf[ks][2] = load_q_pair(qb + (long long)r0 * row_stride + d + 8, ok0, p.q_scale);
    qf[ks][3] = load_q_pair(qb + (long long)r1 * row_stride + d + 8, ok1, p.q_scale);
  }

  auto load_tile = [&](int stage, int tile) {
    constexpr int CPR = D / 8;  // 16-byte chunks per row
    const int k0 = tile * C::BK;
#pragma unroll 4
    for (int c = tid; c < C::BK * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const int key = k0 + r;
      const bool ok = key < p.Lk;
      const long long off = (long long)(ok ? key : 0) * row_stride + col;
      const int dst = (stage * C::BK + r) * C::PITCH + col;
      cp_async_16(smem_u32(Ks + dst), kb + off, ok);
      cp_async_16(smem_u32(Vs + dst), vb + off, ok);
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int nk = (p.Lk + C::BK - 1) / C::BK;
  load_tile(0, 0);
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      load_tile((j + 1) & 1, j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (j & 1) * C::BK * C::PITCH;
    const __nv_bfloat16* Vt = Vs + (j & 1) * C::BK * C::PITCH;

    // S = q' k^T over this warp's D slice.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int d = wd * C::DS + ks * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = Kt + (n * 8 + g) * C::PITCH + d;
        mma_bf16(s[n], qf[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    if constexpr (C::WD > 1) {
      // Sum the D-slice partials in a fixed order, so that every warp of a
      // row group holds bit-identical S (and so identical P, m and l).
      float* mine = red + (wr * C::WD + wd) * 16 * C::RED_PITCH;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int col = n * 8 + t4 * 2;
        mine[g * C::RED_PITCH + col] = s[n][0];
        mine[g * C::RED_PITCH + col + 1] = s[n][1];
        mine[(g + 8) * C::RED_PITCH + col] = s[n][2];
        mine[(g + 8) * C::RED_PITCH + col + 1] = s[n][3];
      }
      __syncthreads();
      const float* grp = red + wr * C::WD * 16 * C::RED_PITCH;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = (g + (e >> 1) * 8) * C::RED_PITCH + n * 8 + t4 * 2 + (e & 1);
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < C::WD; ++w) acc += grp[w * 16 * C::RED_PITCH + idx];
          s[n][e] = acc;
        }
      }
    }
    if ((j + 1) * C::BK > p.Lk) {  // ragged last tile: mask keys >= Lk
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * C::BK + n * 8 + t4 * 2 + (e & 1) >= p.Lk) s[n][e] = kNegInf;
    }

    if constexpr (kNoShift) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e]);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
    } else {
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
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int t = 0; t < NO; ++t) {
        o[t][0] *= a0;
        o[t][1] *= a0;
        o[t][2] *= a1;
        o[t][3] *= a1;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = exp2f(s[n][0] - m0);
        s[n][1] = exp2f(s[n][1] - m0);
        s[n][2] = exp2f(s[n][2] - m1);
        s[n][3] = exp2f(s[n][3] - m1);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
    }

    // acc += bf16(P) V over this warp's D slice; the S accumulator layout of
    // two adjacent n-tiles is exactly the A-operand layout of one k-step.
    const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int vcol = wd * C::DS + (lane >> 4) * 8;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      const uint32_t a[4] = {pack_bf16(s[2 * kp][0], s[2 * kp][1]),
                             pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                             pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                             pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
      const __nv_bfloat16* vrow = Vt + (kp * 16 + vkey) * C::PITCH + vcol;
#pragma unroll
      for (int t = 0; t < NO; t += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, smem_u32(vrow + t * 8));
        mma_bf16(o[t], a, b0, b1);
        mma_bf16(o[t + 1], a, b2, b3);
      }
    }
    __syncthreads();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if constexpr (kNoShift) {
    l0 = fmaxf(l0, 1e-37f);
    l1 = fmaxf(l1, 1e-37f);
  }
  __nv_bfloat16* ob = p.o + (long long)b * p.Lq * row_stride + (long long)h * D;
#pragma unroll
  for (int t = 0; t < NO; ++t) {
    const int d = wd * C::DS + t * 8 + t4 * 2;
    if (ok0)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * row_stride + d) =
          pack_bf16(o[t][0] / l0, o[t][1] / l0);
    if (ok1)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * row_stride + d) =
          pack_bf16(o[t][2] / l1, o[t][3] / l1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int noshift;
  __shared__ float warp_mb[kThreads / 32];
  // The headroom rule of _bounded_cond_call: the unshifted exp2(s), its row
  // sum and the PV accumulator all stay finite in fp32.  Every block reduces
  // the same stats (all threads, a few loads each), so the branch is
  // uniform across the grid.
  float mb = 0.f;
  if (p.bounded) {
    const int n = p.B * p.H;
    for (int i = threadIdx.x; i < n; i += kThreads) mb = nan_max(mb, p.stats[i] * p.stats[n + i]);
    mb = warp_max(mb);
  }
  if ((threadIdx.x & 31) == 0) warp_mb[threadIdx.x >> 5] = mb;
  __syncthreads();
  if (threadIdx.x == 0) {
    int ns = 0;
    if (p.bounded) {
      for (int w = 1; w < kThreads / 32; ++w) mb = nan_max(mb, warp_mb[w]);
      const float vmax = p.stats[2 * p.B * p.H];
      const float headroom = mb + p.log2_lk_pad + log2f(nan_max(vmax, 1e-30f));
      ns = headroom < kHeadroomLimit;  // false for NaN
    }
    noshift = ns;
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) atomicAdd(p.tally + (ns ? 0 : 1), 1);
  }
  __syncthreads();
  if (noshift)
    attend<D, true>(p, smem);
  else
    attend<D, false>(p, smem);
}

template <int D> int launch_attention(const AttnArgs& a, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(C::smem_bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Lq + C::BQ - 1) / C::BQ, a.H, a.B);
  flash_attention_kernel<D><<<grid, kThreads, C::smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* drt_error_string(int code) {
  if (code == kUnsupportedHeadDim) return "unsupported head dim (take 64, 128, 256 or 512)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int drt_flash_headroom(const void* q, const void* k, const void* v, void* stats, int B, int Lq,
                       int Lk, int H, int D, float q_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = B * H;
  cudaError_t e = cudaMemsetAsync(stats, 0, (2 * size_t(n) + 1) * sizeof(float), st);
  if (e != cudaSuccess) return e;
  const int rows = Lq > Lk ? Lq : Lk;
  int chunks = (rows + 63) / 64;
  if (chunks > 65535) chunks = 65535;
  HeadArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
             static_cast<const __nv_bfloat16*>(v), static_cast<float*>(stats),
             B, Lq, Lk, H, (rows + chunks - 1) / chunks, q_scale};
  const dim3 grid(n, chunks);
  switch (D) {
    case 64: headroom_kernel<64><<<grid, kThreads, 0, st>>>(a); break;
    case 128: headroom_kernel<128><<<grid, kThreads, 0, st>>>(a); break;
    case 256: headroom_kernel<256><<<grid, kThreads, 0, st>>>(a); break;
    case 512: headroom_kernel<512><<<grid, kThreads, 0, st>>>(a); break;
    default: return kUnsupportedHeadDim;
  }
  return cudaGetLastError();
}

int drt_flash_attention(const void* q, const void* k, const void* v, void* o, const void* stats,
                        void* tally, int B, int Lq, int Lk, int H, int D, float q_scale,
                        float log2_lk_pad, int bounded, void* stream) {
  const AttnArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                   static_cast<const float*>(stats), static_cast<int*>(tally),
                   B, Lq, Lk, H, q_scale, log2_lk_pad, bounded};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_attention<64>(a, st);
    case 128: return launch_attention<128>(a, st);
    case 256: return launch_attention<256>(a, st);
    case 512: return launch_attention<512>(a, st);
    default: return kUnsupportedHeadDim;
  }
}

}  // extern "C"
