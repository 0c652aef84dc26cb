// Kernel 2 for Hopper (sm_90a) at head dims 64 and 128: the online-softmax
// flash attention on wgmma, TMA and mbarriers.
//
// Replaces _flash_kernel / _flash_kernel_nobias of
// diffusionrenderer_tpu/ops/flash_attention.py (:58-118; pallas_call at :478
// and :675), reached through flash_attention(bounded=False),
// attention(backend='pallas_onlinemax'), flash_sp, and the online branch of
// every bounded call: there kernel 1 (csrc/flash_attention.cu) is launched
// first on the same stats buffer and this kernel's blocks evaluate the same
// headroom rule (headroom_rule.cuh) and exit when it says no-shift.  With
// q' = bf16(q * bf16(scale * log2 e)), per key tile of BK keys and query row i:
//   m_new = max(m, max_j s_ij),  alpha = exp2(m - m_new)
//   p     = exp2(s - m_new),     l = l * alpha + sum_j p,  acc = acc * alpha + bf16(p) v
// and out = acc / l (keys past Lk: s = -1e30), the rounding points of the
// mma.sync body it replaces.
//
// What bounds it on an H100: 4*Lq*Lk*H*D bf16 tensor-core operations (0.087
// ms at the DiT's (5, 1024, 32, 128)), then Lq*Lk*H exp2 on the SFUs, and
// the K and V tiles every block streams from L2 (each query block reads all
// of its head's keys: 1.3 GB per call at the DiT shape with 64-row blocks).
// The design:
//   * two warpgroups (256 threads) per block, 64 query rows each (wgmma m64),
//     sharing every K and V tile: 128 query rows per block halve the L2
//     traffic of one warpgroup per block; grid (ceil(Lq / 128), H, B),
//     (B, L, H, D) read through 4-D tensor maps;
//   * Q arrives once by TMA and is pre-scaled in place in shared memory (the
//     q_prescale rounding point), then a proxy fence before the first wgmma;
//   * K and V tiles arrive by TMA (128-byte swizzle, keys past Lk zero-filled)
//     in rings of two stages with one mbarrier each; thread 0 issues the
//     copies, two tiles ahead of use;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major); P, converted to bf16 in registers, is the register A operand
//     of the PV wgmma m64n{D}k16, V read MN-major (the transpose bit);
//   * FlashAttention-3's intra-warpgroup pipelining: tile j's QK^T and tile
//     j-1's PV are in flight together while tile j's softmax runs, so the
//     SFU work overlaps the tensor cores, and the two warpgroups overlap
//     each other (160 / 80 KB of shared memory at D = 128 / 64, one block
//     of 8 warps per SM);
//   * exp2 is one SFU instruction (ex2.approx.ftz: weights below 2^-126
//     flush to zero).
// The softmax is a template Mode, as in attend<D, Mode>; only kOnline is
// instantiated so far.

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

enum Mode { kNoShift, kOnline, kPartial, kBounded, kBoundedPipe };

template <int D> struct Cfg {
  static constexpr int BQ = 64 * kWGS;           // query rows: one wgmma m64 per warpgroup
  static constexpr int BK = 128;                 // keys per tile: the QK^T wgmma's N
  static constexpr int NB = D / 64;              // 128-byte boxes per bf16 row
  static constexpr int STAGES = 2;              // K and V tiles in flight
  static constexpr int Q_BYTES = NB * BQ * 128;
  static constexpr int T_BYTES = NB * BK * 128;  // one K or V tile
  // The tiles from the 1024-aligned start, then the barriers and the
  // rule's scratch.
  static constexpr size_t smem_bytes =
      Q_BYTES + 2 * STAGES * T_BYTES + 8 * (1 + 2 * STAGES) + 4 * (kThreads / 32 + 1);
};

struct Args {
  __nv_bfloat16* o;
  const float* stats;  // the headroom stats, read when bounded
  int* tally;          // [no-shift launches, online launches]
  int B, Lq, Lk, H;
  float q_scale;       // softmax_scale * log2(e), rounded to bf16
  float log2_lk_pad;
  int bounded;
};

template <int N>
__device__ __forceinline__ void mma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  if constexpr (N == 64) wgmma_rs_bf16_tb_n64(d, a, b, scale_d);
  else wgmma_rs_bf16_tb_n128(d, a, b, scale_d);
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

template <int D, Mode kMode>
__global__ void __launch_bounds__(kThreads)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args p) {
  static_assert(kMode == kOnline, "only the online softmax runs on this body so far");
  using C = Cfg<D>;
  constexpr int BK = C::BK, S = C::STAGES;
  constexpr int NS = BK / 2;  // S accumulator registers
  constexpr int NO = D / 2;   // output accumulator registers
  constexpr int KP = BK / 16; // k16 steps of PV
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + C::Q_BYTES;
  unsigned char* Vs = Ks + S * C::T_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + S * C::T_BYTES);
  uint64_t* kbar = qbar + 1;
  uint64_t* vbar = kbar + S;

  if (p.bounded) {  // kernel 1's call when the rule says no-shift
    if (rule::block_noshift<kThreads>(p.stats, p.B * p.H, p.log2_lk_pad,
                                      reinterpret_cast<float*>(vbar + S)))
      return;
  } else if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    atomicAdd(p.tally + 1, 1);
  }

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::BQ;
  const int nk = (p.Lk + BK - 1) / BK;

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
  if (tid == 0) {
    mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
      tma_load_4d(Qs + nb * C::BQ * 128, &tq, qbar, nb * 64, h, q0, b);
    for (int t = 0; t < S && t < nk; ++t) load_tile(&tk, Ks, kbar, t);
    for (int t = 0; t < S - 1 && t < nk; ++t) load_tile(&tv, Vs, vbar, t);
  }

  // q' = bf16(q * q_scale) in place: elementwise, so the swizzle is immaterial.
  mbar_wait(qbar, 0);
  for (int i = tid; i < C::Q_BYTES / 16; i += kThreads) {
    uint4 x = reinterpret_cast<uint4*>(Qs)[i];
    x.x = scale_pair(x.x, p.q_scale);
    x.y = scale_pair(x.y, p.q_scale);
    x.z = scale_pair(x.z, p.q_scale);
    x.w = scale_pair(x.w, p.q_scale);
    reinterpret_cast<uint4*>(Qs)[i] = x;
  }
  fence_proxy_async();
  __syncthreads();

  // This warpgroup's 64 rows of each Q box.
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128, k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
  float s[NS], o[NO];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // S = q' K_t^T; one commit group.
  auto issue_qk = [&](int t) {
    const uint32_t kb = k_addr + (t % S) * C::T_BYTES;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_bf16_n128(s, kmajor(q_addr, C::BQ, ks), kmajor(kb, BK, ks), ks);
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
  // Tile t's scores in s -> P in place (fp32), the running max and l
  // updated, and the rescale of acc in a0 / a1 (applied by the caller once
  // the previous tile's PV has landed).  Thread (g, t4) of warp w holds rows
  // 16w+g and 16w+g+8, keys 8n + 2 t4 (+1) of each n8 tile.
  auto softmax = [&](int t, float& a0, float& a1) {
    if ((t + 1) * BK > p.Lk) {  // ragged last tile: mask keys >= Lk
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * BK + n * 8 + 2 * t4 + (e & 1) >= p.Lk) s[4 * n + e] = kNegInf;
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
    a0 = ex2(m0 - mx0);
    a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = ex2(s[4 * n] - m0);
      s[4 * n + 1] = ex2(s[4 * n + 1] - m0);
      s[4 * n + 2] = ex2(s[4 * n + 2] - m1);
      s[4 * n + 3] = ex2(s[4 * n + 3] - m1);
      l0 += s[4 * n] + s[4 * n + 1];
      l1 += s[4 * n + 2] + s[4 * n + 3];
    }
  };
  // P to bf16: two adjacent n8 tiles of the accumulator are one k16 A fragment.
  auto pack_p = [&](uint32_t (&pa)[KP][4]) {
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      pa[kp][0] = pack_bf16(s[8 * kp], s[8 * kp + 1]);
      pa[kp][1] = pack_bf16(s[8 * kp + 2], s[8 * kp + 3]);
      pa[kp][2] = pack_bf16(s[8 * kp + 4], s[8 * kp + 5]);
      pa[kp][3] = pack_bf16(s[8 * kp + 6], s[8 * kp + 7]);
    }
  };

  uint32_t pa[KP][4];
  float a0, a1;
  mbar_wait(kbar, 0);
  wg_fence();
  issue_qk(0);
  wg_wait<0>();
  fence_regs(s);
  softmax(0, a0, a1);
  pack_p(pa);
  __syncthreads();  // every warp is done with K_0's stage
  if (tid == 0) {
    if (S < nk) load_tile(&tk, Ks, kbar, S);
    if (S - 1 < nk) load_tile(&tv, Vs, vbar, S - 1);
  }
  for (int j = 1; j < nk; ++j) {
    mbar_wait(kbar + j % S, (j / S) & 1);
    wg_fence();
    fence_regs(o);
    fence_regs(pa);
    issue_qk(j);
    mbar_wait(vbar + (j - 1) % S, ((j - 1) / S) & 1);
    issue_pv(pa, j - 1);
    wg_wait<1>();  // S_j has landed; PV_{j-1} may still run
    fence_regs(s);
    softmax(j, a0, a1);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pa);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }
    pack_p(pa);
    __syncthreads();  // K_j's and V_{j-1}'s stages are free
    if (tid == 0) {
      if (j + S < nk) load_tile(&tk, Ks, kbar, j + S);
      if (j + S - 1 < nk) load_tile(&tv, Vs, vbar, j + S - 1);
    }
  }
  mbar_wait(vbar + (nk - 1) % S, ((nk - 1) / S) & 1);
  wg_fence();
  fence_regs(o);
  fence_regs(pa);
  issue_pv(pa, nk - 1);
  wg_wait<0>();
  fence_regs(o);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
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

template <int D> const void* kernel_of() { return (const void*)flash_wgmma_kernel<D, kOnline>; }

template <int D>
int launch(const void* q, const void* k, const void* v, const Args& a, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  int e = encode_bshd(&mq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.Lq, a.H, D, 128, C::BQ);
  if (e == 0) e = encode_bshd(&mk, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.Lk, a.H, D, 128, C::BK);
  if (e == 0) e = encode_bshd(&mv, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.Lk, a.H, D, 128, C::BK);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(flash_wgmma_kernel<D, kOnline>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(C::smem_bytes));
  if (ce != cudaSuccess) return ce;
  const dim3 grid((a.Lq + C::BQ - 1) / C::BQ, a.H, a.B);
  flash_wgmma_kernel<D, kOnline><<<grid, kThreads, C::smem_bytes, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* drt_flash_wgmma_error_string(int code) {
  if (code == kUnsupported) return "unsupported head dim or sizes (the wgmma kernel takes D = 64, 128)";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel 2 on (B, L, H, D) bf16 q, k, v.  bounded: stats is flash_headroom's
// buffer and the blocks exit when the headroom rule says no-shift (kernel 1,
// launched beside this on the same stream, then writes o and tallies);
// otherwise stats is unused and the launch tallies one online branch.
int drt_flash_online(const void* q, const void* k, const void* v, void* o, const void* stats,
                     void* tally, int B, int Lq, int Lk, int H, int D, float q_scale,
                     float log2_lk_pad, int bounded, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || B > 65535 || H > 65535) return kUnsupported;
  Args a{static_cast<__nv_bfloat16*>(o), static_cast<const float*>(stats), static_cast<int*>(tally),
         B, Lq, Lk, H, q_scale, log2_lk_pad, bounded};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, a, st);
    case 128: return launch<128>(q, k, v, a, st);
    default: return kUnsupported;
  }
}

// out = {registers, local (spill) bytes, dynamic shared bytes, resident blocks per SM,
// threads per block}.
int drt_flash_online_occupancy(int D, int* out) {
  const void* fn;
  size_t smem;
  switch (D) {
    case 64: fn = kernel_of<64>(); smem = Cfg<64>::smem_bytes; break;
    case 128: fn = kernel_of<128>(); smem = Cfg<128>::smem_bytes; break;
    default: return kUnsupported;
  }
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = kThreads;
  return 0;
}

}  // extern "C"
