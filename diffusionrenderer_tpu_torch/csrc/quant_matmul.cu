// W8A8 matmul for Hopper (sm_90a): int8 x int8 -> int32 on the tensor cores
// (wgmma), operands by TMA through an mbarrier ring, per-channel or
// per-group fp32 weight scales, per-token dequant, bf16/fp32 out.
//
// Replaces the Pallas kernel `_kernel` of quant_matmul_w8a8 in
// diffusionrenderer_tpu/ops/quant_matmul.py (:70-130, called at :230).  It
// computes, for xq (M, K) int8, w (N, K) int8, dequant (M,) fp32:
//   per-channel scales s (N,):   out[m, n] = (f32(sum_k xq*w) * s[n]) * dequant[m]
//   grouped scales s (G, N):     acc = 0; for g in order:
//                                  acc = fma(f32(sum_{k in g} xq*w), s[g, n], acc)
//                                out[m, n] = acc * dequant[m]
// The group fold is one fused multiply-add, as XLA compiles the JAX kernel's
// `acc += part * s`; every other fp32 step is rounded on its own (__fmul_rn),
// so the plain version in ops/quant_matmul.py reproduces the kernel bit for
// bit.  |xq|, |w| <= 127, so an int32 run over K <= 16384 cannot overflow.
//
// What bounds it on an H100: 2*M*N*K int8 operations at 1,979 TOP/s against
// (M*K + N*K + 2*M*N) bytes at 3.35 TB/s; at the DiT's M = 5,120 rows and
// K, N in {4096, 16384} it is operation bound (0.087-0.347 ms).  The design
// keeps the tensor cores fed:
//   * one block per output tile: 2 consumer warpgroups of 64 rows (wgmma
//     m64) and a producer warpgroup, of which one warp works.  The tile is
//     128 x 256 per channel (each consumer 64 x 256: 128 int32 accumulator
//     registers a thread) and 128 x 128 grouped (64 int32 + 64 fp32): ptxas
//     holds every thread of a 384-thread block to 168 registers;
//   * both operands arrive by TMA through 2-D tensor maps, in K steps of 128
//     bytes (one 128-byte swizzle span), into a ring of 4 stages with one
//     full and one empty mbarrier each.  Rows past M or N and the K tail are
//     zero-filled by the box.  The weight stays in PyTorch's (out, in)
//     layout: w (N, K) is the K-major B operand wgmma s8 requires, as xq
//     (M, K) is the K-major A;
//   * the consumers run wgmma.m64n{256,128}k32.s32.s8.s8 with both operands
//     in shared memory, keep one stage's wgmma in flight and release the
//     stage before it; one producer thread refills a stage once all 8
//     consumer warps have released it;
//   * grouped: each group's int32 run starts with scale-d = 0 (no zeroing);
//     after the group's last k32 step the warpgroup waits for its wgmma and
//     folds the run into the fp32 accumulator, in group order, with
//     cvt.rn.f32.s32 (I2FP, as int_matmul_exact's .float() rounds; the
//     1.5 * 2^23 trick was no faster) and one FFMA an element.  The
//     producer warp copies each group's scale row into the stage that ends
//     the group by cp.async, signalled on a third mbarrier of that stage:
//     neither the fold nor the producer waits on a global load (a producer
//     that loaded the scales itself held every later stage's TMA back by a
//     load latency and starved the ring), and stages that end no group
//     carry no scale traffic.  Where the group is a multiple of 128 only a
//     stage's end can end one, and the stage's four wgmma issue back to
//     back before the fold;
//   * the epilogue stores from registers, predicated, in the fp32 order above;
//   * grid (M tiles, N tiles), M fastest: the blocks in flight share a few
//     weight tiles and stream the activations, which stay in L2 at K = 4,096.
// Group sizes are multiples of 32 dividing K, so a group holds whole k32
// steps and K is then a multiple of 32; a per-channel K % 32 == 16 ends in a
// k32 step half of zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int BM = 64 * kConsumers;
constexpr int BK = 128;                          // bytes (= int8 elements) per stage
constexpr int KS = BK / 32;                      // k32 steps per stage
constexpr int STAGES = 4;
constexpr int kBadShape = 10001;

template <bool kGrouped> struct Tile {
  static constexpr int BN = kGrouped ? 128 : 256;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int TMA_BYTES = (BM + BN) * BK;
  // Grouped: after the operands, one scale row slot (BN fp32) per k32 step,
  // filled where that step ends a group.
  static constexpr int STAGE_BYTES = TMA_BYTES + (kGrouped ? KS * BN * 4 : 0);
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  static constexpr size_t smem_bytes = BAR_OFFSET + 3 * STAGES * sizeof(uint64_t);
  static_assert(STAGE_BYTES % 1024 == 0, "the swizzled tiles need 1024-byte aligned stages");
};

struct Args {
  const float* scale;     // (N,) or (G, N)
  const float* dequant;   // (M,)
  void* out;              // (M, N), bf16 or fp32
  int M, N, K, group;     // group = 0: per-channel
};

template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 256) wgmma_ss_s8_n256(d, a, b, scale_d);
  else wgmma_ss_s8_n128(d, a, b, scale_d);
}

// A K-major tile of 128-byte rows, 128-byte swizzle: the k32 step ks.
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int ks) {
  return make_desc(base + ks * 32, 16, 1024, 128);
}

template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b, bool two,
                                                                 bool paired);

template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                      float b, bool two,
                                                                      bool paired) {
  if (two && paired) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (two) p[1] = __float2bfloat16_rn(b);
  }
}

template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b, bool two,
                                                              bool paired) {
  if (two && paired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}

// Accumulator layout (wgmma m64nN, as mma.sync's m16n8 C fragment over N/8
// tiles): thread (g, t4) = (lane / 4, lane % 4) of warp w of its warpgroup
// holds, in d[4j + e], row 16w + g + 8 (e / 2) and column 8j + 2 t4 + (e % 2).
template <typename OutT, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const Args p) {
  using T = Tile<kGrouped>;
  constexpr int BN = T::BN, NA = BN / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* scaled = empty + STAGES;  // grouped: a stage's scale rows have landed
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (p.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);  // one arrival per consumer warp
      mbar_init(scaled + s, 32);             // one per lane of the producer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Whether the k32 step at byte kg ends a group (steps past K end none), and
  // whether stage kt holds such a step.
  auto ends_group = [&](int kg) { return (kg + 32) % p.group == 0 && kg < p.K; };
  auto scaled_stage = [&](int kt) {
    bool any = false;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) any |= ends_group(kt * BK + ks * 32);
    return any;
  };

  if (wg == kConsumers) {  // the producer warpgroup: its first warp
    if (tid != 128 * kConsumers + lane) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      unsigned char* st = smem + s * T::STAGE_BYTES;
      if (lane == 0) {
        if (kt >= STAGES) mbar_wait(empty + s, (kt / STAGES - 1) & 1);
        mbar_expect_tx(full + s, T::TMA_BYTES);
        tma_load_2d(st, &tx, full + s, kt * BK, m0);
        tma_load_2d(st + T::A_BYTES, &tw, full + s, kt * BK, n0);
      }
      // Lane l copies columns n0 + l + 32 i of the scale row of each group
      // the stage ends, once lane 0 has seen the stage free.
      if (kGrouped && scaled_stage(kt)) {
        __syncwarp();
        float* slot = reinterpret_cast<float*>(st + T::TMA_BYTES);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int kg = kt * BK + ks * 32;
          if (!ends_group(kg)) continue;
          const float* row = p.scale + (long long)(kg / p.group) * p.N;
#pragma unroll
          for (int i = 0; i < BN / 32; ++i) {
            const int n = n0 + lane + 32 * i;
            cp_async_4(slot + ks * BN + lane + 32 * i, row + (n < p.N ? n : 0), n < p.N);
          }
        }
        cp_async_mbar_arrive(scaled + s);  // asynchronous: the next stage's copies go out now
      }
    }
    return;
  }

  const int g = lane >> 2, t4 = lane & 3;
  int acc[NA];
  float accf[kGrouped ? NA : 1];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    acc[i] = 0;
    if constexpr (kGrouped) accf[i] = 0.f;
  }
  fence_regs(acc);  // the zeros are defined before the first wgmma is in flight

  // The run of a group into accf, with its scale row from the stage's slot:
  // accf = fma(f32(acc), s[n], accf).
  auto fold = [&](const float* row) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 sv = *reinterpret_cast<const float2*>(row + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        accf[4 * j + e] =
            __fmaf_rn(__int2float_rn(acc[4 * j + e]), (e & 1) ? sv.y : sv.x, accf[4 * j + e]);
    }
  };
  // Once the committed wgmma through step ks have landed (and, at the
  // stage's first fold, its scale rows), the fold of the group step ks ended.
  uint32_t scaled_phase = 0;  // bit s: the parity of stage s's next scale rows
  auto fold_after = [&](int s, const unsigned char* st, int ks, bool first) {
    if (first) {
      mbar_wait(scaled + s, (scaled_phase >> s) & 1);
      scaled_phase ^= 1u << s;
    }
    wg_wait<0>();
    fence_regs(acc);
    fold(reinterpret_cast<const float*>(st + T::TMA_BYTES) + ks * BN);
    wg_fence();
  };

  const uint32_t base = smem_u32(smem);
  // whole: the group is a multiple of 128, so only a stage's last k32 step
  // can end one, and the stage's four wgmma issue back to back before the
  // fold; otherwise a group may end after any k32 step.  Whether a step
  // ends one is broadcast from lane 0: ptxas then sees a warp-uniform branch
  // (a divergent one around the fold serializes every wgmma of the kernel).
  auto mainloop = [&](auto whole) {
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + s, (kt / STAGES) & 1);
      const unsigned char* st = smem + s * T::STAGE_BYTES;
      const uint32_t a = base + s * T::STAGE_BYTES + wg * 64 * BK;
      const uint32_t b = base + s * T::STAGE_BYTES + T::A_BYTES;
      const int k0 = kt * BK;
      wg_fence();
      if constexpr (!kGrouped) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma<BN>(acc, kdesc(a, ks), kdesc(b, ks), kt > 0 || ks > 0);
      } else if constexpr (decltype(whole)::value) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma<BN>(acc, kdesc(a, ks), kdesc(b, ks), ks > 0 || k0 % p.group != 0);
        if (__shfl_sync(0xffffffffu, ends_group(k0 + BK - 32), 0)) {
          wg_commit();
          fold_after(s, st, KS - 1, true);
        }
      } else {
        bool first = true;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int kg = k0 + ks * 32;
          mma<BN>(acc, kdesc(a, ks), kdesc(b, ks), kg % p.group != 0);
          if (__shfl_sync(0xffffffffu, ends_group(kg), 0)) {
            wg_commit();
            fold_after(s, st, ks, first);
            first = false;
          }
        }
      }
      wg_commit();
      wg_wait<1>();  // the previous stage's wgmma have completed; this one's runs on
      if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % STAGES);
    }
  };
  if constexpr (kGrouped) {
    if (p.group % BK == 0) mainloop(std::true_type{});
    else mainloop(std::false_type{});
  } else {
    mainloop(std::false_type{});
  }
  wg_wait<0>();
  fence_regs(acc);

  OutT* out = static_cast<OutT*>(p.out);
  const int r0 = m0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  const float dq0 = r0 < p.M ? __ldg(p.dequant + r0) : 0.f;
  const float dq1 = r1 < p.M ? __ldg(p.dequant + r1) : 0.f;
  const bool paired = (p.N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
    if (n >= p.N) continue;
    float v[4];
    if constexpr (kGrouped) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(accf[4 * j + e], e < 2 ? dq0 : dq1);
    } else {
      const float s0 = __ldg(p.scale + n);
      const float s1 = n + 1 < p.N ? __ldg(p.scale + n + 1) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]), (e & 1) ? s1 : s0),
                         e < 2 ? dq0 : dq1);
    }
    if (r0 < p.M) store_pair<OutT>(out + (long long)r0 * p.N + n, v[0], v[1], n + 1 < p.N, paired);
    if (r1 < p.M) store_pair<OutT>(out + (long long)r1 * p.N + n, v[2], v[3], n + 1 < p.N, paired);
  }
}

typedef void (*KernelFn)(CUtensorMap, CUtensorMap, Args);

template <typename OutT, bool kGrouped>
int launch(const void* x, const void* w, const Args& a, cudaStream_t stream) {
  using T = Tile<kGrouped>;
  CUtensorMap mx, mw;
  int e = encode_rows_u8(&mx, x, a.M, a.K, BK, BM);
  if (e == 0) e = encode_rows_u8(&mw, w, a.N, a.K, BK, T::BN);
  if (e != 0) return e;
  const KernelFn kernel = w8a8_kernel<OutT, kGrouped>;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(T::smem_bytes));
  if (ce != cudaSuccess) return ce;
  const dim3 grid((a.M + BM - 1) / BM, (a.N + T::BN - 1) / T::BN);
  kernel<<<grid, kThreads, T::smem_bytes, stream>>>(mx, mw, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* drt_w8a8_error_string(int code) {
  if (code == kBadShape)
    return "unsupported shape (K % 16 == 0, group % 32 == 0 dividing K, M and N >= 1, "
           "grid columns ceil(N / 256) <= 65535)";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out_fp32 = 0: bf16 output; 1: fp32 output.  group = 0: per-channel scales.
int drt_w8a8_matmul(const void* x, const void* w, const void* scale, const void* dequant,
                    void* out, int M, int N, int K, int group, int out_fp32, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (N + 127) / 128 > 65535 ||
      (group && (group % 32 || K % group)))
    return kBadShape;
  const Args a{static_cast<const float*>(scale), static_cast<const float*>(dequant), out, M, N, K,
               group};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_fp32) return group ? launch<float, true>(x, w, a, st) : launch<float, false>(x, w, a, st);
  return group ? launch<__nv_bfloat16, true>(x, w, a, st)
               : launch<__nv_bfloat16, false>(x, w, a, st);
}

// The bf16-output kernel, grouped (1) or per channel (0): out = {registers,
// local (spill) bytes, dynamic shared bytes, resident blocks per SM, threads
// per block}.
int drt_w8a8_occupancy(int grouped, int* out) {
  const void* f = grouped ? reinterpret_cast<const void*>(w8a8_kernel<__nv_bfloat16, true>)
                          : reinterpret_cast<const void*>(w8a8_kernel<__nv_bfloat16, false>);
  const size_t smem = grouped ? Tile<true>::smem_bytes : Tile<false>::smem_bytes;
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
  return 0;
}

}  // extern "C"
