// W8A8 matmul for Hopper (sm_90a): int8 x int8 -> int32 on the tensor cores,
// per-channel or per-group fp32 weight scales, per-token dequant, bf16/fp32 out.
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
// bit.  |xq|, |w| <= 127, so an int32 run over K <= 16384
// cannot overflow.
//
// What bounds it on an H100: 2*M*N*K int8 operations at 1,979 TOP/s against
// (M*K + N*K + 2*M*N) bytes at 3.35 TB/s; at the DiT's M = 5,120 rows and
// K, N in {4096, 16384} it is operation bound (0.087-0.347 ms).  This first
// version keeps the design simple:
//   * one 256-thread block per 128 x 128 output tile, a loop over K in
//     128-byte steps; 8 warps as 2 (rows) x 4 (columns), 64 x 32 per warp;
//   * A = xq (M, K) row-major and B = w (N, K): the weight is kept in
//     PyTorch's (out, in) layout, which is exactly the K-contiguous "col"
//     operand of mma.sync.m16n8k32.row.col.s32.s8.s8.s32, so both operands
//     come out of shared memory with plain (non-transposed) ldmatrix;
//   * a 3-stage cp.async ring of 16-byte copies; rows past M or N and the
//     K tail past a multiple of 16 are zero-filled (no padded copies), and
//     stores are predicated;
//   * in grouped mode an fp32 accumulator sits beside the int32 one and the
//     int32 run is folded into it after each k32 step that ends a group
//     (group sizes are multiples of 32, so a group holds whole k32 steps).
// wgmma, TMA and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 128;  // BK in bytes (= int8 elements)
constexpr int STAGES = 3;
constexpr int PITCH = BK + 16;  // +16 B: ldmatrix rows land in distinct bank groups
constexpr int kStageBytes = (BM + BN) * PITCH;
constexpr int kSmemBytes = STAGES * kStageBytes;
constexpr int WM = 64, WN = 32;          // warp tile
constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 tiles per warp

constexpr int kBadShape = 10001;

struct Args {
  const int8_t* x;        // (M, K)
  const int8_t* w;        // (N, K)
  const float* scale;     // (N,) or (G, N)
  const float* dequant;   // (M,)
  void* out;              // (M, N), bf16 or fp32
  int M, N, K, group;     // group = 0: per-channel
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// Fragment layouts (mma.m16n8k32, s8): thread (g, t4) = (lane / 4, lane % 4)
// holds A rows g and g+8, bytes 4*t4..+3 and 16+4*t4..+3 of the k32 step;
// B column (weight row) g, the same bytes; C rows g and g+8, columns 2*t4, 2*t4+1.
template <typename OutT, bool kGrouped>
__global__ void __launch_bounds__(kThreads) w8a8_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (p.K + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    unsigned char* As = smem + stage * kStageBytes;
    unsigned char* Bs = As + BM * PITCH;
    const int k0 = kt * BK;
    constexpr int CPR = BK / 16;  // 16-byte chunks per row
#pragma unroll
    for (int c = tid; c < BM * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 16;
      const bool kin = k0 + col < p.K;
      const bool okA = kin && m0 + r < p.M;
      const bool okB = kin && n0 + r < p.N;
      const int8_t* srcA = p.x + (okA ? (long long)(m0 + r) * p.K + k0 + col : 0);
      const int8_t* srcB = p.w + (okB ? (long long)(n0 + r) * p.K + k0 + col : 0);
      cp_async_16(smem_u32(As + r * PITCH + col), srcA, okA);
      cp_async_16(smem_u32(Bs + r * PITCH + col), srcB, okB);
    }
  };

  int acc[MT][NT][4];
  float accf[kGrouped ? MT : 1][kGrouped ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if constexpr (kGrouped) accf[i][j][e] = 0.f;
      }

  // Columns this thread owns (for the scale reads): n0 + wn*WN + j*8 + 2*t4 + {0, 1}.
  const int ncol = n0 + wn * WN + 2 * t4;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }

  // ldmatrix row addresses (lane -> row of its 8x8 matrix).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_tile((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const unsigned char* As = smem + (kt % STAGES) * kStageBytes;
    const unsigned char* Bs = As + BM * PITCH;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kglob = kt * BK + ks * 32;
      if (kglob >= p.K) break;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], smem_u32(As + (wm * WM + i * 16 + a_row) * PITCH + ks * 32 + a_col));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(Bs + (wn * WN + j * 8 + b_row) * PITCH + ks * 32 + b_col));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);

      if constexpr (kGrouped) {
        if ((kglob + 32) % p.group == 0) {  // this k32 step ends group kglob / group
          const float* srow = p.scale + (long long)(kglob / p.group) * p.N;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = ncol + j * 8;
            const float s0 = n < p.N ? __ldg(srow + n) : 0.f;
            const float s1 = n + 1 < p.N ? __ldg(srow + n + 1) : 0.f;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float s = (e & 1) ? s1 : s0;
                accf[i][j][e] = __fmaf_rn(__int2float_rn(acc[i][j][e]), s, accf[i][j][e]);
                acc[i][j][e] = 0;
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  OutT* out = static_cast<OutT*>(p.out);
  const bool paired = (p.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + h * 8;
      if (m >= p.M) continue;
      const float dq = __ldg(p.dequant + m);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = ncol + j * 8;
        if (n >= p.N) continue;
        float v0, v1;
        if constexpr (kGrouped) {
          v0 = __fmul_rn(accf[i][j][2 * h], dq);
          v1 = __fmul_rn(accf[i][j][2 * h + 1], dq);
        } else {
          const float s0 = __ldg(p.scale + n);
          const float s1 = n + 1 < p.N ? __ldg(p.scale + n + 1) : 0.f;
          v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), s0), dq);
          v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s1), dq);
        }
        store_pair<OutT>(out + (long long)m * p.N + n, v0, v1, n + 1 < p.N, paired);
      }
    }
  }
}

template <typename OutT, bool kGrouped> int launch(const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(w8a8_kernel<OutT, kGrouped>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  w8a8_kernel<OutT, kGrouped><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* drt_w8a8_error_string(int code) {
  if (code == kBadShape)
    return "unsupported shape (K % 16 == 0, group % 32 == 0 dividing K, M and N >= 1, "
           "grid rows <= 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out_fp32 = 0: bf16 output; 1: fp32 output.  group = 0: per-channel scales.
int drt_w8a8_matmul(const void* x, const void* w, const void* scale, const void* dequant,
                    void* out, int M, int N, int K, int group, int out_fp32, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (M + BM - 1) / BM > 65535 ||
      (group && (group % 32 || K % group)))
    return kBadShape;
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(scale), static_cast<const float*>(dequant),
               out, M, N, K, group};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_fp32) return group ? launch<float, true>(a, st) : launch<float, false>(a, st);
  return group ? launch<__nv_bfloat16, true>(a, st) : launch<__nv_bfloat16, false>(a, st);
}

}  // extern "C"
