// The headroom kernel for Hopper (sm_90a): the statistics of the headroom
// rule, at every head dim (64, 128, 256, 512).
//
// Replaces, of diffusionrenderer_tpu/ops/flash_attention.py, the headroom
// rule's statistics (_bounded_cond_call :488-491, left to XLA in JAX): per
// (b, h) max ||q'_i|| and max ||k_j||, and max |v|, which every block of the
// launch holding kernels 1 and 2 (flash_attention_wgmma.cu) turns into the
// branch (headroom_rule.cuh).  q' is q pre-scaled as the JAX wrapper does
// it, bf16(q * bf16(scale * log2 e)).  The attention kernels (1, 2, 3, 6
// and 7 at every head dim) are in flash_attention_wgmma.cu, kernel 5 in
// flash_attention_int8.cu.
//
// What bounds it on an H100: (Lq + 2 Lk) * H * D * 2 bytes, each read once,
// against a few fp32 operations per element.  One 128-thread block per
// (b, h) and chunk of rows, one warp per row; q, k and v contiguous
// (B, L, H, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "headroom_rule.cuh"

namespace {

using rule::nan_max;
using rule::warp_max;

constexpr int kThreads = 128;
constexpr int kUnsupportedHeadDim = 10000;

struct HeadArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* stats;
  int B, Lq, Lk, H, rows_per_block;
  float q_scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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

}  // namespace

extern "C" {

const char* drt_error_string(int code) {
  if (code == kUnsupportedHeadDim)
    return "unsupported head dim for the headroom kernel (64, 128, 256 or 512)";
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

}  // extern "C"
