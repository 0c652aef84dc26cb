// The headroom rule of _bounded_cond_call (diffusionrenderer_tpu/ops/
// flash_attention.py:488-491), evaluated on the device by every block of
// every bounded bf16 attention launch from the stats buffer that
// headroom_kernel fills: the unshifted exp2(s), its row sum and the PV
// accumulator all stay finite in fp32.  The launch holding kernels 1 and 2
// (csrc/flash_attention.cu at D = 256 and 512, csrc/flash_attention_wgmma.cu
// at D = 64 and 128) runs this code in each block, so all its blocks take
// one branch.
#pragma once

#include <cuda_runtime.h>

namespace rule {

constexpr float kHeadroomLimit = 120.f;

// max that propagates NaN (fmaxf drops it), so a NaN input selects the online
// branch as jnp.max + lax.cond do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 1 when the no-shift branch runs, uniform across the block and the grid.
// stats = [max ||q'|| (n), max ||k|| (n), max |v|], n = B*H.  Every thread
// of a kThreads-thread block must call it; scratch: kThreads / 32 + 1 words
// of shared memory.  A max is exact in any order, so every block size
// reaches the same decision.
template <int kThreads>
__device__ __forceinline__ int block_noshift(const float* stats, int n, float log2_lk_pad,
                                             float* scratch) {
  constexpr int kWarps = kThreads / 32;
  float mb = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) mb = nan_max(mb, stats[i] * stats[n + i]);
  mb = warp_max(mb);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = mb;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) mb = nan_max(mb, scratch[w]);
    const float headroom = mb + log2_lk_pad + log2f(nan_max(stats[2 * n], 1e-30f));
    scratch[kWarps] = headroom < kHeadroomLimit ? 1.f : 0.f;  // 0 for NaN
  }
  __syncthreads();
  return scratch[kWarps] != 0.f;
}

}  // namespace rule
