// The DiT block's normalisation chains for Hopper (sm_90a), each one pass
// over its activations.
//
// Replaces no TPU kernel: in the JAX package XLA fuses these chains
// (diffusionrenderer_tpu/models/dit.py's LayerNorm, modulate, gated residual,
// q/k RMSNorm and RoPE).  In the port's plain PyTorch each op is a kernel of
// its own with fp32 intermediates in device memory (ops/norms.py,
// ops/rope.py), about twenty passes over each (B, L, D) activation a block.
// The plain chains stay in ops/dit_fused.py as the CPU and autograd path and
// as these kernels' oracle.
//
//   residual_ln_modulate, one 256-thread block per token row of D:
//     x' = x;  for each pending (o, gate):  x' = bf16(x' + bf16(gate * o))
//     xm = bf16(bf16(LN(x') * bf16(1 + scale)) + shift)
//   with LN(x') = bf16((x' - mean) * rsqrt(var + eps)), mean and the centred
//   var in fp32 (two passes over the row held in registers).  o is (B, L, D)
//   or a (B, 1, D) row broadcast over L (the one-token cross-attention).
//   Without shift and scale it writes x' alone (a gated residual).
//
//   qk_rmsnorm_rope, one block per token, one warp per (head) row of 128, q
//   and k in one launch:  y = bf16(x * rsqrt(mean(x^2) + eps) * w)   (fp32 inside)
//            out = bf16(bf16(y * bf16(cos)) + bf16(rot(y) * bf16(sin)))
//   with rot the rotate-half (-y[64:], y[:64]): lane l holds elements
//   4l..4l+3, so its partner half sits in lane l ^ 16, one shuffle.
//
// Each rounds to bf16 where the plain chain rounds, so the two differ only
// by the fp32 sums' order (at most one bf16 ulp on a few elements).
//
// What bounds them on an H100: bytes.  A few fp32 operations per element
// against 2 bytes read or written, far below the ~295 operations per byte
// where the tensor cores would bound them.  Each activation is read once
// and each output written once (16-byte loads and stores in
// residual_ln_modulate, 8-byte in qk_rmsnorm_rope); the (B, D) modulation
// rows, the norm weights and the (L, 128) cos / sin tables are small and
// stay in L1 and L2 (each token's cos / sin row read once, for all of its
// 2H rows).  Nothing is allocated or synchronised here: the
// wrappers allocate, launch on the caller's stream (so a CUDA graph
// captures them) and check the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowThreads = 256;
constexpr int kMaxVecPerThread = 4;  // D <= 256 * 4 * 8 = 8192
constexpr int kHeadDim = 128;
constexpr int kQkWarps = 8;  // qk_rmsnorm_rope's block
constexpr int kQkBatch = 4;  // rows a warp loads before it computes
constexpr int kBadShape = 10000;

__device__ __forceinline__ float rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's sum of x, on every thread.  `part` holds one float a warp.
__device__ __forceinline__ float block_sum(float x, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = warp_sum(x);
  if (lane == 0) part[warp] = x;
  __syncthreads();
  x = lane < kRowThreads / 32 ? part[lane] : 0.f;
  return warp_sum(x);
}

struct LnArgs {
  const bf16* x;
  bf16* x_out;        // x' (written when nres > 0)
  bf16* xm;           // modulate(LN(x')) (written when shift is set)
  const bf16* o[2];   // pending residuals, (B, o_rows, D)
  const bf16* gate[2];  // (B, D)
  int o_rows[2];      // L, or 1 for a row broadcast over L
  const bf16* shift;  // (B, D), or null: x' alone
  const bf16* scale;  // (B, D)
  int L, D, nres;
  float eps;
};

template <int VPT>
__global__ void __launch_bounds__(kRowThreads) residual_ln_modulate_kernel(LnArgs p) {
  __shared__ float part[2][kRowThreads / 32];
  const int row = blockIdx.x, b = row / p.L, l = row - b * p.L;
  const int nvec = p.D >> 3;
  const long long base = (long long)row * p.D;
  float v[VPT][8];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) load8(p.x + base + c * 8, v[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // unrolled: the argument arrays take constant indices
    if (r >= p.nres) break;
    const long long obase = ((long long)b * p.o_rows[r] + (p.o_rows[r] == 1 ? 0 : l)) * p.D;
    const bf16* gate = p.gate[r] + (long long)b * p.D;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      if (c < nvec) {
        float o[8], g[8];
        load8(p.o[r] + obase + c * 8, o);
        load8(gate + c * 8, g);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = rn(v[i][e] + rn(g[e] * o[e]));
      }
    }
  }
  if (p.nres > 0) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      if (c < nvec) store8(p.x_out + base + c * 8, v[i]);
    }
  }
  if (p.shift == nullptr) return;

  const float inv_d = 1.f / p.D;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (threadIdx.x + i * kRowThreads < nvec) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
  const float mean = block_sum(s, part[0]) * inv_d;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (threadIdx.x + i * kRowThreads < nvec) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        ss += d * d;
      }
    }
  const float rstd = rsqrtf(block_sum(ss, part[1]) * inv_d + p.eps);
  const bf16* shift = p.shift + (long long)b * p.D;
  const bf16* scale = p.scale + (long long)b * p.D;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < nvec) {
      float sh[8], sc[8], out[8];
      load8(shift + c * 8, sh);
      load8(scale + c * 8, sc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = rn((v[i][e] - mean) * rstd);
        out[e] = rn(rn(y * rn(1.f + sc[e])) + sh[e]);
      }
      store8(p.xm + base + c * 8, out);
    }
  }
}

struct QkArgs {
  const bf16* in[2];   // q, k: (B, L, H, 128)
  bf16* out[2];
  const void* w[2];    // (128,) bf16, or fp32 when w_fp32
  const float* cos;    // (L, 128)
  const float* sin;
  int L, H, w_fp32;
  float eps;
};

__device__ __forceinline__ float weight(const void* w, int i, int fp32) {
  return fp32 ? static_cast<const float*>(w)[i] : __bfloat162float(static_cast<const bf16*>(w)[i]);
}

// One block per token: its 2H rows (q's heads, then k's) over the warps, each
// warp loading kQkBatch rows before it computes; the token's cos and sin
// (rounded to bf16) and both weights are read once into every lane.
__global__ void __launch_bounds__(kQkWarps * 32) qk_rmsnorm_rope_kernel(QkArgs p) {
  const int token = blockIdx.x, l = token % p.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, col = lane * 4;
  const float4 c4 = *reinterpret_cast<const float4*>(p.cos + (long long)l * kHeadDim + col);
  const float4 s4 = *reinterpret_cast<const float4*>(p.sin + (long long)l * kHeadDim + col);
  const float cs[4] = {rn(c4.x), rn(c4.y), rn(c4.z), rn(c4.w)};
  const float sn[4] = {rn(s4.x), rn(s4.y), rn(s4.z), rn(s4.w)};
  float w[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[0][e] = weight(p.w[0], col + e, p.w_fp32);
    w[1][e] = weight(p.w[1], col + e, p.w_fp32);
  }
  const long long token_off = (long long)token * p.H * kHeadDim + col;
  const int rows = 2 * p.H;
  for (int r0 = warp; r0 < rows; r0 += kQkWarps * kQkBatch) {
    uint2 raw[kQkBatch];
#pragma unroll
    for (int j = 0; j < kQkBatch; ++j) {
      const int r = r0 + j * kQkWarps;  // the same on every lane: whole warps branch
      if (r < rows) {
        const bf16* in = r < p.H ? p.in[0] + r * kHeadDim : p.in[1] + (r - p.H) * kHeadDim;
        raw[j] = *reinterpret_cast<const uint2*>(in + token_off);
      }
    }
#pragma unroll
    for (int j = 0; j < kQkBatch; ++j) {
      const int r = r0 + j * kQkWarps;
      if (r >= rows) break;
      const int t = r >= p.H;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
      const float2 x01 = __bfloat1622float2(h[0]), x23 = __bfloat1622float2(h[1]);
      const float x[4] = {x01.x, x01.y, x23.x, x23.y};
      const float ss = warp_sum(x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3]);
      const float rs = rsqrtf(ss * (1.f / kHeadDim) + p.eps);
      float y[4], out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = rn((x[e] * rs) * (t ? w[1][e] : w[0][e]));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float partner = __shfl_xor_sync(0xffffffffu, y[e], 16);
        const float rot = lane < 16 ? -partner : partner;
        out[e] = rn(rn(y[e] * cs[e]) + rn(rot * sn[e]));
      }
      uint2 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
      oh[0] = __floats2bfloat162_rn(out[0], out[1]);
      oh[1] = __floats2bfloat162_rn(out[2], out[3]);
      bf16* dst = t ? p.out[1] + (r - p.H) * kHeadDim : p.out[0] + r * kHeadDim;
      *reinterpret_cast<uint2*>(dst + token_off) = o;
    }
  }
}

}  // namespace

extern "C" {

const char* drt_fused_error_string(int code) {
  if (code == kBadShape)
    return "unsupported shape (residual_ln_modulate: D % 8 == 0, 8 <= D <= 8192, at most two "
           "residuals; qk_rmsnorm_rope: head dim 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// o_rows[r]: L, or 1 for a (B, 1, D) residual broadcast over L.  shift and
// scale null: x' alone.  nres 0 with no shift is refused (nothing to do).
int drt_residual_ln_modulate(const void* x, void* x_out, void* xm, const void* o0,
                             const void* gate0, int o0_rows, const void* o1, const void* gate1,
                             int o1_rows, const void* shift, const void* scale, int B, int L,
                             int D, int nres, float eps, void* stream) {
  const int nvec = D / 8;
  const int vpt = (nvec + kRowThreads - 1) / kRowThreads;
  if (B < 1 || L < 1 || D < 8 || D % 8 || vpt > kMaxVecPerThread || nres < 0 || nres > 2 ||
      (nres == 0 && shift == nullptr) || (long long)B * L > 0x7fffffffLL)
    return kBadShape;
  LnArgs a{static_cast<const bf16*>(x),
           static_cast<bf16*>(x_out),
           static_cast<bf16*>(xm),
           {static_cast<const bf16*>(o0), static_cast<const bf16*>(o1)},
           {static_cast<const bf16*>(gate0), static_cast<const bf16*>(gate1)},
           {o0_rows, o1_rows},
           static_cast<const bf16*>(shift),
           static_cast<const bf16*>(scale),
           L, D, nres, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(B) * L;
  switch (vpt) {
    case 1: residual_ln_modulate_kernel<1><<<grid, kRowThreads, 0, st>>>(a); break;
    case 2: residual_ln_modulate_kernel<2><<<grid, kRowThreads, 0, st>>>(a); break;
    default: residual_ln_modulate_kernel<4><<<grid, kRowThreads, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

// q, k (B, L, H, 128) bf16; wq, wk (128,) bf16 or fp32 (w_fp32); cos, sin
// (L, 128) fp32.
int drt_qk_rmsnorm_rope(const void* q, const void* k, void* q_out, void* k_out, const void* wq,
                        const void* wk, int w_fp32, const void* cos, const void* sin, int B, int L,
                        int H, int head_dim, float eps, void* stream) {
  if (B < 1 || L < 1 || H < 1 || head_dim != kHeadDim || (long long)B * L > 0x7fffffffLL)
    return kBadShape;
  QkArgs a{{static_cast<const bf16*>(q), static_cast<const bf16*>(k)},
           {static_cast<bf16*>(q_out), static_cast<bf16*>(k_out)},
           {wq, wk},
           static_cast<const float*>(cos),
           static_cast<const float*>(sin),
           L, H, w_fp32, eps};
  qk_rmsnorm_rope_kernel<<<static_cast<unsigned>(B) * L, kQkWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
