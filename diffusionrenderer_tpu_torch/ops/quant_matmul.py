"""W8A8 matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of diffusionrenderer_tpu/ops/quant_matmul.py.  The kernel is in
`csrc/quant_matmul.cu`; this module holds

* `quant_matmul_w8a8(x, wq, scale)` - the entry point: activation quantize
  pre-pass, then the kernel for CUDA tensors or the plain version for CPU
  tensors (it launches or raises, it never falls back);
* `quantize_activation_fp32` - the pre-pass of quant_matmul.py:166-171:
  per-row amax in fp32, inv = 127 / max(amax, 1e-12) rounded to x's dtype,
  xq = clip(round(f32(x) * f32(inv)), +-127) as int8, and the dequant
  1 / f32(inv), the exact inverse of the scale applied.  Plain torch ops, as
  JAX left it to XLA; it runs once per matmul;
* `quant_matmul_w8a8_kernel` - the launch wrapper, counted in `LAUNCHES`;
* `quant_matmul_w8a8_plain` - the plain version of the kernel's function.

The weight is PyTorch's (out, in) = (N, K) int8 layout (JAX keeps (K, N));
scales are (N,) per channel or (G, N) per group of K / G input rows.

The plain version accumulates exactly: with same-signed codes near +-127
an int8 dot product over K = 4,096 reaches ~6.6e7, past 2^24, where an fp32
sum of the products is no longer exact.  It multiplies in float64 (exact
below 2^53; CUDA has no int64 matmul), converts each group's integer sum to
fp32 and folds the groups in fp32 in group order, with the kernel's order
of fp32 operations.  The fold is a fused multiply-add (`fma_f32`), as XLA
compiles the JAX kernel's `acc += part * s` and as the CUDA kernel does it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

# Launches of each kernel since the last reset_counts(), counted by its wrapper.
LAUNCHES: Dict[str, int] = {"quant_matmul_w8a8": 0}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def activation_inv_scale(amax: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """127 / max(amax, 1e-12) rounded to dtype.  A true division: torch's
    `scalar / tensor` is the tensor's reciprocal times the scalar, which
    rounds twice."""
    return torch.div(torch.full_like(amax, 127.0), amax.clamp_min(1e-12)).to(dtype)


def quantize_activation_fp32(x2: torch.Tensor, amax: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) activations -> (xq int8 (M, K), dequant fp32 (M,)).  The
    quantize multiply runs in fp32 (the kernel path's pre-pass).  amax, when
    given, is each row's max |x| as fp32 (M, 1), taken over more than these
    K columns (a row-parallel layer's whole K)."""
    if amax is None:
        amax = x2.abs().amax(dim=-1, keepdim=True).float()  # the max of x's values is exact
    inv = activation_inv_scale(amax, x2.dtype).float()
    # x * inv promotes to fp32 (an exact upcast of x), with no fp32 copy of x.
    xq = torch.mul(x2, inv).round_().clamp_(-127, 127).to(torch.int8)
    return xq, (1.0 / inv).reshape(-1)


def group_size_of(k: int, scale: torch.Tensor) -> Optional[int]:
    """Input rows per scale group, or None for per-channel scales."""
    if scale.dim() == 1:
        return None
    g = scale.shape[0]
    if k % g:
        raise ValueError(f"{g} scale groups do not divide K = {k}")
    return k // g


def int_matmul_exact(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """sum_k xq[m, k] * wq[n, k] of int8 codes, exact, as fp32 (the value an
    int32 accumulator converts to): float64 products and sums are exact far
    beyond any int8 dot product's range."""
    return (xq.double() @ wq.double().T).float()


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of fp32 tensors with one rounding, as a fused multiply-add:
    the float64 product of two fp32 values is exact, and the float64 sum
    rounds to fp32 as the fused operation does (barring a double rounding
    at an exact fp32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def quant_matmul_w8a8_plain(xq: torch.Tensor, dequant: torch.Tensor, wq: torch.Tensor,
                            scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function: xq (M, K) int8, dequant (M,) fp32, wq (N, K)
    int8, scale (N,) or (G, N) fp32 -> (M, N) in out_dtype."""
    gsz = group_size_of(xq.shape[-1], scale)
    if gsz is None:
        total = int_matmul_exact(xq, wq) * scale
    else:
        total = torch.zeros(xq.shape[0], wq.shape[0], dtype=torch.float32, device=xq.device)
        for g in range(scale.shape[0]):
            part = int_matmul_exact(xq[:, g * gsz:(g + 1) * gsz], wq[:, g * gsz:(g + 1) * gsz])
            total = fma_f32(part, scale[g], total)
    return (total * dequant[:, None]).to(out_dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import library

        lib = library("quant_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.drt_w8a8_matmul.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.drt_w8a8_matmul.restype = i32
        lib.drt_w8a8_error_string.argtypes = [i32]
        lib.drt_w8a8_error_string.restype = ctypes.c_char_p
        lib.drt_w8a8_occupancy.argtypes = [i32, ctypes.POINTER(i32)]
        lib.drt_w8a8_occupancy.restype = i32
        _lib_handle = lib
    return _lib_handle


def check_kernel_shape(m: int, n: int, k: int, gsz: Optional[int]) -> None:
    """Raise ValueError for a shape the kernel does not take."""
    if m < 1 or n < 1 or k < 16 or k % 16:
        raise ValueError(f"W8A8 kernel needs M, N >= 1 and K a multiple of 16, got "
                         f"M={m} N={n} K={k}")
    if gsz is not None and gsz % 32:
        raise ValueError(f"W8A8 kernel needs a group size that is a multiple of 32, "
                         f"got {gsz} (K={k})")


def quant_matmul_w8a8_kernel(xq: torch.Tensor, dequant: torch.Tensor, wq: torch.Tensor,
                             scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the kernel on the plain version's arguments."""
    m, k = xq.shape
    n = wq.shape[0]
    gsz = group_size_of(k, scale)
    check_kernel_shape(m, n, k, gsz)
    for name, t, dt in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                        ("scale", scale, torch.float32), ("dequant", dequant, torch.float32)):
        if t.device.type != "cuda" or t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}: the kernel runs on one CUDA device")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dt}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if wq.shape[1] != k or scale.shape[-1] != n or dequant.shape != (m,):
        raise ValueError(f"mismatched shapes xq{tuple(xq.shape)} wq{tuple(wq.shape)} "
                         f"scale{tuple(scale.shape)} dequant{tuple(dequant.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel writes bfloat16 or float32, not {out_dtype}")
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _lib().drt_w8a8_matmul(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), dequant.data_ptr(), out.data_ptr(),
            m, n, k, gsz or 0, int(out_dtype == torch.float32),
            ctypes.c_void_p(torch.cuda.current_stream(xq.device).cuda_stream))
    if err != 0:
        msg = _lib().drt_w8a8_error_string(err).decode()
        raise RuntimeError(f"quant_matmul_w8a8 failed to launch: {msg} (code {err})")
    LAUNCHES["quant_matmul_w8a8"] += 1
    return out


def kernel_occupancy(grouped: bool) -> Dict[str, int]:
    """What the CUDA runtime reports for the bf16-output kernel, per channel
    or grouped: registers a thread, local (spill) bytes, dynamic shared
    bytes, resident blocks per SM and threads per block."""
    out = (ctypes.c_int * 5)()
    err = _lib().drt_w8a8_occupancy(int(grouped), out)
    if err != 0:
        msg = _lib().drt_w8a8_error_string(err).decode()
        raise RuntimeError(f"occupancy of quant_matmul_w8a8: {msg} (code {err})")
    return dict(zip(("registers", "spill_bytes", "dynamic_smem_bytes", "blocks_per_sm",
                     "threads_per_block"), out))


def quant_matmul_w8a8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      amax: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-token int8 activations x int8 weights.

    x: (..., K) activations; wq: (N, K) int8; scale: (N,) per-channel or
    (G, N) per-group fp32; amax: the tokens' max |x| (..., 1) fp32 when it is
    taken over more than this K (a row-parallel shard), else computed here.
    Returns (..., N) in out_dtype (x's dtype unless given)."""
    *lead, k = x.shape
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, k)
    xq, dequant = (quantize_activation_fp32(x2) if amax is None
                   else quantize_activation_fp32(x2, amax.reshape(-1, 1)))
    if x.device.type == "cpu":
        out = quant_matmul_w8a8_plain(xq, dequant, wq, scale, out_dtype)
    else:
        out = quant_matmul_w8a8_kernel(xq, dequant, wq, scale.contiguous(), out_dtype)
    return out.reshape(*lead, wq.shape[0])
