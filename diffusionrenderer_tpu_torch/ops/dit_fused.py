"""The DiT block's normalisation chains, fused: the CUDA kernels' wrappers,
their plain versions and the rule that routes a call to one or the other.

The kernels are in `csrc/dit_fused.cu` (they replace no TPU kernel: XLA
fuses these chains in the JAX package).  This module holds

* `residual_ln_modulate(x, pending, shift, scale)` -> (x', xm): x plus each
  pending gated residual (o, gate) in turn, then
  modulate(layer_norm_no_affine(x'), shift, scale); without shift and scale
  xm is None (a gated residual alone).  o is (B, L, D) or a (B, 1, D) row
  broadcast over L; gate, shift and scale are (B, D);
* `qk_rmsnorm_rope_kernel(q, k, wq, wk, cos, sin)` -> (q', k'):
  apply_rope(rms_norm(., w), cos, sin) of q and k, (B, L, H, Dh), in one
  launch, where `takes_qk_kernel` says so (models/dit.py runs the plain ops
  op by op otherwise, q's chain before k's);
* for each, `*_plain` (ops/norms.py and ops/rope.py, op by op: the CPU and
  autograd path, and the kernels' oracle) and `*_kernel` (the launch
  wrapper, counted in `LAUNCHES`).

The kernels are taken only where they compute the same function at the
same precision and nothing needs their gradient (`takes_residual_kernel`,
`takes_qk_kernel`): CUDA bf16 tensors, no input recorded by autograd,
D % 8 == 0 and D <= MAX_D (kernel 1), head dim 128 (kernel 2).  Everything
else (the CPU, the train step, fp32) takes the plain chain.  The kernels round to bf16 where the plain chain rounds, so
the two differ only by the order of the fp32 sums.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from .norms import layer_norm_no_affine, modulate, rms_norm
from .rope import apply_rope

# Launches of each kernel since the last reset_counts(), counted by its wrapper.
LAUNCHES: Dict[str, int] = {"residual_ln_modulate": 0, "qk_rmsnorm_rope": 0}
MAX_D = 8192  # residual_ln_modulate holds a row in its 256 threads' registers
QK_HEAD_DIM = 128  # qk_rmsnorm_rope: one warp, 4 elements a lane
EPS = 1e-6  # ops/norms.py's default, which the DiT uses
KERNEL_DEVICE = "cuda"  # the device type whose tensors the kernels take

Pending = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def takes_kernel(x: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """Whether a chain on activation x (and the other inputs) runs fused:
    x a CUDA bf16 tensor and no input recorded by autograd."""
    if x.device.type != KERNEL_DEVICE or x.dtype != torch.bfloat16:
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(t is not None and t.requires_grad for t in (x, *others))


def takes_qk_kernel(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor
                    ) -> bool:
    """Whether kernel 2 takes q and k with these norm weights: takes_kernel,
    head dim 128, q and k of one shape, the weights both bf16 or both fp32."""
    return (q.shape[-1] == QK_HEAD_DIM and q.shape == k.shape and wq.dtype == wk.dtype
            and wq.dtype in (torch.bfloat16, torch.float32) and takes_kernel(q, k, wq, wk))


def takes_residual_kernel(x: torch.Tensor, pending: Pending, *others: Optional[torch.Tensor]
                          ) -> bool:
    """Whether kernel 1 takes x with these pending residuals (and the other
    inputs): takes_kernel, D % 8 == 0, D <= MAX_D, at most two residuals."""
    d = x.shape[-1]
    return (d % 8 == 0 and d <= MAX_D and len(pending) <= 2
            and takes_kernel(x, *others, *(t for p in pending for t in p)))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def residual_ln_modulate_plain(x: torch.Tensor, pending: Pending,
                               shift: Optional[torch.Tensor], scale: Optional[torch.Tensor]
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    for o, gate in pending:
        x = x + gate[:, None, :] * o
    return x, None if shift is None else modulate(layer_norm_no_affine(x), shift, scale)


def qk_rmsnorm_rope_plain(q, k, wq, wk, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
    return apply_rope(rms_norm(q, wq), cos, sin), apply_rope(rms_norm(k, wk), cos, sin)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import library

        lib = library("dit_fused")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.drt_residual_ln_modulate.argtypes = ([ptr] * 5 + [i32] + [ptr] * 2 + [i32]
                                                 + [ptr] * 2 + [i32] * 4 + [f32, ptr])
        lib.drt_residual_ln_modulate.restype = i32
        lib.drt_qk_rmsnorm_rope.argtypes = [ptr] * 6 + [i32] + [ptr] * 2 + [i32] * 4 + [f32, ptr]
        lib.drt_qk_rmsnorm_rope.restype = i32
        lib.drt_fused_error_string.argtypes = [i32]
        lib.drt_fused_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(name: str, t: torch.Tensor, device, dtype, shape, align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}: the kernel runs on one CUDA device ({device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel takes {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _launched(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().drt_fused_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} (code {err})")
    LAUNCHES[what] += 1


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def residual_ln_modulate_kernel(x: torch.Tensor, pending: Pending,
                                shift: Optional[torch.Tensor], scale: Optional[torch.Tensor]
                                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch kernel 1 on the plain version's arguments (at most two
    pending residuals; x itself comes back as x' when there are none)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    if d % 8 or d > MAX_D or len(pending) > 2 or (not pending and shift is None):
        raise ValueError(f"residual_ln_modulate takes D % 8 == 0, D <= {MAX_D}, at most two "
                         f"residuals and something to do (D = {d}, {len(pending)} residuals)")
    _check("x", x, x.device, torch.bfloat16, (b, l, d))
    res = []
    for i, (o, gate) in enumerate(pending):
        o_rows = 1 if o.dim() == 3 and o.shape[1] == 1 else l
        _check(f"o{i}", o, x.device, torch.bfloat16, (b, o_rows, d))
        _check(f"gate{i}", gate, x.device, torch.bfloat16, (b, d))
        res += [o.data_ptr(), gate.data_ptr(), o_rows]
    res += [None, None, 0] * (2 - len(pending))
    if shift is not None:
        _check("shift", shift, x.device, torch.bfloat16, (b, d))
        _check("scale", scale, x.device, torch.bfloat16, (b, d))
    x_out = torch.empty_like(x) if pending else x
    xm = None if shift is None else torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().drt_residual_ln_modulate(
            x.data_ptr(), x_out.data_ptr() if pending else None,
            None if xm is None else xm.data_ptr(), *res,
            None if shift is None else shift.data_ptr(),
            None if scale is None else scale.data_ptr(),
            b, l, d, len(pending), EPS, _stream(x.device))
    _launched(err, "residual_ln_modulate")
    return x_out, xm


def qk_rmsnorm_rope_kernel(q, k, wq, wk, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 2 on the plain version's arguments: q and k (B, L, H,
    128) bf16, the norm weights (128,) bf16 or fp32 (one dtype), cos and sin
    (L, 128) fp32."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, L, H, Dh), got {tuple(q.shape)}")
    b, l, h, dh = q.shape
    if dh != QK_HEAD_DIM:
        raise ValueError(f"qk_rmsnorm_rope takes head dim {QK_HEAD_DIM}, got {dh}")
    _check("q", q, q.device, torch.bfloat16, (b, l, h, dh))
    _check("k", k, q.device, torch.bfloat16, (b, l, h, dh))
    if wq.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the norm weights are bfloat16 or float32, not {wq.dtype}")
    _check("wq", wq, q.device, wq.dtype, (dh,), align=wq.element_size())  # read by element
    _check("wk", wk, q.device, wq.dtype, (dh,), align=wq.element_size())
    _check("cos", cos, q.device, torch.float32, (l, dh))
    _check("sin", sin, q.device, torch.float32, (l, dh))
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    with torch.cuda.device(q.device):
        err = _lib().drt_qk_rmsnorm_rope(
            q.data_ptr(), k.data_ptr(), q_out.data_ptr(), k_out.data_ptr(), wq.data_ptr(),
            wk.data_ptr(), int(wq.dtype == torch.float32), cos.data_ptr(), sin.data_ptr(),
            b, l, h, dh, EPS, _stream(q.device))
    _launched(err, "qk_rmsnorm_rope")
    return q_out, k_out


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def residual_ln_modulate(x: torch.Tensor, pending: Pending = (),
                         shift: Optional[torch.Tensor] = None,
                         scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x', xm) of the chain above: kernel 1 where it applies, else plain."""
    pending = list(pending)
    if (pending or shift is not None) and takes_residual_kernel(x, pending, shift, scale):
        return residual_ln_modulate_kernel(
            x.contiguous(), [(o.contiguous(), g.contiguous()) for o, g in pending],
            None if shift is None else shift.contiguous(),
            None if scale is None else scale.contiguous())
    return residual_ln_modulate_plain(x, pending, shift, scale)


