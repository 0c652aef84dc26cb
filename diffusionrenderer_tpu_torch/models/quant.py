"""int8 quantization of the DiT: weight-only (W8) and weight + activation (W8A8).

Counterpart of diffusionrenderer_tpu/models/quant.py.  Only the per-block
matmuls (fa/ca wq, wk, wv, wo; mlp w1, w2) are quantized; AdaLN, norms,
embedders and the final projection stay in the model's dtype.  A quantized
leaf is a dict, in PyTorch's (out, in) = (N, K) weight layout:

    {'q': int8 (N, K), 's' | 'sa': fp32 (N,) per channel or (G, N) per group
     of K / G input rows[, 'hs': fp32 (K,) Hadamard signs][, 'di': fp32 (K,)
     scale-migration multipliers]}

's' marks weight-only int8, 'sa' W8A8 (runtime per-token int8 activations).
The codes and scales are those of the JAX package, transposed.

Routing of a W8A8 matmul (`dense_maybe_quantized`).  The JAX package's
`_use_fused_kernel` is TPU-specific: it returns False off the TPU, and its
45k-token per-channel band is a v5e memory boundary, not a speed crossover.
The port's rule:

* On CUDA tensors, every W8A8 matmul with at least KERNEL_MIN_ROWS (512)
  token rows launches the hand-written kernel (ops/quant_matmul.py), for
  per-channel and grouped scales alike, any group size it takes (a multiple
  of 32).  That is the six W8A8 block matmuls of every DiT block.  The int8
  tensor cores run at twice the bf16 rate, and the kernel never writes the
  int32 product to device memory.
* Fewer rows (the cross-attention's ca.wv / ca.wo, one row per batch
  element) take the plain path, as JAX does below 512 rows: the kernel's
  128-row tiles would be almost empty.
* A shape the kernel cannot take raises; there is no quiet plain path on
  the card.
* On CPU tensors the function computes what the JAX package's XLA path
  computes on the CPU (`_quantize_activation`, whose quantize multiply runs
  in x's dtype), so the CPU tests compare like with like.

The plain W8A8 path sums int8 products exactly (float64), on the CPU and on
the card: fp32 sums lose exactness above 2^24.

Under tensor parallelism (`dense_maybe_quantized(row_group=)`, the
row-parallel fa.wo, ca.wo and mlp.w2) each token is quantized with its max
|x| over the whole K, a max all-reduce over the tensor group; per channel
the integer sums are added across the group before the scales (the result
is the unsharded one's, bit for bit), per group each rank's fp32 fold is
added; plain and weight-only products are summed in fp32 and rounded once.

Weight-only leaves have no kernel in JAX either (XLA fuses the int8 -> bf16
convert into the matmul read); here they dequantize to x's dtype and call
F.linear, which materializes a copy of the weight in x's dtype per call.

The host half (the convert-time quantizers: MSE clip, Hadamard, AWQ-style
migration, GPTQ, '_mixN') is a faithful copy of the JAX package's torch
code, with the port's (N, K) layout at its boundary.  A '_mixN' tree is a
list of bf16 and quantized block dicts, which dit_forward walks as it is.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant_matmul import (activation_inv_scale, fma_f32, int_matmul_exact,
                                quant_matmul_w8a8, quant_matmul_w8a8_kernel,
                                quantize_activation_fp32)
from ..parallel.collectives import all_reduce_max, all_reduce_sum

Params = Dict[str, Any]

QUANTIZED_BLOCK_WEIGHTS = {
    "fa": ("wq", "wk", "wv", "wo"),
    "ca": ("wq", "wk", "wv", "wo"),
    "mlp": ("w1", "w2"),
}

# Which calibration site (models/calibrate.py) feeds each quantized leaf's
# input.  ca.wq / ca.wk never execute on the single-KV cross-attention path:
# they have no live input site and calibrated quantizers leave them at RTN.
LEAF_SITE = {
    "fa.wq": "fa.qkv", "fa.wk": "fa.qkv", "fa.wv": "fa.qkv",
    "fa.wo": "fa.wo",
    "ca.wv": "ca.wv", "ca.wo": "ca.wo",
    "mlp.w1": "mlp.w1", "mlp.w2": "mlp.w2",
}

# W8A8 matmuls with at least this many token rows launch the kernel on CUDA.
KERNEL_MIN_ROWS = 512


class QuantMode(NamedTuple):
    """Parsed deployment quant mode (see parse_quant_mode)."""

    act_quant: bool
    group_size: Optional[int]
    keep: tuple
    hadamard: bool = False
    mse_clip: bool = False
    awq: bool = False
    gptq: bool = False
    mix_blocks: int = 0

    @property
    def needs_calibration(self) -> bool:
        return self.awq or self.gptq


def parse_quant_mode(mode: str) -> QuantMode:
    """'w8a8_g128_keepres' -> QuantMode(act_quant=True, group_size=128,
    keep=('w2', 'wo')).  Base 'w8' or 'w8a8', then any of '_gN', '_keepres'
    (wo, w2 stay bf16), '_keepattn' (wq, wk, wv, wo stay bf16), '_had',
    '_mse', '_awq', '_gptq', '_mixN' (the grammar of the JAX package)."""
    parts = mode.split("_")
    if parts[0] not in ("w8", "w8a8"):
        raise ValueError(f"unknown quant mode {mode!r} (base must be w8 or w8a8)")
    group_size = None
    keep = set()
    flags = {"hadamard": False, "mse_clip": False, "awq": False, "gptq": False}
    for p in parts[1:]:
        if p.startswith("g") and p[1:].isdigit():
            group_size = int(p[1:])
        elif p == "keepres":
            keep |= {"wo", "w2"}
        elif p == "keepattn":
            keep |= {"wq", "wk", "wv", "wo"}
        elif p == "had":
            flags["hadamard"] = True
        elif p == "mse":
            flags["mse_clip"] = True
        elif p == "awq":
            flags["awq"] = True
        elif p == "gptq":
            flags["gptq"] = True
        elif p.startswith("mix") and p[3:].isdigit():
            flags["mix_blocks"] = int(p[3:])
        else:
            raise ValueError(f"unknown mode suffix {p!r} in {mode}")
    return QuantMode(parts[0] == "w8a8", group_size, tuple(sorted(keep)), **flags)


# ---------------------------------------------------------------------------
# Block-Hadamard rotation (exact orthogonal transform of the input space)
# ---------------------------------------------------------------------------

_HADAMARD_BLOCK = 128


@functools.lru_cache(maxsize=8)
def _hadamard_matrix(n: int) -> np.ndarray:
    """Normalized Sylvester Hadamard H/sqrt(n): symmetric, orthogonal, its
    own inverse."""
    assert n & (n - 1) == 0, f"Hadamard size must be a power of 2, got {n}"
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(np.float32(n))


def hadamard_block(k: int) -> int:
    """Rotation block for a K-row input: 128 when it divides K, else the
    largest power-of-2 divisor up to 128 (1 when K is odd: no rotation)."""
    if k % _HADAMARD_BLOCK == 0:
        return _HADAMARD_BLOCK
    b = 1
    while k % (b * 2) == 0 and b * 2 <= _HADAMARD_BLOCK:
        b *= 2
    return b


def _hadamard_signs(k: int) -> np.ndarray:
    """Deterministic Rademacher signs shared across blocks."""
    rng = np.random.default_rng(0x5EED)
    return (rng.integers(0, 2, k) * 2 - 1).astype(np.float32)


_hadamard_cache: Dict[tuple, torch.Tensor] = {}


def _hadamard_tensor(b: int, dtype: torch.dtype, device) -> torch.Tensor:
    key = (b, dtype, torch.device(device))
    if key not in _hadamard_cache:
        _hadamard_cache[key] = torch.from_numpy(_hadamard_matrix(b)).to(device=device,
                                                                       dtype=dtype)
    return _hadamard_cache[key]


def hadamard_rotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """x' = (x * signs) @ blockdiag(H_b) over the last axis, fp32
    accumulation, in x's dtype: the runtime half of the rotation pair."""
    k = x.shape[-1]
    b = hadamard_block(k)
    if b <= 1:
        return x
    xs = (x * signs.to(x.dtype)).reshape(*x.shape[:-1], k // b, b)
    return (xs @ _hadamard_tensor(b, x.dtype, x.device)).reshape(x.shape)


def _hadamard_rotate_rows(t: torch.Tensor, signs: np.ndarray) -> torch.Tensor:
    """t' = H_b @ (signs * t) along the rows of a (K, ...) fp32 tensor: the
    weight half of the rotation pair, as JAX's quantize_tensor computes it
    (einsum 'ij,gjn->gin').  JAX's host quantizer computes the same rotation
    as a matmul from the other side (_hadamard_rotate_torch below), which
    rounds differently in fp32; the port keeps both so each quantizer's
    codes match its JAX counterpart bit for bit."""
    k = t.shape[0]
    b = hadamard_block(k)
    h = torch.from_numpy(_hadamard_matrix(b).copy()).to(t.device)
    s = torch.from_numpy(signs.copy()).to(t.device)
    tg = (t * s.reshape(-1, *([1] * (t.dim() - 1)))).reshape(k // b, b, *t.shape[1:])
    return torch.einsum("ij,gj...->gi...", h, tg).reshape(t.shape)


# ---------------------------------------------------------------------------
# Round-to-nearest quantizers (runtime half: run on the weights' device)
# ---------------------------------------------------------------------------

_MSE_CLIP_RATIOS = np.linspace(1.0, 0.5, 11)


def _mse_scale(wg: torch.Tensor, base_scale: torch.Tensor) -> torch.Tensor:
    """Grid-search a clip ratio per scale group (axis -2 is the group)
    minimizing the quantization MSE; 11 candidates in [0.5, 1.0]."""
    best_s, best_e = base_scale, None
    for r in _MSE_CLIP_RATIOS:
        s = base_scale * float(np.float32(r))
        q = torch.round(wg / s).clamp_(-127.0, 127.0)
        e = (q * s - wg).pow_(2).sum(dim=-2, keepdim=True)
        if best_e is None:
            best_e = e
        else:
            best_s = torch.where(e < best_e, s, best_s)
            best_e = torch.minimum(e, best_e)
    return best_s


def _rtn(t: torch.Tensor, act_quant: bool, group_size: Optional[int],
         mse_clip: bool = False) -> Dict[str, torch.Tensor]:
    """Round-to-nearest int8 of an fp32 (K, N) weight (the JAX layout, so
    every operation is the JAX package's) -> the port's (N, K) leaf."""
    skey = "sa" if act_quant else "s"
    k, n = t.shape
    if group_size is not None and k % group_size != 0:
        group_size = None  # inputs narrower than a group: one group per column
    if group_size is not None:
        tg = t.reshape(k // group_size, group_size, n)
        scale = torch.clamp(tg.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
        if mse_clip:
            scale = _mse_scale(tg, scale)
        q = torch.round(tg / scale).clamp_(-127.0, 127.0).to(torch.int8).reshape(k, n)
        return {"q": q.T.contiguous(), skey: scale.squeeze(-2)}
    scale = torch.clamp(t.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    if mse_clip:
        scale = _mse_scale(t, scale)
    q = torch.round(t / scale).clamp_(-127.0, 127.0).to(torch.int8)
    return {"q": q.T.contiguous(), skey: scale.squeeze(-2)}


def quantize_tensor(w: torch.Tensor, act_quant: bool = False,
                    group_size: Optional[int] = None, mse_clip: bool = False,
                    hadamard: bool = False,
                    migrate: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """(N, K) weight -> {'q': int8 (N, K), 's'|'sa': fp32 scales[, 'hs'][, 'di']}.

    group_size=None: per-output-channel scales (N,); group_size=g: (K/g, N)
    (per channel when g does not divide K).  act_quant stores the scale
    under 'sa' (W8A8).  mse_clip: MSE-optimal clip search.  hadamard:
    block-Hadamard-rotate the input space first ('hs' leaf).  migrate:
    per-input-channel multipliers di (K,): the weight is divided by di
    first ('di' leaf)."""
    t = w.float().T  # (K, N)
    k = t.shape[0]
    extra: Dict[str, torch.Tensor] = {}
    if migrate is not None:
        di = torch.as_tensor(migrate, dtype=torch.float32, device=t.device)
        t = t / di[:, None]
        extra["di"] = di.clone()
    if hadamard and hadamard_block(k) > 1:
        signs = _hadamard_signs(k)
        t = _hadamard_rotate_rows(t, signs)
        extra["hs"] = torch.from_numpy(signs.copy()).to(t.device)
    out = _rtn(t, act_quant, group_size, mse_clip)
    out.update(extra)
    return out


def _wscale(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    return w["sa"] if "sa" in w else w["s"]


def _is_grouped(w: Dict[str, torch.Tensor]) -> bool:
    # Grouped scales (G, N) have as many axes as the (N, K) codes.
    return _wscale(w).dim() == w["q"].dim()


def dequantize_tensor(w: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """The (N, K) weight a quantized leaf stands for, in `dtype` (of the
    rotated / migrated input space, as the codes are)."""
    q, s = w["q"].float(), _wscale(w)
    if _is_grouped(w):
        n, k = q.shape
        g = s.shape[0]
        return (q.reshape(n, g, k // g) * s.T[:, :, None]).reshape(n, k).to(dtype)
    return (q * s[:, None]).to(dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and ("s" in w or "sa" in w)


def quantize_block(bp: Params, act_quant: bool = False, group_size: Optional[int] = None,
                   keep_bf16: Iterable[str] = (), mse_clip: bool = False,
                   hadamard: bool = False) -> Params:
    """One block's dict with its matmul weights quantized (new dicts; the
    other leaves are shared).  keep_bf16: names ('wo') or 'sub.name' forms
    ('mlp.w2') that stay unquantized."""
    keep = set(keep_bf16)
    out = {}
    for sub, sp in bp.items():
        names = QUANTIZED_BLOCK_WEIGHTS.get(sub, ())
        out[sub] = {
            k: (quantize_tensor(v, act_quant=act_quant, group_size=group_size,
                                mse_clip=mse_clip, hadamard=hadamard)
                if k in names and k not in keep and f"{sub}.{k}" not in keep else v)
            for k, v in sp.items()}
    return out


def quantize_dit_params(params: Params, act_quant: bool = False,
                        group_size: Optional[int] = None, keep_bf16: Iterable[str] = (),
                        mse_clip: bool = False, hadamard: bool = False) -> Params:
    """A new parameter dict with every block's matmuls int8 (the calibration-
    free quantizers; the calibrated ones are quantize_dit_params_host)."""
    out = dict(params)
    out["blocks"] = [quantize_block(bp, act_quant, group_size, keep_bf16, mse_clip, hadamard)
                     for bp in params["blocks"]]
    return out


# ---------------------------------------------------------------------------
# The quantized dense layer
# ---------------------------------------------------------------------------

def _quantize_activation(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Per-token symmetric int8 as the JAX package's XLA path does it: the
    quantize multiply runs in x's dtype, and the dequant is the exact
    inverse of the scale applied.  amax: the tokens' max |x| (..., 1) fp32
    when taken over more than this K.  Returns (x_q int8, dequant fp32
    (..., 1))."""
    if amax is None:
        amax = x.abs().float().amax(dim=-1, keepdim=True)
    inv = activation_inv_scale(amax, x.dtype)
    xq = torch.round(x * inv).clamp_(-127, 127).to(torch.int8)
    return xq, 1.0 / inv.float()


def _w8a8_plain(x: torch.Tensor, w: Dict[str, torch.Tensor],
                amax: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The XLA path of the JAX package's dense_maybe_quantized, with exact
    integer sums: per channel (y * dequant) * s; grouped, an fp32 fold of
    the per-group integer sums in group order (a fused multiply-add, as XLA
    compiles it), then * dequant.  amax: as _quantize_activation's; the
    result in out_dtype (x's dtype unless given)."""
    xq, dequant = _quantize_activation(x, amax)
    lead, k = xq.shape[:-1], xq.shape[-1]
    xq2 = xq.reshape(-1, k)
    s = w["sa"]
    if _is_grouped(w):
        g = s.shape[0]
        gsz = k // g
        y = torch.zeros(xq2.shape[0], s.shape[1], dtype=torch.float32, device=x.device)
        for i in range(g):
            part = int_matmul_exact(xq2[:, i * gsz:(i + 1) * gsz], w["q"][:, i * gsz:(i + 1) * gsz])
            y = fma_f32(part, s[i], y)
        y = y.reshape(*lead, -1) * dequant
    else:
        y = int_matmul_exact(xq2, w["q"]).reshape(*lead, -1) * dequant * s
    return y.to(out_dtype or x.dtype)


def dense_maybe_quantized(x: torch.Tensor, w: Any, row_group=None) -> torch.Tensor:
    """x @ w^T for a plain (N, K) weight or a quantized leaf (module
    docstring: routing, and what each path computes).  A quantized leaf
    raises under autograd when x requires grad: neither its int8 codes nor
    the W8A8 kernel have a gradient.

    row_group: the tensor-parallel group when w is this rank's input columns
    of a row-parallel weight and x its K / tensor slice; the result is then
    the product over the whole K, summed over the group (_row_parallel)."""
    if not is_quantized(w):
        return F.linear(x, w) if row_group is None else _row_parallel_sum(
            linear_fp32(x, w), row_group, x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "a quantized weight (int8 weight-only or W8A8) has no gradient: train the "
            "bf16 / fp32 parameters (the JAX package cannot train quantized leaves either), "
            "or run under torch.no_grad()")
    # Convert-time input-space transforms (the weight carries their inverse).
    if "di" in w:
        x = x * w["di"].to(x.dtype)
    if "hs" in w:
        x = hadamard_rotate(x, w["hs"])
    if "sa" in w:
        if row_group is not None:
            return _w8a8_row_parallel(x, w, row_group)
        if _use_kernel(x):
            return quant_matmul_w8a8(x, w["q"], w["sa"])
        return _w8a8_plain(x, w)
    wd = dequantize_tensor(w, x.dtype)
    return F.linear(x, wd) if row_group is None else _row_parallel_sum(
        linear_fp32(x, wd), row_group, x.dtype)


def _use_kernel(x: torch.Tensor) -> bool:
    return x.is_cuda and math.prod(x.shape[:-1]) >= KERNEL_MIN_ROWS


def _row_parallel_sum(part: torch.Tensor, group, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel layer's fp32 partial products summed over the group,
    then rounded to `dtype` once, as XLA sums JAX's fp32 dot before its
    cast."""
    return all_reduce_sum(part, group).to(dtype)


def _w8a8_row_parallel(x: torch.Tensor, w: Dict[str, torch.Tensor], group) -> torch.Tensor:
    """A W8A8 row-parallel product summed over the tensor group, as XLA
    partitions JAX's: each token is quantized with its max |x| over the
    whole K (a max all-reduce); per channel the integer sums are added
    across the group before the scales (JAX's int32 dot is summed exactly),
    which leaves the result the unsharded one's; per group each rank folds
    its own groups in fp32 and the folds are added."""
    amax = all_reduce_max(x.abs().amax(dim=-1, keepdim=True).float(), group)
    q, sa = w["q"], w["sa"]
    if _is_grouped(w):
        part = (quant_matmul_w8a8(x, q, sa, amax, torch.float32) if _use_kernel(x)
                else _w8a8_plain(x, w, amax, torch.float32))
        return _row_parallel_sum(part, group, x.dtype)
    lead, k = x.shape[:-1], x.shape[-1]
    if _use_kernel(x):
        # The kernel with unit scales writes f32(sum_k xq * q): the integer
        # sums, exact below 2^24; the scales follow its own order.
        xq, dq = quantize_activation_fp32(x.reshape(-1, k), amax.reshape(-1, 1))
        acc = quant_matmul_w8a8_kernel(xq, torch.ones_like(dq), q, torch.ones_like(sa),
                                       torch.float32)
        y = (all_reduce_sum(acc, group) * sa) * dq[:, None]
    else:
        xq, dequant = _quantize_activation(x, amax)
        acc = all_reduce_sum(int_matmul_exact(xq.reshape(-1, k), q), group)
        y = acc.reshape(*lead, -1) * dequant * sa
    return y.reshape(*lead, -1).to(x.dtype)


class _LinearFP32(torch.autograd.Function):
    """(M, K) x (N, K) -> (M, N) fp32 from bf16 operands: cuBLAS writes its
    fp32 accumulator.  The backward is the plain one in the operands' dtype."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w, g.t() @ x2


def linear_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T accumulated and returned in fp32, with no rounding to x's
    dtype (on the CPU the operands are upcast)."""
    if x.dtype == torch.float32 or not x.is_cuda:
        return F.linear(x.float(), w.float())
    y = _LinearFP32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[0])


# ---------------------------------------------------------------------------
# Host half: the convert-time quantizers (CPU, fp32), a faithful copy of the
# JAX package's torch code.  Inside, weights are (K, N) contiguous, the JAX
# layout, so every operation and reduction order is JAX's; leaves come out
# in the port's (N, K) layout, on the weight's device.
# ---------------------------------------------------------------------------

def _host_f32(a) -> torch.Tensor:
    """A CPU fp32 copy of a tensor or numpy array."""
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a
                           ).detach().to("cpu", torch.float32)


def _host_kn(w) -> torch.Tensor:
    """A port (N, K) weight as the contiguous fp32 (K, N) the JAX code sees."""
    return _host_f32(w).T.contiguous()


def _to_device(leaf: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in leaf.items()}


def _hadamard_rotate_torch(t: torch.Tensor, signs: np.ndarray, axis: int) -> torch.Tensor:
    """Block-Hadamard rotate a CPU tensor along `axis` (t' = H_b @ (s*t))."""
    k = t.shape[axis]
    b = hadamard_block(k)
    h = torch.from_numpy(_hadamard_matrix(b).copy())
    t = torch.movedim(t, axis, -1) * torch.from_numpy(signs.copy())
    shape = t.shape
    t = (t.reshape(*shape[:-1], k // b, b) @ h).reshape(shape)
    return torch.movedim(t, -1, axis)


def quantize_tensor_host(w, act_quant: bool = False, group_size: Optional[int] = None,
                         mse_clip: bool = False, hadamard: bool = False,
                         migrate=None) -> Dict[str, torch.Tensor]:
    """Host-side quantize_tensor of an (N, K) weight (the same leaf
    contract), computed on the CPU so no fp32 device temporaries are made."""
    t = _host_kn(w)
    k = t.shape[0]
    extra: Dict[str, torch.Tensor] = {}
    if migrate is not None:
        di = _host_f32(migrate)
        t = t / di.unsqueeze(-1)
        extra["di"] = di.clone()
    if hadamard and hadamard_block(k) > 1:
        signs = _hadamard_signs(k)
        t = _hadamard_rotate_torch(t, signs, axis=-2)
        extra["hs"] = torch.from_numpy(signs.copy())
    out = _rtn(t, act_quant, group_size, mse_clip)
    out.update(extra)
    return _to_device(out, w.device if isinstance(w, torch.Tensor) else "cpu")


_AWQ_ALPHA_GRID = (0.0, 0.25, 0.5, 0.75, 1.0)


def _awq_migration_kn(t: torch.Tensor, amean, *, act_quant: bool,
                      group_size: Optional[int], ex2=None) -> torch.Tensor:
    """di (K,) for a (K, N) fp32 weight: max|W_k|^(1-a) / amean_k^a
    (geometric mean 1), a on a grid, minimizing the calibration-weighted
    output-error proxy sum_k E[x_k^2] di_k^2 |dW'_k|^2 (+ a per-token
    activation-quantization term under act_quant)."""
    k = t.shape[-2]
    wmax = t.abs().amax(dim=-1).clamp_(min=1e-8)
    xs = _host_f32(amean).clamp(min=1e-8)
    ex2_t = (_host_f32(ex2) if ex2 is not None else xs.pow(2)).clamp(min=1e-12)

    def err(di):
        tw = t / di.unsqueeze(-1)
        leaf = _rtn(tw, act_quant, group_size)
        st = leaf["sa" if act_quant else "s"]
        q = leaf["q"].T.contiguous().to(torch.float32)
        if st.ndim == 2:  # grouped (G, N): expand over group rows
            g = k // st.shape[0]
            dq = (q.reshape(st.shape[0], g, -1) * st.unsqueeze(1)).reshape(k, -1)
        else:
            dq = q * st
        werr = (dq - tw).pow_(2).sum(dim=-1)
        obj = (ex2_t * di.pow(2) * werr).sum()
        if act_quant:
            s_tok = (xs * di).amax() / 127.0
            obj = obj + (s_tok ** 2 / 12.0) * tw.pow(2).sum()
        return float(obj)

    best_di, best_obj = None, None
    for alpha in _AWQ_ALPHA_GRID:
        di = wmax.pow(1.0 - alpha) / xs.pow(alpha)
        di = di / torch.exp(torch.log(di).mean())
        obj = err(di)
        if best_obj is None or obj < best_obj:
            best_di, best_obj = di, obj
    return best_di


def awq_migration_host(w, amean, *, act_quant: bool, group_size: Optional[int],
                       ex2=None) -> torch.Tensor:
    """Per-input-channel migration multipliers di (K,) for one (N, K)
    weight, from mean|x| (K,) at its input site (AWQ / SmoothQuant)."""
    return _awq_migration_kn(_host_kn(w), amean, act_quant=act_quant,
                             group_size=group_size, ex2=ex2)


def _transform_hessian_torch(h, di=None, signs=None):
    """H' of the transformed input space: x' = x*di -> diag(di) H diag(di);
    x' = (x*hs) @ H_b -> R^T H R with R = diag(hs) blockdiag(H_b)."""
    if di is not None:
        h = h * di.unsqueeze(-1) * di.unsqueeze(-2)
    if signs is not None:
        h = _hadamard_rotate_torch(h, signs, axis=-2)
        h = _hadamard_rotate_torch(h, signs, axis=-1)
    return h


def _gptq_kn(t: torch.Tensor, hessian, *, act_quant: bool, group_size: Optional[int],
             mse_clip: bool, damp: float, blocksize: int) -> Dict[str, torch.Tensor]:
    """GPTQ on a (K, N) fp32 weight (Frantar et al.): input dims quantized
    in order, each one's rounding error carried onto the later ones through
    the Cholesky factor of H^-1.  Returns the port's (N, K) leaf."""
    t = t.clone()
    h = _host_f32(hessian).clone()
    k, n = t.shape
    skey = "sa" if act_quant else "s"
    if group_size is not None and k % group_size != 0:
        group_size = None
    if group_size is not None:
        if group_size > blocksize:
            blocksize = group_size
        assert blocksize % group_size == 0, (
            f"group {group_size} must nest within GPTQ block {blocksize}")

    diag = torch.arange(k)
    dead = torch.diag(h) <= 0
    h[diag[dead], diag[dead]] = 1.0
    t[dead, :] = 0.0
    h[diag, diag] += damp * torch.diag(h).mean()
    hinv = torch.cholesky_inverse(torch.linalg.cholesky(h))
    u = torch.linalg.cholesky(hinv, upper=True)

    q_codes = torch.empty((k, n), dtype=torch.int8)
    if group_size is None:
        scale = torch.clamp(t.abs().amax(dim=0) / 127.0, min=1e-12)
        if mse_clip:
            scale = _mse_scale(t, scale.unsqueeze(0)).squeeze(0)
        scales_out = scale
    else:
        scales_out = torch.empty((k // group_size, n))

    cur_scale = scale if group_size is None else None
    for bs in range(0, k, blocksize):
        be = min(bs + blocksize, k)
        wb = t[bs:be].clone()
        eb = torch.zeros_like(wb)
        ub = u[bs:be, bs:be]
        for i in range(be - bs):
            gi = bs + i
            if group_size is not None and gi % group_size == 0:
                grows = wb[i:i + group_size]
                gs = torch.clamp(grows.abs().amax(dim=0) / 127.0, min=1e-12)
                if mse_clip:
                    gs = _mse_scale(grows, gs.unsqueeze(0)).squeeze(0)
                scales_out[gi // group_size] = gs
                cur_scale = gs
            qi = torch.round(wb[i] / cur_scale).clamp_(-127.0, 127.0)
            q_codes[gi] = qi.to(torch.int8)
            err = (wb[i] - qi * cur_scale) / ub[i, i]
            if i + 1 < be - bs:
                wb[i + 1:] -= ub[i, i + 1:].unsqueeze(1) * err.unsqueeze(0)
            eb[i] = err
        if be < k:
            t[be:] -= u[bs:be, be:].T @ eb
    return {"q": q_codes.T.contiguous(), skey: scales_out}


def gptq_quantize_host(w, hessian, *, act_quant: bool = False,
                       group_size: Optional[int] = None, mse_clip: bool = False,
                       damp: float = 0.01, blocksize: int = 128) -> Dict[str, torch.Tensor]:
    """GPTQ error-compensating rounding of one (N, K) weight against the
    calibration Hessian H = sum x^T x (K, K) of its input site, both in the
    final (migrated / rotated) input space.  With H ~ I it is RTN."""
    return _gptq_kn(_host_kn(w), hessian, act_quant=act_quant, group_size=group_size,
                    mse_clip=mse_clip, damp=damp, blocksize=blocksize)


def quantize_leaf_host(w, mode: QuantMode, amean=None, hessian=None) -> Dict[str, torch.Tensor]:
    """Quantize one (N, K) block weight on the host per a QuantMode, with
    optional calibration stats of its input site: amean (K,) (awq) and
    hessian (K, K) (gptq).  Without stats the calibrated steps are skipped
    (the dead ca.wq / ca.wk); quantize_dit_params_host checks that live
    sites have them."""
    t = _host_kn(w)
    k = t.shape[0]
    extra: Dict[str, torch.Tensor] = {}
    di = None
    if mode.awq and amean is not None:
        ex2 = torch.diagonal(_host_f32(hessian)) if hessian is not None else None
        di = _awq_migration_kn(t, amean, act_quant=mode.act_quant, group_size=mode.group_size,
                               ex2=ex2)
        t = t / di.unsqueeze(-1)
        extra["di"] = di
    signs = None
    if mode.hadamard and hadamard_block(k) > 1:
        signs = _hadamard_signs(k)
        t = _hadamard_rotate_torch(t, signs, axis=-2)
        extra["hs"] = torch.from_numpy(signs.copy())
    if mode.gptq and hessian is not None:
        h = _host_f32(hessian)
        if di is not None:
            h = _transform_hessian_torch(h, di=di)
        if signs is not None:
            h = _transform_hessian_torch(h, signs=signs)
        leaf = _gptq_kn(t, h, act_quant=mode.act_quant, group_size=mode.group_size,
                        mse_clip=mode.mse_clip, damp=0.01, blocksize=128)
    else:
        leaf = _rtn(t, mode.act_quant, mode.group_size, mse_clip=mode.mse_clip)
    leaf.update(extra)
    return _to_device(leaf, w.device if isinstance(w, torch.Tensor) else "cpu")


def _block_stat(a, i: int, nd: int):
    """Block i's slice of a stat that is per block (nd+1 dims) or shared
    (nd dims): nd=1 for amean (K,), nd=2 for hessian (K, K)."""
    if a is None:
        return None
    return a[i] if np.ndim(a) == nd + 1 else a


def mix_block_damage(params: Params, mode, calib: Optional[Dict[str, Any]] = None) -> np.ndarray:
    """Per-block quantization damage for the '_mixN' ranking: over every
    quantized (non-kept) leaf, sum_k d_k |dW_k|^2 with dW the plain RTN
    error at the mode's group size and d_k = diag(H)_k with a captured
    Hessian, amean_k^2 with only mean|x|, else 1.  The dead ca.wq / ca.wk
    count with d = 1, as in the JAX package.  Returns (nb,) float64."""
    if isinstance(mode, str):
        mode = parse_quant_mode(mode)
    calib = calib or {}
    keep = set(mode.keep)
    blocks = params["blocks"]
    nb = len(blocks)
    damage = None
    for sub, names in QUANTIZED_BLOCK_WEIGHTS.items():
        for name in names:
            if name in keep or f"{sub}.{name}" in keep:
                continue
            if damage is None:
                damage = np.zeros(nb, np.float64)
            site = LEAF_SITE.get(f"{sub}.{name}")
            h = calib.get("h", {}).get(site)
            am = calib.get("amean", {}).get(site)
            for i, bp in enumerate(blocks):
                t = _host_kn(bp[sub][name])
                k = t.shape[0]
                gsz = mode.group_size if (mode.group_size and k % mode.group_size == 0) else None
                if gsz:
                    tg = t.reshape(k // gsz, gsz, -1)
                    s = tg.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127
                    dq = torch.round(tg / s).clamp(-127, 127) * s
                    err2 = (dq - tg).pow_(2).reshape(k, -1).sum(dim=-1)
                else:
                    s = t.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / 127
                    dq = torch.round(t / s).clamp(-127, 127) * s
                    err2 = (dq - t).pow_(2).sum(dim=-1)
                if h is not None:
                    d = np.diagonal(np.asarray(_block_stat(h, i, 2)))
                elif am is not None:
                    d = np.asarray(_block_stat(am, i, 1)) ** 2
                else:
                    d = np.ones(k, np.float64)
                damage[i] += (err2.numpy().astype(np.float64) * d).sum()
    if damage is None:
        raise ValueError("mix mode: no live quantized leaves")
    return damage


def _mix_bf16_set(params: Params, mode: QuantMode, calib, nb: int) -> frozenset:
    """Indices of the mix_blocks blocks that stay unquantized: damage-ranked
    when calibration stats exist, the boundary blocks otherwise."""
    n = min(mode.mix_blocks, nb)
    if calib and (calib.get("h") or calib.get("amean")):
        order = np.argsort(mix_block_damage(params, mode, calib))[::-1]
        return frozenset(int(i) for i in order[:n])
    half = (n + 1) // 2
    return frozenset(range(half)) | frozenset(range(nb - (n - half), nb))


def _quantize_block_host(bp: Params, i: int, mode: QuantMode, keep, ameans, hs) -> Params:
    """Block i quantized per the QuantMode; unquantized leaves pass through."""
    out = {}
    for sub, sp in bp.items():
        names = QUANTIZED_BLOCK_WEIGHTS.get(sub, ())
        out[sub] = dict(sp)
        for name in names:
            if name in keep or f"{sub}.{name}" in keep:
                continue
            site = LEAF_SITE.get(f"{sub}.{name}")
            amean = _block_stat(ameans.get(site), i, 1)
            hess = _block_stat(hs.get(site), i, 2) if mode.gptq else None
            if mode.needs_calibration and site is not None:
                if mode.awq and amean is None:
                    raise ValueError(
                        f"quant mode requires calibration: no amean stats for site {site!r} "
                        f"({sub}.{name}); run models/calibrate.capture_dit_stats first")
                if mode.gptq and hess is None and site in ("fa.qkv", "fa.wo", "mlp.w1"):
                    # The token-fed sites must not silently lose their error
                    # compensation; ca.* (rank-B Hessians) and mlp.w2 (a
                    # 16384^2 H) fall back to RTN by design.
                    raise ValueError(
                        f"gptq mode: no hessian for site {site!r} ({sub}.{name}); capture "
                        "with hessian_sites= or keep_bf16 this matmul")
            out[sub][name] = quantize_leaf_host(sp[name], mode, amean=amean, hessian=hess)
    return out


def quantize_dit_params_host(params: Params, mode, calib: Optional[Dict[str, Any]] = None,
                             keep_bf16: Iterable[str] = ()) -> Params:
    """Host-side quantization for any QuantMode (or mode string), the
    calibrated quantizers included.  calib: capture_dit_stats' output
    ({"amean": {site: (nb, K)}, "h": {site: (nb, K, K)}}), required by the
    awq / gptq modes.  '_mixN' keeps the N most damaged blocks (or, without
    stats, the boundary blocks) unquantized: the result's block list mixes
    unquantized and quantized block dicts."""
    if isinstance(mode, str):
        mode = parse_quant_mode(mode)
    keep = set(keep_bf16) | set(mode.keep)
    calib = calib or {}
    ameans, hs = calib.get("amean", {}), calib.get("h", {})
    blocks = params["blocks"]
    unquantized = (_mix_bf16_set(params, mode, calib, len(blocks)) if mode.mix_blocks
                   else frozenset())
    out = dict(params)
    out["blocks"] = [bp if i in unquantized else
                     _quantize_block_host(bp, i, mode, keep, ameans, hs)
                     for i, bp in enumerate(blocks)]
    return out
