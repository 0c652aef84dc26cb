"""Bounded flash attention: the CUDA kernels' wrappers and their plain version.

Counterpart of diffusionrenderer_tpu/ops/flash_attention.py
(`flash_attention(bounded=True)` and `bounded=False`).  The kernels are in
`csrc/flash_attention.cu`; this module holds

* `flash_attention` - the entry point: the plain version for CPU tensors,
  the kernels for CUDA tensors (it launches or raises, it never falls back);
* `flash_headroom` / `flash_attention_kernel` - the two launch wrappers,
  each adding one to its count in `LAUNCHES` per launch;
* `flash_attention_plain` / `headroom_stats_plain` - the plain PyTorch
  version of the same function, with the same no-shift / online split and
  the same headroom rule, so the CPU tests exercise the branch logic.

The branch rule is that of the JAX package (_bounded_cond_call): with q
pre-scaled by softmax_scale*log2(e) and the row bound m_i = ||q_i|| * max_j
||k_j||, the unshifted p = exp2(s) is used when

    max_i m_i + log2(Lk_pad) + log2(max |v|) < 120,

and the online softmax otherwise.  Lk_pad is the padded key length of the
JAX kernel's own tiling, so both packages pick the same branch for the
same inputs.  On the card the kernel evaluates the rule itself from the
stats buffer that `flash_headroom` fills, so no call waits for the host;
which branch ran is counted on the device, by launch (`branch_counts`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

_LOG2E = math.log2(math.e)
HEADROOM_LIMIT = 120.0
HEAD_DIMS = (64, 128, 256, 512)
_JAX_DEFAULT_BLOCK_K = 2816  # diffusionrenderer_tpu/ops/flash_attention.py DEFAULT_BLOCK_K

# Launches of each kernel since the last reset_counts(), counted by its wrapper.
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_headroom": 0}
# Per device, int32[2]: how many attention launches took the no-shift and the
# online branch, counted on the device by block (0, 0, 0) of each launch.
_tallies: Dict[torch.device, torch.Tensor] = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for t in _tallies.values():
        t.zero_()


def _tally(device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in _tallies:
        _tallies[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _tallies[dev]


def branch_counts(device="cuda") -> Dict[str, int]:
    """Attention launches on `device` since reset_counts() that took the
    no-shift and the online branch (reads the device counter: syncs)."""
    noshift, online = (int(x) for x in _tally(device).cpu())
    return {"noshift": noshift, "online": online}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def reference_lk_pad(lk: int, d: int) -> int:
    """Padded key length of the JAX kernel's default tiling (_flash_call):
    the headroom rule's log2(Lk) term is taken of it."""
    block_k = min(_JAX_DEFAULT_BLOCK_K, _round_up(lk, 128))
    if d > 128:
        block_k = min(block_k, 512)
    ntiles = -(-lk // block_k)
    block_k = min(block_k, _round_up(-(-lk // ntiles), 128))
    return _round_up(lk, block_k)


def _q_scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    # softmax_scale * log2(e) rounded to the activation dtype first, as the
    # JAX wrapper's weakly-typed multiply does.
    return torch.tensor(1.0 / math.sqrt(d) * _LOG2E, dtype=dtype)


def q_prescale(q: torch.Tensor) -> torch.Tensor:
    """q * (softmax_scale * log2 e), rounded to q's dtype."""
    return (q * _q_scale(q.shape[-1], q.dtype).to(q.device)).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def headroom_stats_plain(q, k, v) -> torch.Tensor:
    """fp32 [max_i ||q'_i|| per (b, h), max_j ||k_j|| per (b, h), max |v|],
    laid out as the kernel's stats buffer ((b, h) row-major)."""
    qn = torch.linalg.vector_norm(q_prescale(q).float(), dim=-1).amax(dim=1)
    kn = torch.linalg.vector_norm(k.float(), dim=-1).amax(dim=1)
    vmax = v.float().abs().amax()
    return torch.cat([qn.reshape(-1), kn.reshape(-1), vmax.reshape(1)])


def use_noshift(stats: torch.Tensor, n_bh: int, lk: int, d: int) -> torch.Tensor:
    """The headroom rule on a stats buffer: a 0-dim bool tensor."""
    mb = (stats[:n_bh] * stats[n_bh:2 * n_bh]).amax()
    headroom = (mb + math.log2(reference_lk_pad(lk, d))
                + torch.log2(stats[2 * n_bh].clamp_min(1e-30)))
    return headroom < HEADROOM_LIMIT


def flash_attention_plain(q, k, v, *, bounded: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with the kernel's rounding points.

    q: (B, Lq, H, D); k, v: (B, Lk, H, D) -> (B, Lq, H, D) in q's dtype."""
    b, _, h, d = q.shape
    noshift = bounded and bool(
        use_noshift(headroom_stats_plain(q, k, v), b * h, k.shape[1], d))
    s = torch.einsum("bqhd,bkhd->bhqk", q_prescale(q).float(), k.float())
    if not noshift:
        s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s)
    l = p.sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B, Lq, H, 1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    if noshift:
        l = l.clamp_min(1e-37)
    return (acc / l).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import library

        lib = library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.drt_flash_headroom.argtypes = [ptr] * 4 + [i32] * 5 + [f32, ptr]
        lib.drt_flash_headroom.restype = i32
        lib.drt_flash_attention.argtypes = (
            [ptr] * 6 + [i32] * 5 + [f32, f32, i32, ptr])
        lib.drt_flash_attention.restype = i32
        lib.drt_error_string.argtypes = [i32]
        lib.drt_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check_kernel_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, L, H, D) q, k, v")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"mismatched shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}: the kernel runs on CUDA tensors")
        if x.device != q.device:
            raise ValueError("q, k and v must lie on one device")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {x.dtype}: the kernel takes bfloat16")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, lq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if lq < 1 or k.shape[1] < 1 or not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f"unsupported sizes q{tuple(q.shape)} k{tuple(k.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().drt_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} (code {err})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_headroom(q, k, v) -> torch.Tensor:
    """Launch the headroom kernel: the stats buffer of headroom_stats_plain."""
    _check_kernel_inputs(q, k, v)
    b, lq, h, d = q.shape
    stats = torch.empty(2 * b * h + 1, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().drt_flash_headroom(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), stats.data_ptr(),
            b, lq, k.shape[1], h, d, float(_q_scale(d, q.dtype)),
            _stream(q.device))
    _raise_on(err, "flash_headroom")
    LAUNCHES["flash_attention_headroom"] += 1
    return stats


def flash_attention_kernel(q, k, v, stats: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the attention kernel.  stats (from flash_headroom) lets the
    kernel choose the branch on the device; None forces the online branch."""
    _check_kernel_inputs(q, k, v)
    b, lq, h, d = q.shape
    if stats is not None and (stats.device != q.device or stats.dtype != torch.float32
                              or stats.numel() != 2 * b * h + 1):
        raise ValueError("stats must be flash_headroom's output for these inputs")
    out = torch.empty_like(q)
    tally = _tally(q.device)
    with torch.cuda.device(q.device):
        err = _lib().drt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), tally.data_ptr(),
            b, lq, k.shape[1], h, d, float(_q_scale(d, q.dtype)),
            math.log2(reference_lk_pad(k.shape[1], d)), int(stats is not None),
            _stream(q.device))
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, bounded: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v, non-causal; q: (B, Lq, H, D), k, v:
    (B, Lk, H, D).  bounded=True picks the no-shift branch when the headroom
    rule holds (the JAX package's default); bounded=False is the online
    softmax throughout ('pallas_onlinemax')."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bounded=bounded)
    stats = flash_headroom(q, k, v) if bounded else None
    return flash_attention_kernel(q, k, v, stats)
