"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of diffusionrenderer_tpu/ops/flash_attention.py
(`flash_attention(bounded=..., qk_int8=..., pv_int8=...)`).  The kernels are
in `csrc/flash_attention_wgmma.cu` (on wgmma and TMA: kernels 1 and 2 in one
launch, kernel 3, and kernels 6 and 7, at every head dim),
`csrc/flash_attention.cu` (the headroom kernel) and
`csrc/flash_attention_int8.cu` (kernel 5, on wgmma); this module holds

* `flash_attention` - the entry point, with the JAX package's signature and
  defaults: the plain versions for CPU tensors, the kernels for CUDA tensors
  (it launches or raises, it never falls back);
* `flash_headroom` / `flash_attention_kernel` / `flash_attention_int8_launch`
  - the launch wrappers, each adding one to its count in `LAUNCHES` per
  launch (`int8_operands` runs the int8 kernel's pre-passes);
* `flash_attention_plain` / `headroom_stats_plain` - the plain PyTorch
  version of the bf16 kernels, with the same no-shift / online split and
  the same headroom rule, so the CPU tests exercise the branch logic;
* `flash_attention_int8_plain` - the plain version of the int8 kernel
  (SageAttention-style int8 QK^T, optionally int8 PV), walking the keys in
  the same tiles, since P is rounded relative to the running max;
* `flash_attention_partial` - the online softmax that also returns the
  per-row running max m (log2 domain) and normalizer l, the inner block of
  ring attention (`flash_attention_partial_kernel`, whose keys split over
  2-block clusters at D = 256 and 512 where the grid is small,
  `partial_key_split`; plain version `flash_attention_partial_plain`);
* `flash_attention_bounded_shift` and `flash_attention(bounded=True,
  pipelined=True)` - the bounded softmax p = exp2(s - mb_i) with the row
  bound of `row_bound` (`flash_attention_bounded_kernel`, one kernel with
  and one without the carried score tile, one schedule at D = 256 and 512,
  whose keys split over 2-block clusters where the grid is small,
  `bounded_key_split`; plain version `flash_attention_bounded_plain`).  As
  in JAX, no dispatcher route reaches the first: it is called by name.

Under autograd (grad enabled and q, k or v requiring grad) `flash_attention`
goes through `FlashAttentionFunction` whatever its `bounded` flag (no-shift,
online and exact softmax are one function up to rounding): the forward is
kernel 3 (`flash_attention_partial`), whose m and l are the statistics a
flash backward needs, and the backward is plain PyTorch
(`flash_attention_backward_plain`), as the JAX package leaves the gradient
to XLA.  The routes with no gradient (int8 q/k or PV, the bounded shift with
or without the carried tile, `flash_attention_partial` itself, the launch
wrappers) raise under autograd rather than return an output cut from the
graph.  Under `torch.no_grad` / `inference_mode` every route is as before.

`LAUNCHES` counts the launches of the headroom kernel, of the launch that
holds kernels 1 and 2 ("flash_attention", one per bf16 attention call at
every head dim) and of kernel 5; `VARIANT_LAUNCHES` those of kernels 3, 6
and 7, which take no headroom launch and no branch tally.

The public routes (`flash_attention` in every mode,
`flash_attention_bounded_shift`, `flash_attention_partial`, `int8_operands`)
take any strided view: on CUDA they copy q, k and v once to a contiguous,
16-byte-aligned tensor where they are not one already.  The launch wrappers
below them refuse what their kernel cannot read.

The branch rule is that of the JAX package (_bounded_cond_call): with q
pre-scaled by softmax_scale*log2(e) and the row bound m_i = ||q_i|| * max_j
||k_j||, the unshifted p = exp2(s) is used when

    max_i m_i + log2(Lk_pad) + log2(max |v|) < 120,

and the online softmax otherwise.  Lk_pad is the padded key length of the
JAX kernel's own tiling, so both packages pick the same branch for the
same inputs.  On the card the kernels evaluate the rule themselves from the
stats buffer that `flash_headroom` fills, so no call waits for the host;
which branch ran is counted on the device, one per call (`branch_counts`).
A bounded call is one headroom launch and one attention launch; an
unbounded call is the attention launch alone, in the online branch.

The no-shift and bounded modes take exp2 with weights below 2^-126 flushed
to zero, as the kernels' ex2.approx.ftz and XLA's CPU backend do: rows
whose shift overshoots their true max by more than fp32's range come out
as zeros in both packages.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional

import torch

_LOG2E = math.log2(math.e)
HEADROOM_LIMIT = 120.0
_LOG2_127 = math.log2(127.0)
_NEG_INF = -1e30
_FP32_TINY = 2.0 ** -126  # the smallest normal fp32: exp2 below it flushes to zero
HEAD_DIMS = (64, 128, 256, 512)
# Keys per tile of the int8 kernel at each head dim it takes
# (csrc/flash_attention_int8.cu, drt_flash_int8_block_k).
INT8_BLOCK_K = {64: 64, 128: 64, 256: 64, 512: 64}
# Keys per tile of the wide bf16 body at D = 256, 512, where the key split of
# kernels 3, 6 and 7 cuts between tiles (csrc/flash_attention_wgmma.cu,
# drt_flash_wgmma_block_k).
WIDE_BLOCK_K = {256: 64, 512: 32}
_JAX_DEFAULT_BLOCK_K = 2816  # diffusionrenderer_tpu/ops/flash_attention.py DEFAULT_BLOCK_K

# Launches of each kernel since the last reset_counts(), counted by its wrapper.
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_headroom": 0,
                            "flash_attention_int8": 0}
VARIANT_LAUNCHES: Dict[str, int] = {"flash_attention_partial": 0,
                                    "flash_attention_bounded_pipe": 0,
                                    "flash_attention_bounded": 0}
# Per device, int32[2]: how many bf16 attention calls took the no-shift and
# the online branch, counted on the device by block (0, 0, 0) of the
# attention launch.
_tallies: Dict[torch.device, torch.Tensor] = {}


def reset_counts() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for name in counts:
            counts[name] = 0
    for t in _tallies.values():
        t.zero_()


def _tally(device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in _tallies:
        # A normal tensor even when the first launch runs under
        # torch.inference_mode (generate): reset_counts zeroes it outside.
        with torch.inference_mode(False):
            _tallies[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _tallies[dev]


def branch_counts(device="cuda") -> Dict[str, int]:
    """Attention launches on `device` since reset_counts() that took the
    no-shift and the online branch (reads the device counter: syncs)."""
    noshift, online = (int(x) for x in _tally(device).cpu())
    return {"noshift": noshift, "online": online}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def reference_block_k(lk: int, d: int, block_k: Optional[int] = None) -> int:
    """The key tile of the JAX kernels (_flash_call): the default 2816,
    clamped and rebalanced, or an explicit block_k, clamped only."""
    explicit = block_k is not None
    bk = min(block_k if explicit else _JAX_DEFAULT_BLOCK_K, _round_up(lk, 128))
    if d > 128:
        bk = min(bk, 512)
    if not explicit:
        ntiles = -(-lk // bk)
        bk = min(bk, _round_up(-(-lk // ntiles), 128))
    return bk


def reference_lk_pad(lk: int, d: int) -> int:
    """Padded key length of the JAX kernel's default tiling (_flash_call):
    the headroom rule's log2(Lk) term is taken of it."""
    return _round_up(lk, reference_block_k(lk, d))


def _q_scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    # softmax_scale * log2(e) rounded to the activation dtype first, as the
    # JAX wrapper's weakly-typed multiply does.
    return torch.tensor(1.0 / math.sqrt(d) * _LOG2E, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _q_scale_value(d: int, dtype: torch.dtype) -> float:
    """_q_scale as a Python float, for the kernels' arguments (cached: the
    launch wrappers run on the host-bound path)."""
    return float(_q_scale(d, dtype))


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


def _scores(q, k) -> torch.Tensor:
    """fp32 (B, H, Lq, Lk) log2-domain scores q' k^T (q pre-scaled, rounded)."""
    return torch.einsum("bqhd,bkhd->bhqk", q_prescale(q).float(), k.float())


def _softmax_pv(s, v, *, clamp: bool, dtype):
    """P = exp2(s) of already shifted scores, then (P in v's dtype) V / l:
    (out (B, Lq, H, D) in dtype, l (B, H, Lq)).  clamp (the no-shift and
    bounded modes): P below 2^-126 flushed to zero and l clamped at 1e-37."""
    p = torch.exp2(s)
    if clamp:
        p = torch.where(p < _FP32_TINY, 0.0, p)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    denom = l.clamp_min(1e-37) if clamp else l
    return (acc / denom.permute(0, 2, 1)[..., None]).to(dtype), l


def flash_attention_plain(q, k, v, *, bounded: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with the kernel's rounding points.

    q: (B, Lq, H, D); k, v: (B, Lk, H, D) -> (B, Lq, H, D) in q's dtype."""
    b, _, h, d = q.shape
    noshift = bounded and bool(
        use_noshift(headroom_stats_plain(q, k, v), b * h, k.shape[1], d))
    s = _scores(q, k)
    if not noshift:
        s = s - s.amax(dim=-1, keepdim=True)
    return _softmax_pv(s, v, clamp=noshift, dtype=q.dtype)[0]


def flash_attention_partial_plain(q, k, v):
    """The partial-stats kernel's function: (out, m, l) with out (B, Lq, H, D)
    normalized over these keys in q's dtype, and fp32 (B, H, Lq) m = max_j s_ij
    (log2 domain: s = q' k^T with q' = q * scale * log2 e) and l = sum_j
    exp2(s_ij - m_i), not clamped."""
    s = _scores(q, k)
    m = s.amax(dim=-1)
    out, l = _softmax_pv(s - m[..., None], v, clamp=False, dtype=q.dtype)
    return out, m, l


def row_bound(q, k) -> torch.Tensor:
    """The bounded kernels' per-row shift, as _flash_call computes it: fp32
    (B, H, Lq) ||q'_i|| * max_j ||k_j|| per (b, h), with q' the pre-scaled q
    rounded to q's dtype (an upper bound of every score of row i)."""
    qn = q_prescale(q).float().square().sum(dim=-1).sqrt()  # (B, Lq, H)
    kn = k.float().square().sum(dim=-1).sqrt().amax(dim=1, keepdim=True)  # (B, 1, H)
    return (qn * kn).permute(0, 2, 1).contiguous()


def flash_attention_bounded_plain(q, k, v, mb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bounded kernels' function: p = exp2(s - mb_i) with no running max,
    weights below 2^-126 flushed and l clamped at 1e-37, so rows whose bound
    overshoots their true max by more than fp32's range come out as zeros,
    as in JAX.  mb defaults to row_bound(q, k)."""
    mb = row_bound(q, k) if mb is None else mb
    return _softmax_pv(_scores(q, k) - mb[..., None], v, clamp=True, dtype=q.dtype)[0]


def _quant_rows_int8(x: torch.Tensor):
    """Per-(b, token, head) symmetric int8 over head_dim (JAX :394-402).
    x: (B, L, H, D) -> (int8 (B, L, H, D), fp32 scales (B, H, L))."""
    s = x.abs().amax(dim=-1).float().clamp_min(1e-6) / 127.0  # (B, L, H)
    xi = torch.div(x, s[..., None]).round_().to(torch.int8)  # x / s in fp32
    return xi, s.permute(0, 2, 1).contiguous()


def _quant_channels_int8(v: torch.Tensor):
    """Per-(b, head, channel) symmetric int8 over tokens (JAX :405-413).
    v: (B, L, H, D) -> (int8 (B, L, H, D), fp32 scales (B, H, D))."""
    s = v.abs().amax(dim=1).float().clamp_min(1e-6) / 127.0  # (B, H, D)
    return torch.div(v, s[:, None]).round_().to(torch.int8), s


def _transpose_v_int8(vi: torch.Tensor, lk_pad: int) -> torch.Tensor:
    """int8 V (B, Lk, H, D) -> (B, H, D, lk_pad), zero past Lk, keys of each
    32-key group stored in the order the kernel's P fragment holds them:
    position 16h + 4t + 2a + b holds key 16h + 8a + 2t + b."""
    b, lk, h, d = vi.shape
    vt = torch.zeros(b, h, d, lk_pad, dtype=torch.int8, device=vi.device)
    vt[..., :lk] = vi.permute(0, 2, 3, 1)
    vt = vt.reshape(b, h, d, lk_pad // 32, 2, 2, 4, 2)  # (.., group, h, a, t, b)
    return vt.permute(0, 1, 2, 3, 4, 6, 5, 7).reshape(b, h, d, lk_pad).contiguous()


def flash_attention_int8_plain(q, k, v, *, pv_int8: bool = False,
                               block_k: Optional[int] = None) -> torch.Tensor:
    """The int8 kernel's function with its rounding points, walking the keys
    in tiles of block_k (None: the JAX kernel's default tiling; the kernel's
    own tile is INT8_BLOCK_K[D]).  Any head dim, as in JAX.
    q: (B, Lq, H, D); k, v: (B, Lk, H, D)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    bk = reference_block_k(lk, d, block_k)
    qi, sq = _quant_rows_int8(q_prescale(q))  # q carries scale*log2 e
    ki, sk = _quant_rows_int8(k)
    if pv_int8:
        vq, sv = _quant_channels_int8(v)
        sv = sv[:, :, None, :]
    else:
        vq = v
    heads = lambda x: x.permute(0, 2, 1, 3)  # noqa: E731  (B, L, H, D) -> (B, H, L, D)
    qd = heads(qi).double()
    m = torch.full((b, h, lq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, lq, d, dtype=torch.float32, device=q.device)
    for j0 in range(0, lk, bk):
        j1 = min(j0 + bk, lk)
        # int8 dot products in float64: exact, as the kernel's int32 sums.
        s_i = (qd @ heads(ki[:, j0:j1]).double().transpose(-1, -2)).float()
        s = s_i * sq[..., None] * sk[:, :, None, j0:j1]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        if pv_int8:
            p = torch.exp2(s - m_new + _LOG2_127)  # <= 127
            pv = (torch.round(p).double() @ heads(vq[:, j0:j1]).double()).float() * sv
        else:
            p = torch.exp2(s - m_new)
            pv = p.to(v.dtype).float() @ heads(vq[:, j0:j1]).float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)  # the unrounded p
        acc = acc * alpha + pv
        m = m_new
    return heads(acc / l).to(q.dtype)


def flash_attention_backward_plain(q, k, v, out, m, l, do, *,
                                   max_chunk_elems: int = 1 << 24,
                                   grad_dtype: Optional[torch.dtype] = None):
    """dq, dk, dv of softmax(q k^T / sqrt(D)) v from the forward's out and
    its partial statistics m (log2 domain) and l (flash_attention_partial),
    in fp32, returned in q, k and v's dtypes, or all three in grad_dtype
    (ring attention sums the blocks' shares in fp32).  Given the m, l and
    out of more keys than k holds (a ring's merged statistics), P and D_i
    are that whole softmax's, and the result is k's block's share:

        D_i = sum_d dO * O,  P = exp2(s' - m) / l with s' = q' k^T,
        dV = P^T dO,  dS = P * (dO V^T - D),
        dQ = dS K * scale,  dK = dS^T Q * scale  (natural units: the log2 e
        of s' cancels against d exp2 = ln 2 exp2).

    Walks (batch row, head group, query block) chunks of at most
    max_chunk_elems scores, so its fp32 transients stay near four times
    that many floats (256 MiB at the default) at any length."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    heads = max(1, min(h, max_chunk_elems // (lq * lk)))
    rows = lq if heads > 1 else max(1, min(lq, max_chunk_elems // lk))
    qs = q_prescale(q)
    delta = (do.float() * out.float()).sum(dim=-1)  # (B, Lq, H)
    dq, dk, dv = (torch.empty_like(x, dtype=grad_dtype) for x in (q, k, v))
    for bi in range(b):
        for h0 in range(0, h, heads):
            h1 = min(h, h0 + heads)
            kh = k[bi, :, h0:h1].float().transpose(0, 1)  # (hc, Lk, D)
            vh = v[bi, :, h0:h1].float().transpose(0, 1)
            dk_acc = torch.zeros_like(kh)
            dv_acc = torch.zeros_like(vh)
            for q0 in range(0, lq, rows):
                q1 = min(lq, q0 + rows)
                qc = qs[bi, q0:q1, h0:h1].float().transpose(0, 1)  # (hc, bq, D)
                p = torch.exp2(torch.bmm(qc, kh.transpose(1, 2))
                               .sub_(m[bi, h0:h1, q0:q1, None]))
                p.div_(l[bi, h0:h1, q0:q1, None])
                doc = do[bi, q0:q1, h0:h1].float().transpose(0, 1)
                dv_acc.baddbmm_(p.transpose(1, 2), doc)
                ds = torch.bmm(doc, vh.transpose(1, 2))
                ds.sub_(delta[bi, q0:q1, h0:h1].transpose(0, 1)[..., None]).mul_(p)
                del p
                dq[bi, q0:q1, h0:h1] = torch.bmm(ds, kh).mul_(scale).transpose(0, 1)
                qn = q[bi, q0:q1, h0:h1].float().transpose(0, 1)
                dk_acc.baddbmm_(ds.transpose(1, 2), qn, alpha=scale)
            dk[bi, :, h0:h1] = dk_acc.transpose(0, 1)
            dv[bi, :, h0:h1] = dv_acc.transpose(0, 1)
    return dq, dk, dv


def _requires_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def refuse_under_grad(route: str, *xs) -> None:
    """Raise when autograd would record `route` on xs: it has no gradient,
    and its output would be cut from the graph without a word."""
    if _requires_grad(*xs):
        raise RuntimeError(
            f"{route} has no gradient: under autograd, take flash_attention(bounded=False "
            f"or True, no int8) or attention(backend='auto' | 'pallas' | "
            f"'pallas_onlinemax' | 'xla'), or run it under torch.no_grad()")


class FlashAttentionFunction(torch.autograd.Function):
    """softmax(q k^T / sqrt(D)) v with a gradient: kernel 3 forward on CUDA
    tensors (its plain version on CPU ones), saving q, k, v, out, m and l;
    the plain chunked backward (flash_attention_backward_plain)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, m, l = flash_attention_partial(q, k, v)
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        return flash_attention_backward_plain(*ctx.saved_tensors, do)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .cuda_build import library

        lib = library("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.drt_flash_headroom.argtypes = [ptr] * 4 + [i32] * 5 + [f32, ptr]
        lib.drt_flash_headroom.restype = i32
        lib.drt_error_string.argtypes = [i32]
        lib.drt_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


_wgmma_handle: Optional[ctypes.CDLL] = None


def _lib_wgmma() -> ctypes.CDLL:
    global _wgmma_handle
    if _wgmma_handle is None:
        from .cuda_build import library

        lib = library("flash_attention_wgmma")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.drt_flash_wgmma_attention.argtypes = [ptr] * 6 + [i32] * 5 + [f32, f32, i32, ptr]
        lib.drt_flash_wgmma_attention.restype = i32
        lib.drt_flash_wgmma_bounded.argtypes = [ptr] * 5 + [i32] * 5 + [f32, i32, i32, ptr]
        lib.drt_flash_wgmma_bounded.restype = i32
        lib.drt_flash_wgmma_key_split.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
        lib.drt_flash_wgmma_key_split.restype = i32
        lib.drt_flash_wgmma_partial.argtypes = [ptr] * 6 + [i32] * 5 + [f32, i32, ptr]
        lib.drt_flash_wgmma_partial.restype = i32
        lib.drt_flash_wgmma_error_string.argtypes = [i32]
        lib.drt_flash_wgmma_error_string.restype = ctypes.c_char_p
        lib.drt_flash_wgmma_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.drt_flash_wgmma_occupancy.restype = i32
        lib.drt_flash_wgmma_block_k.argtypes = [i32]
        lib.drt_flash_wgmma_block_k.restype = i32
        for d, bk in WIDE_BLOCK_K.items():
            if lib.drt_flash_wgmma_block_k(d) != bk:
                raise RuntimeError(f"csrc/flash_attention_wgmma.cu's key tile at D={d} != "
                                   f"WIDE_BLOCK_K[{d}]")
        _wgmma_handle = lib
    return _wgmma_handle


_int8_handle: Optional[ctypes.CDLL] = None


def _lib_int8() -> ctypes.CDLL:
    global _int8_handle
    if _int8_handle is None:
        from .cuda_build import library

        lib = library("flash_attention_int8")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.drt_flash_attention_int8.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.drt_flash_attention_int8.restype = i32
        lib.drt_flash_int8_error_string.argtypes = [i32]
        lib.drt_flash_int8_error_string.restype = ctypes.c_char_p
        lib.drt_flash_int8_block_k.argtypes = [i32]
        lib.drt_flash_int8_block_k.restype = i32
        lib.drt_flash_int8_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.drt_flash_int8_occupancy.restype = i32
        for d, bk in INT8_BLOCK_K.items():
            if lib.drt_flash_int8_block_k(d) != bk:
                raise RuntimeError(f"csrc/flash_attention_int8.cu's key tile at D={d} != "
                                   f"INT8_BLOCK_K[{d}]")
        _int8_handle = lib
    return _int8_handle


def _check_kernel_inputs(q, k, v) -> None:
    refuse_under_grad("a flash attention launch", q, k, v)
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
        _check_tma_operand(name, x)
    b, lq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if lq < 1 or k.shape[1] < 1 or not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f"unsupported sizes q{tuple(q.shape)} k{tuple(k.shape)}")


def _check_tma_operand(name: str, x: torch.Tensor) -> None:
    """What a TMA tensor map needs of an operand the kernel reads through
    one: contiguous, the base 16-byte aligned, every stride but the last a
    multiple of 16 bytes."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if any(st * x.element_size() % 16 for st in x.stride()[:-1]):
        raise ValueError(f"{name}'s strides {x.stride()} are not multiples of 16 bytes")


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x itself when a kernel can read it (contiguous, 16-byte aligned),
    else a contiguous copy: what the public routes pass their launches."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().drt_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} (code {err})")


def _raise_on_wgmma(err: int, what: str) -> None:
    if err != 0:
        msg = _lib_wgmma().drt_flash_wgmma_error_string(err).decode()
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
            b, lq, k.shape[1], h, d, _q_scale_value(d, q.dtype),
            _stream(q.device))
    _raise_on(err, "flash_headroom")
    LAUNCHES["flash_attention_headroom"] += 1
    return stats


def flash_attention_kernel(q, k, v, stats: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch kernels 1 and 2 (one launch): stats (from flash_headroom) lets
    its blocks choose the branch on the device; None forces the online
    branch.  The wgmma kernel at every head dim (at D = 256 and 512 the
    wide-head body: two warpgroups splitting D over 64 query rows)."""
    _check_kernel_inputs(q, k, v)
    b, lq, h, d = q.shape
    if stats is not None and (stats.device != q.device or stats.dtype != torch.float32
                              or stats.numel() != 2 * b * h + 1):
        raise ValueError("stats must be flash_headroom's output for these inputs")
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), _tally(q.device).data_ptr(),
            b, lq, k.shape[1], h, d, _q_scale_value(d, q.dtype),
            math.log2(reference_lk_pad(k.shape[1], d)), int(stats is not None),
            _stream(q.device))
    with torch.cuda.device(q.device):
        _raise_on_wgmma(_lib_wgmma().drt_flash_wgmma_attention(*args), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def kernel_occupancy(kernel: str, d: int, pv_int8: bool = False) -> Dict[str, int]:
    """What the CUDA runtime reports for one kernel at head dim d: registers
    a thread, local (spill) bytes, dynamic shared bytes, resident blocks
    per SM and threads per block (and for kernels 3, 6 and 7 at D = 256,
    512 the 2-block clusters of the key split resident at once).  kernel:
    'attention' (the launch holding kernels 1 and 2), 'bounded_pipe'
    (kernel 6), 'bounded' (kernel 7), 'partial' (kernel 3), each at any
    head dim, or 'int8' (kernel 5, pv_int8 selecting its mode)."""
    out = (ctypes.c_int * 6)()
    wgmma_kernels = ("attention", "bounded_pipe", "bounded", "partial")
    if kernel in wgmma_kernels:
        lib = _lib_wgmma()
        which = wgmma_kernels.index(kernel)
        err = lib.drt_flash_wgmma_occupancy(which, d, out)
        why = lib.drt_flash_wgmma_error_string
    elif kernel == "int8":
        lib = _lib_int8()
        err, why = lib.drt_flash_int8_occupancy(d, int(pv_int8), out), lib.drt_flash_int8_error_string
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    if err != 0:
        raise RuntimeError(f"occupancy of {kernel} at D={d}: {why(err).decode()} (code {err})")
    occ = dict(zip(("registers", "spill_bytes", "dynamic_smem_bytes", "blocks_per_sm",
                    "threads_per_block"), out))
    if out[5]:
        occ["pair_clusters"] = out[5]
    return occ


def flash_attention_partial_kernel(q, k, v, *, key_split: Optional[bool] = None):
    """Launch kernel 3: (out, m, l) as flash_attention_partial_plain, on the
    wgmma body of kernel 2's online branch at every head dim, so unsplit its
    out is bitwise the unbounded flash_attention's.  key_split (D = 256,
    512): None splits the keys over 2-block clusters where partial_key_split
    says so, merging the halves with the online rescale; True or False
    forces it (True needs two key tiles or more)."""
    _check_kernel_inputs(q, k, v)
    b, lq, h, d = q.shape
    out = torch.empty_like(q)
    m = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = _lib_wgmma().drt_flash_wgmma_partial(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, lq, k.shape[1], h, d, _q_scale_value(d, q.dtype),
            -1 if key_split is None else int(key_split), _stream(q.device))
    _raise_on_wgmma(err, "flash_attention_partial")
    VARIANT_LAUNCHES["flash_attention_partial"] += 1
    return out, m, l


def flash_attention_bounded_kernel(q, k, v, mb: torch.Tensor, *, pipelined: bool,
                                   key_split: Optional[bool] = None) -> torch.Tensor:
    """Launch kernel 6 (pipelined) or 7 on the row bound mb (fp32 (B, H,
    Lq), from row_bound): the wgmma kernels at every head dim.  key_split
    (D = 256, 512): None splits the keys over 2-block clusters where
    bounded_key_split says so; True or False forces it (True needs two key
    tiles or more).  The two kernels take the same split for the same
    sizes, so they agree bit for bit."""
    _check_kernel_inputs(q, k, v)
    b, lq, h, d = q.shape
    if (mb.device != q.device or mb.dtype != torch.float32 or tuple(mb.shape) != (b, h, lq)
            or not mb.is_contiguous()):
        raise ValueError(f"mb must be a contiguous fp32 ({b}, {h}, {lq}) tensor on {q.device}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib_wgmma().drt_flash_wgmma_bounded(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), mb.data_ptr(),
            b, lq, k.shape[1], h, d, _q_scale_value(d, q.dtype), int(pipelined),
            -1 if key_split is None else int(key_split), _stream(q.device))
    _raise_on_wgmma(err, "flash_attention_bounded")
    VARIANT_LAUNCHES["flash_attention_bounded_pipe" if pipelined
                     else "flash_attention_bounded"] += 1
    return out


def _key_split(q, k, which: int) -> bool:
    b, lq, h, d = q.shape
    split = ctypes.c_int()
    with torch.cuda.device(q.device):
        err = _lib_wgmma().drt_flash_wgmma_key_split(b, lq, k.shape[1], h, d, which,
                                                     ctypes.byref(split))
    _raise_on_wgmma(err, "key_split")
    return bool(split.value)


def bounded_key_split(q, k, *, pipelined: bool = True) -> bool:
    """Whether kernel 6 (pipelined) or 7 splits the keys of these CUDA
    inputs over 2-block clusters by default: at D = 256 and 512, with two
    key tiles or more, where the B * H * ceil(Lq / 64) query tiles as pairs
    of half-length blocks take fewer waves on the card than whole blocks
    (the grid fits the card's resident pairs, or its last wave of whole
    blocks is less than half full)."""
    return _key_split(q, k, 1 if pipelined else 2)


def partial_key_split(q, k) -> bool:
    """Whether kernel 3 splits the keys of these CUDA inputs by default: the
    rule of bounded_key_split, on kernel 3's residency."""
    return _key_split(q, k, 3)


class Int8Operands(NamedTuple):
    """What the int8 kernel reads: int8 q (pre-scaled) and k (B, L, H, D)
    with fp32 row scales (B, H, L); V as bf16 (B, Lk, H, D), or with pv_int8
    as transposed int8 (B, H, D, lk_pad) with fp32 channel scales (B, H, D)."""

    qi: torch.Tensor
    ki: torch.Tensor
    v: torch.Tensor
    sq: torch.Tensor
    sk: torch.Tensor
    sv: Optional[torch.Tensor]
    lk_pad: int


def int8_operands(q, k, v, *, pv_int8: bool = False) -> Int8Operands:
    """The int8 kernel's pre-passes (plain torch, as JAX left them to XLA).
    The V channel scales reduce over all tokens, so they finish before the
    kernel starts.  Any strided view of (B, L, H, D) q, k, v."""
    q, k, v = _dense(q), _dense(k), _dense(v)
    _check_kernel_inputs(q, k, v)
    qi, sq = _quant_rows_int8(q_prescale(q))
    ki, sk = _quant_rows_int8(k)
    lk_pad = _round_up(k.shape[1], 64)  # a multiple of every key tile
    if not pv_int8:
        return Int8Operands(qi, ki, v, sq, sk, None, lk_pad)
    vi, sv = _quant_channels_int8(v)
    return Int8Operands(qi, ki, _transpose_v_int8(vi, lk_pad), sq, sk, sv, lk_pad)


def flash_attention_int8_launch(ops: Int8Operands) -> torch.Tensor:
    """One launch of the int8 kernel on pre-passed operands; returns the
    bf16 (B, Lq, H, D) output."""
    b, lq, h, d = ops.qi.shape
    for name in ("qi", "ki", "v"):
        _check_tma_operand(name, getattr(ops, name))
    out = torch.empty(b, lq, h, d, dtype=torch.bfloat16, device=ops.qi.device)
    with torch.cuda.device(ops.qi.device):
        err = _lib_int8().drt_flash_attention_int8(
            ops.qi.data_ptr(), ops.ki.data_ptr(), ops.v.data_ptr(), ops.sq.data_ptr(),
            ops.sk.data_ptr(), None if ops.sv is None else ops.sv.data_ptr(), out.data_ptr(),
            b, lq, ops.ki.shape[1], h, d, ops.lk_pad, int(ops.sv is not None),
            _stream(ops.qi.device))
    if err != 0:
        msg = _lib_int8().drt_flash_int8_error_string(err).decode()
        raise RuntimeError(f"flash_attention_int8 failed to launch: {msg} (code {err})")
    LAUNCHES["flash_attention_int8"] += 1
    return out


def flash_attention(q, k, v, block_q: Optional[int] = None, block_k: Optional[int] = None,
                    qk_int8: bool = False, pv_int8: bool = False, bounded: bool = False,
                    pipelined: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v, non-causal; q: (B, Lq, H, D), k, v:
    (B, Lk, H, D).  The JAX package's signature and defaults:

    bounded=True picks the no-shift branch when the headroom rule holds and
    the online softmax otherwise; bounded=False is the online softmax
    throughout.  qk_int8: int8 QK^T (per-token scales); pv_int8 adds int8 P
    and per-channel int8 V; as in JAX, qk_int8 = (qk_int8 or pv_int8) and
    not bounded, and bounded with pv_int8 is refused.  block_k sets the
    int8 plain version's key tile (the int8 result depends on it); the CUDA
    kernels use their own tiles, and a CUDA call refuses another block_k in
    int8 mode.  block_q never changes the result (rows are independent).
    bounded with pipelined is the bounded softmax shifted by the per-row
    bound (row_bound), with the score tile carried one key tile ahead;
    pipelined alone is ignored, as in JAX.

    Under autograd (grad enabled, q, k or v requiring grad) the call is
    FlashAttentionFunction whatever `bounded` says; the int8 and the
    pipelined bounded modes have no gradient and raise there."""
    if bounded and pv_int8:
        raise ValueError("bounded mode does not compose with int8 (int8 P needs a tight max)")
    int8 = (qk_int8 or pv_int8) and not bounded
    if _requires_grad(q, k, v):
        if int8:
            refuse_under_grad("int8 flash attention (qk_int8 / pv_int8)", q, k, v)
        if bounded and pipelined:
            refuse_under_grad("flash_attention(bounded=True, pipelined=True)", q, k, v)
        return FlashAttentionFunction.apply(q, k, v)
    if q.device.type == "cpu":
        if int8:
            return flash_attention_int8_plain(q, k, v, pv_int8=pv_int8, block_k=block_k)
        if bounded and pipelined:
            return flash_attention_bounded_plain(q, k, v)
        return flash_attention_plain(q, k, v, bounded=bounded)
    q, k, v = _dense(q), _dense(k), _dense(v)
    if bounded and pipelined:
        return flash_attention_bounded_kernel(q, k, v, row_bound(q, k), pipelined=True)
    if int8:
        tile = INT8_BLOCK_K.get(q.shape[-1])
        if block_k not in (None, tile):
            raise ValueError(f"the int8 kernel walks keys in tiles of {tile} at head dim "
                             f"{q.shape[-1]}, not block_k={block_k}")
        return flash_attention_int8_launch(int8_operands(q, k, v, pv_int8=pv_int8))
    stats = flash_headroom(q, k, v) if bounded else None
    return flash_attention_kernel(q, k, v, stats)


def flash_attention_bounded_shift(q, k, v) -> torch.Tensor:
    """The bounded softmax without the carried score tile (JAX's
    _flash_kernel_bounded, which no JAX code path calls): the same function
    as flash_attention(bounded=True, pipelined=True).  Plain version for CPU
    tensors, kernel 7 for CUDA tensors.  No gradient: raises under autograd."""
    refuse_under_grad("flash_attention_bounded_shift", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bounded_plain(q, k, v)
    q, k, v = _dense(q), _dense(k), _dense(v)
    return flash_attention_bounded_kernel(q, k, v, row_bound(q, k), pipelined=False)


def flash_attention_partial(q, k, v, block_q: Optional[int] = None,
                            block_k: Optional[int] = None):
    """Flash attention returning per-shard softmax statistics (JAX's
    flash_attention_partial): (out, m, l) with out (B, Lq, H, D) normalized
    over these keys, and fp32 (B, H, Lq) m, the running max in the log2
    domain (q pre-scaled by softmax_scale * log2 e), and l, the normalizer.
    Shards merge exactly with o = out * l and an exp2 online-softmax combine
    (parallel/ring_attention.py).  Plain version for CPU tensors, kernel 3
    for CUDA tensors; block_q and block_k leave the result unchanged.
    Raises under autograd (m and l have no gradient):
    FlashAttentionFunction differentiates its output, and
    parallel/ring_attention.RingAttentionFunction a ring of its calls."""
    refuse_under_grad("flash_attention_partial", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_partial_plain(q, k, v)
    return flash_attention_partial_kernel(_dense(q), _dense(k), _dense(v))
