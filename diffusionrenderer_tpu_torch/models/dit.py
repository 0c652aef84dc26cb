"""GeneralDIT, the 7B video diffusion transformer, in PyTorch.

Counterpart of diffusionrenderer_tpu/models/dit.py.  Parameters are a plain
nested dict of tensors in PyTorch's (out, in) weight layout; the 28 blocks
are a list walked by a Python loop (the JAX package stacks them for
`lax.scan`).  Kept from the JAX package:

* FA -> CA -> MLP block order, each sub-block AdaLN(shift, scale, gate) ->
  LayerNorm -> modulate -> body -> x + gate * out;
* the exact single-KV cross-attention collapse (the context is always one
  token: a context-table row, or zeros);
* erf GELU; rope cos/sin cast to the activation dtype;
* a learned context embedding for the inverse renderer, a zero context for
  the forward renderer;
* fp32 AdaLN, RMSNorm and LayerNorm statistics; matmuls in the weights'
  dtype with fp32 accumulation.

Every block matmul goes through models/quant.dense_maybe_quantized, so a
block's dict may hold int8 leaves (weight-only or W8A8, per channel or per
group); a '_mixN' list mixes bf16 and quantized blocks.  `capture` is the
calibration hook (models/calibrate.py): it sees the input of every
quantization site (models/quant.LEAF_SITE) as the block runs.

Under a (data, seq, tensor) mesh (parallel/sharding.py) `dit_forward`
runs on this rank's batch rows and keeps its L/seq token slice from the
patch embedding to the final layer.  Self-attention communicates over seq
(all-gather KV or ring attention), the final layer's output is gathered
over seq before unpatchify, and under tensor parallelism each block runs
its num_heads / tensor heads and its slice of the MLP, with Megatron's
conjugate pair around the sharded matmuls: a column-parallel input's
gradient is summed over tensor (identity forward), a row-parallel output
is summed over tensor (identity backward).  The one-token cross-attention
is sharded the same way.  `make_block_apply` is the block as a function of
explicit inputs, which `block_executor` (GPipe,
parallel/pipeline_parallel.py) schedules.

`dit_forward` is differentiable with respect to the parameter dict (the
trainer, training/train.py), on one device and under a mesh or an
executor: no op on its path writes a leaf in place or detaches, the flash
attention takes its gradient through
ops/flash_attention.FlashAttentionFunction, and the collectives carry their
gradients.  Quantized leaves raise under autograd, and so does ring
attention (the gradient of kernel 3's m and l is not ported, ROADMAP.md).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

from ..config import DiTConfig
from ..ops.attention import attention
from ..ops.norms import adaln_modulation, layer_norm_no_affine, modulate, rms_norm
from ..ops.patch import patch_embed, unpatchify
from ..ops.rope import apply_rope, rope_3d_angles
from ..ops.timestep import timestep_embedding
from ..parallel.collectives import grad_all_reduce, group_size
from ..utils.tree import leaves
from .quant import dense_maybe_quantized as _dense
from .quant import is_quantized

Params = Dict[str, Any]
# capture(site, tensor): sees each quantization site's input (LEAF_SITE names).
Capture = Optional[Callable[[str, torch.Tensor], None]]
# An ops.attention backend name, or a callable (q, k, v) -> o such as the
# sequence-parallel attention of parallel/flash_sp.make_sp_attention.
AttnBackend = Union[str, Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]]


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_dit_params(cfg: DiTConfig, *, device, dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, scale: float = 0.02,
                    block_fn: Optional[Callable[[Params], Params]] = None) -> Params:
    """Random-normal weights with the checkpoint's shapes, drawn on `device`
    from a seeded torch.Generator (so a full-size model is built where it
    runs, with no host copy).  device='meta' gives the shapes only.
    block_fn, if given, replaces each block's dict as soon as it is drawn
    (load_pipeline quantizes there, so the whole model never sits on the
    device in both precisions); the draws do not depend on it."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
    d, dh, r = cfg.model_channels, cfg.head_dim, cfg.adaln_lora_dim
    hid, ctx = cfg.hidden_dim, cfg.crossattn_emb_channels

    def w(*shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    def adaln():
        return {"adaln_w1": w(r, d), "adaln_w2": w(3 * d, r)}

    blocks = []
    for _ in range(cfg.num_blocks):
        bp = {
            "fa": {**adaln(), "wq": w(d, d), "wk": w(d, d), "wv": w(d, d),
                   "wo": w(d, d), "q_norm": ones(dh), "k_norm": ones(dh)},
            "ca": {**adaln(), "wq": w(d, d), "wk": w(d, ctx), "wv": w(d, ctx),
                   "wo": w(d, d), "q_norm": ones(dh), "k_norm": ones(dh)},
            "mlp": {**adaln(), "w1": w(hid, d), "w2": w(d, hid)},
        }
        blocks.append(bp if block_fn is None else block_fn(bp))
    out_dim = cfg.patch_spatial ** 2 * cfg.patch_temporal * cfg.out_channels
    params: Params = {
        "x_embedder": {"weight": w(d, cfg.patch_dim)},
        "t_embedder": {"w1": w(d, d), "w2": w(3 * d, d)},
        "affline_norm": {"weight": ones(d)},
        "blocks": blocks,
        "final": {"adaln_w1": w(r, d), "adaln_w2": w(2 * d, r),
                  "linear": w(out_dim, d)},
    }
    if cfg.patch_embed_bias:
        params["x_embedder"]["bias"] = torch.zeros(d, device=dev, dtype=dtype)
    if cfg.use_context_embedding:
        params["context_embedding"] = {"weight": w(cfg.num_context_embeddings, ctx)}
    return params


def dit_param_count(cfg: DiTConfig) -> int:
    """Analytic parameter count (~7.16B for FADITV2_7B)."""
    d, r, hid, ctx = (cfg.model_channels, cfg.adaln_lora_dim, cfg.hidden_dim,
                      cfg.crossattn_emb_channels)
    dh = cfg.head_dim
    per_adaln = d * r + r * 3 * d
    fa = per_adaln + 4 * d * d + 2 * dh
    ca = per_adaln + 2 * d * d + 2 * ctx * d + 2 * dh
    mlp = per_adaln + 2 * d * hid
    stem = cfg.patch_dim * d + d * d + d * 3 * d + d
    final = d * r + r * 2 * d + d * (cfg.patch_spatial ** 2 * cfg.patch_temporal
                                     * cfg.out_channels)
    ctx_emb = cfg.num_context_embeddings * ctx if cfg.use_context_embedding else 0
    return cfg.num_blocks * (fa + ca + mlp) + stem + final + ctx_emb


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _adaln_chunks(emb, lora, bp, dtype, n_chunks=3):
    """(shift, scale, gate) of one sub-block, in the activation dtype."""
    mod = adaln_modulation(emb, bp["adaln_w1"], bp["adaln_w2"], lora)
    return [c.to(dtype) for c in mod.chunk(n_chunks, dim=-1)]


def _adaln(x, emb, lora, bp):
    """((shift, scale, gate), modulated x) of one sub-block."""
    chunks = _adaln_chunks(emb, lora, bp, x.dtype)
    return chunks, modulate(layer_norm_no_affine(x), chunks[0], chunks[1])


def _column_input(x, tensor_group):
    """A replicated activation entering column-parallel matmuls: its
    gradient is summed over the tensor group (Megatron's f)."""
    return x if tensor_group is None else grad_all_reduce(x, tensor_group)


def _head_shared(w, tensor_group):
    """A per-head norm scale, shared by every head a tensor rank splits: its
    gradient is summed over the tensor group, in fp32 (rms_norm reads it in
    fp32, so each rank's partial sum is still fp32 there; rounding the
    partials first would lose what their sum cancels)."""
    return w if tensor_group is None else grad_all_reduce(w.float(), tensor_group)


def _row_output(x, w, tensor_group):
    """x @ w^T of a row-parallel weight, summed over the tensor group
    (Megatron's g; models/quant.dense_maybe_quantized: the sums in fp32, a
    W8A8 leaf's tokens quantized with their max over the whole K)."""
    return _dense(x, w, row_group=tensor_group)


def _self_attention_block(x, emb, lora, bp, cos, sin, head_dim: int,
                          attn_backend: AttnBackend, capture: Capture = None,
                          tensor_group=None) -> torch.Tensor:
    (_, _, gate), xm = _adaln(x, emb, lora, bp)
    b, l, _ = xm.shape
    if capture is not None:
        capture("fa.qkv", xm)
    xm = _column_input(xm, tensor_group)
    # This rank's heads: all of them, or num_heads / tensor under a mesh.
    q = _dense(xm, bp["wq"]).reshape(b, l, -1, head_dim)
    k = _dense(xm, bp["wk"]).reshape(b, l, -1, head_dim)
    v = _dense(xm, bp["wv"]).reshape(b, l, -1, head_dim)
    # Per-head q/k RMSNorm, identity on v (the "RRI" scheme).  The norm
    # weights are shared by every head, so under tensor parallelism each
    # rank's gradient of them is a partial sum over its heads.
    q = apply_rope(rms_norm(q, _head_shared(bp["q_norm"], tensor_group)), cos, sin)
    k = apply_rope(rms_norm(k, _head_shared(bp["k_norm"], tensor_group)), cos, sin)
    if callable(attn_backend):  # sequence-parallel attention over the mesh
        o = attn_backend(q, k, v)
    else:
        o = attention(q, k, v, backend=attn_backend)
    o = o.reshape(b, l, -1)
    if capture is not None:
        capture("fa.wo", o)
    return x + gate[:, None, :] * _row_output(o, bp["wo"], tensor_group)


def _cross_attention_block(x, emb, lora, bp, context, capture: Capture = None,
                           tensor_group=None) -> torch.Tensor:
    """Cross-attention over the one-token context: softmax over a single key
    is 1, so the output is W_o W_v context for every query (q, k and their
    norms drop out exactly, and so does the modulated x; see
    ops/attention.cross_attention_single_kv)."""
    gate = _adaln_chunks(emb, lora, bp, x.dtype)[2]
    if capture is not None:
        capture("ca.wv", context)
    v = _dense(_column_input(context, tensor_group), bp["wv"])  # (B, 1, D / tensor)
    if capture is not None:
        capture("ca.wo", v)
    return x + gate[:, None, :] * _row_output(v, bp["wo"], tensor_group)


def _mlp_block(x, emb, lora, bp, capture: Capture = None, token_chunks: int = 1,
               tensor_group=None) -> torch.Tensor:
    """token_chunks > 1 (dividing L) runs the MLP on that many token chunks
    in turn, bounding the (L, 4D) hidden activation; each token's MLP is
    independent, so the result is the same.  As in JAX, the chunked MLP
    reports no 'mlp.w2' capture site."""
    (_, _, gate), xm = _adaln(x, emb, lora, bp)
    if capture is not None:
        capture("mlp.w1", xm)
    xm = _column_input(xm, tensor_group)

    def ff(xc, site):
        h = F.gelu(_dense(xc, bp["w1"]), approximate="none")  # erf form
        if site is not None:
            site("mlp.w2", h)
        return _row_output(h, bp["w2"], tensor_group)

    l = xm.shape[1]
    if token_chunks > 1 and l % token_chunks == 0:
        o = torch.cat([ff(xc, None) for xc in xm.chunk(token_chunks, dim=1)], dim=1)
    else:
        o = ff(xm, capture)
    return x + gate[:, None, :] * o


def block_apply(bp: Params, x, emb, lora, context, cos, sin, cfg: DiTConfig,
                attn_backend: AttnBackend = "auto", capture: Capture = None,
                mlp_token_chunks: int = 1, tensor_group=None) -> torch.Tensor:
    """One FA -> CA -> MLP block.  tensor_group: the mesh's tensor group when
    bp holds this rank's Megatron shards (parallel/sharding.py)."""
    x = _self_attention_block(x, emb, lora, bp["fa"], cos, sin, cfg.head_dim, attn_backend,
                              capture, tensor_group)
    x = _cross_attention_block(x, emb, lora, bp["ca"], context, capture, tensor_group)
    return _mlp_block(x, emb, lora, bp["mlp"], capture, mlp_token_chunks, tensor_group)


def make_block_apply(cfg: DiTConfig, attn_backend: AttnBackend = "auto",
                     mlp_token_chunks: int = 1, capture_sites: bool = False, *,
                     tensor_group=None):
    """One FA-CA-MLP block as a function of explicit inputs, the unit the
    pipeline-parallel executor (parallel/pipeline_parallel.py) schedules:

        apply(bp, x, emb, lora, context, cos, sin) -> x'

    With capture_sites it returns (x', sites), sites mapping the calibration
    site names of models/quant.LEAF_SITE to the dense inputs this block saw.
    tensor_group: as block_apply's."""

    def apply(bp, x, emb, lora, context, cos, sin):
        sites: Optional[Dict[str, torch.Tensor]] = {} if capture_sites else None
        y = block_apply(bp, x, emb, lora, context, cos, sin, cfg, attn_backend,
                        None if sites is None else sites.__setitem__, mlp_token_chunks,
                        tensor_group)
        return (y, sites) if capture_sites else y

    return apply


def _is_segmented(blocks) -> bool:
    """Whether the blocks mix precisions ('_mixN': some leaves int8 in some
    blocks only), the JAX package's tuple of stacked segments."""
    kinds = {tuple(is_quantized(w) for sp in bp.values() for w in sp.values())
             for bp in blocks if bp is not None}
    return len(kinds) > 1


# Leaves the forward reads only in fp32 (ops/norms: the RMSNorm scales and
# the AdaLN MLPs): each rank's gradient of them is fp32 until it reaches the
# leaf, so it is summed over the ranks in fp32 and rounded once.
_READ_IN_FP32 = ("adaln_w1", "adaln_w2", "q_norm", "k_norm")


def _sum_grads_over(params: Params, group) -> Params:
    """params whose gradients are summed over `group` (the ranks that hold
    the same shard and each compute on their own rows or tokens)."""
    if group_size(group) == 1:
        return params

    def sync(t, fp32: bool):
        if t is None or not t.requires_grad:
            return t
        return grad_all_reduce(t.float() if fp32 else t, group)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return sync(tree, key in _READ_IN_FP32)

    out = walk(params)
    out["affline_norm"] = {"weight": sync(params["affline_norm"]["weight"], True)}
    return out


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def dit_forward(
    params: Params,
    x: torch.Tensor,
    sigma: torch.Tensor,
    latent_condition: torch.Tensor,
    context_index: Optional[torch.Tensor],
    cfg: DiTConfig,
    *,
    attn_backend: AttnBackend = "auto",
    seq_sharding_constraint=None,
    mesh=None,
    mlp_token_chunks: int = 1,
    block_executor=None,
    capture: Optional[Callable[[int, str, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """One denoiser evaluation F(x; sigma, condition).

    x: (B, T, H, W, C_in) channels-last, already c_in-scaled; sigma: (B,)
    raw noise levels; latent_condition: (B, T, H, W, C_cond);
    context_index: (B,) G-buffer selector (used when the config has a
    context embedding); attn_backend: an ops.attention backend, a callable
    (q, k, v) -> o, or, with a mesh, 'flash_sp' / 'ring' (see
    _mesh_attention for the rules under a mesh).

    Multi-device, on a parallel.sharding mesh whose tensor-parallel ranks
    hold their shard of the blocks (shard_params):
    * seq_sharding_constraint=parallel.token_sharding_constraint(mesh): the
      inputs and the result are the whole batch, as in JAX; each rank runs
      its B/data rows (B must divide) and its L/seq tokens;
    * mesh=...: the inputs are this rank's batch rows already, and so is
      the result (the pipeline's form); every token on every rank;
    * block_executor: a callable that runs the blocks
      (parallel/pipeline_parallel.make_pp_executor), on its own mesh.
    Under autograd each rank's parameter gradients come out whole: the
    collectives carry their gradients (parallel/collectives.py) and each
    parameter's gradient is summed over the ranks that hold it.

    mlp_token_chunks: the MLP's token chunks (_mlp_block); capture(block,
    site, tensor): the calibration hook.  Returns (B, T, H, W, C_out) in
    x's dtype."""
    b_in, t, h, w, _ = x.shape
    d = cfg.model_channels
    dtype = x.dtype
    if seq_sharding_constraint is not None:
        c_mesh = getattr(seq_sharding_constraint, "mesh", None)
        if c_mesh is None:
            raise TypeError("seq_sharding_constraint takes parallel.token_sharding_constraint(mesh)")
        if mesh is not None and mesh is not c_mesh:
            raise ValueError("mesh and seq_sharding_constraint name different meshes")
        mesh = c_mesh
    if block_executor is not None and mesh is not None:
        raise ValueError("block_executor runs on its own (data, pipe) mesh: it does not take "
                         "a (data, seq, tensor) mesh or seq_sharding_constraint as well")
    tensor_group = None
    if mesh is not None:
        from ..parallel.sharding import batch_slice, gather_batch, gather_tokens, token_slice

        if seq_sharding_constraint is not None:  # the whole batch in: keep this rank's rows
            if mesh.data > 1 and b_in % mesh.data:
                raise ValueError(f"batch {b_in} does not split over data={mesh.data}")
            x, sigma, latent_condition = (batch_slice(a, mesh) for a in
                                          (x, sigma, latent_condition))
            if context_index is not None:
                context_index = batch_slice(context_index.reshape(b_in), mesh)
        if mesh.tensor > 1:
            tensor_group = mesh.tensor_group
        if torch.is_grad_enabled() and any(p.requires_grad for p in leaves(params)
                                           if p is not None):
            params = _sum_grads_over(params, mesh.replica_group)
    b = x.shape[0]

    # Main embedding: the raw sinusoid; the MLP output is the shared lora.
    t_emb, lora = timestep_embedding(sigma.to(dtype), params["t_embedder"]["w1"],
                                     params["t_embedder"]["w2"], d)
    affline_emb = rms_norm(t_emb, params["affline_norm"]["weight"])

    if cfg.use_context_embedding:
        table = params["context_embedding"]["weight"]
        idx = context_index.reshape(b).to(device=table.device, dtype=torch.long)
        context = table[idx][:, None, :].to(dtype)
    else:
        context = torch.zeros(b, 1, cfg.crossattn_emb_channels, dtype=dtype,
                              device=x.device)

    parts = [x, latent_condition.to(dtype)]
    if cfg.concat_padding_mask:
        parts.append(torch.ones(b, t, h, w, 1, dtype=dtype, device=x.device))
    xe = params["x_embedder"]
    patches = patch_embed(torch.cat(parts, dim=-1), xe["weight"], xe.get("bias"),
                          cfg.patch_spatial, cfg.patch_temporal)
    _, tp, hp, wp, _ = patches.shape
    tokens = patches.reshape(b, tp * hp * wp, d)

    angles = rope_3d_angles(
        tp, hp, wp, cfg.head_dim,
        h_ntk_factor=cfg.rope_h_extrapolation_ratio,
        w_ntk_factor=cfg.rope_w_extrapolation_ratio,
        t_ntk_factor=cfg.rope_t_extrapolation_ratio,
        device=x.device,
    )
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mesh is not None:  # this rank's tokens, and their rope rows
        attn_backend = _mesh_attention(mesh, attn_backend, x.is_cuda)
        tokens = token_slice(tokens, mesh)
        cos, sin = token_slice(cos, mesh, dim=0), token_slice(sin, mesh, dim=0)

    if block_executor is not None:
        if _is_segmented(params["blocks"]):
            raise ValueError("block_executor (pipeline parallelism) does not support '_mixN' "
                             "segmented blocks: use a uniform quant mode there")
        tokens = block_executor(params["blocks"], tokens, affline_emb, lora, context, cos, sin,
                                make_block_apply(cfg, attn_backend, mlp_token_chunks))
    else:
        for i, bp in enumerate(params["blocks"]):
            hook = None if capture is None else functools.partial(capture, i)
            tokens = block_apply(bp, tokens, affline_emb, lora, context, cos, sin, cfg,
                                 attn_backend, hook, mlp_token_chunks, tensor_group)

    # Final layer: 2-chunk AdaLN on the first 2D slice of the shared lora.
    fin = params["final"]
    mod = adaln_modulation(affline_emb, fin["adaln_w1"], fin["adaln_w2"],
                           lora[:, : 2 * d])
    shift, scale = [c.to(dtype) for c in mod.chunk(2, dim=-1)]
    out = F.linear(modulate(layer_norm_no_affine(tokens), shift, scale), fin["linear"])
    if mesh is not None:
        out = gather_tokens(out, mesh)
        if seq_sharding_constraint is not None:
            out = gather_batch(out, mesh, b_in)
    return unpatchify(out, tp, hp, wp, cfg.patch_spatial, cfg.patch_temporal,
                      cfg.out_channels)


def _mesh_attention(mesh, backend: AttnBackend, on_cuda: bool) -> AttnBackend:
    """The self-attention under a mesh (the JAX package's rules, dit.py:
    398-419): 'flash_sp' and 'ring' take parallel/flash_sp.make_sp_attention
    with impl 'flash' (all-gather KV, online-softmax flash kernel) or 'ring';
    'auto' takes 'flash' for CUDA tensors and the plain attention otherwise
    (the token count always divides: token_slice refuses one that does not);
    a callable is used as it is; with seq > 1 any other backend name runs on
    the all-gathered KV."""
    from ..parallel.flash_sp import make_gathered_attention, make_sp_attention

    if callable(backend):
        return backend
    if backend in ("flash_sp", "ring"):
        return make_sp_attention(mesh, impl="ring" if backend == "ring" else "flash")
    if backend == "auto":
        if on_cuda:
            return make_sp_attention(mesh, impl="flash")
        backend = "xla"
    return make_gathered_attention(mesh, backend) if mesh.seq > 1 else backend
