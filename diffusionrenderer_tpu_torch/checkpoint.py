"""Checkpoint I/O for the DiT, and weights carried over from the JAX
package's parameter trees.

The reference checkpoint (counterpart of diffusionrenderer_tpu/checkpoint.py)
is a torch state dict of CleanDiffusionRendererModel, `.pt` or
`.safetensors`, with names such as

    net.x_embedder.proj.1.weight                 (D, patch_dim)
    net.t_embedder.1.linear_{1,2}.weight         (D, D), (3D, D)
    net.affline_norm.weight                      (D,)
    net.context_embedding.weight                 (16, 1024)   [inverse only]
    net.blocks.block{i}.blocks.{j}.adaLN_modulation.{1,2}.weight
    net.blocks.block{i}.blocks.{0|1}.block.attn.to_{q,k,v}.0.weight
    net.blocks.block{i}.blocks.{0|1}.block.attn.to_{q,k}.1.weight   (head_dim,)
    net.blocks.block{i}.blocks.{0|1}.block.attn.to_out.0.weight
    net.blocks.block{i}.blocks.2.block.layer{1,2}.weight
    net.final_layer.adaLN_modulation.{1,2}.weight, net.final_layer.linear.weight
    logvar.*, net.pos_embedder.seq               [read and discarded]

Blocks j = 0, 1, 2 are the port's 'fa', 'ca' and 'mlp'.  Its Linear
weights are already (out, in), the port's layout, so nothing is
transposed.  `convert_dit_state_dict` is strict both ways, with the JAX
package's messages: a missing key raises KeyError, an unconsumed one
ValueError, both before any weight is moved.  It streams: each tensor is
read from the (memory-mapped) file and copied to the device on its own,
block by block, and with quantize_int8 each block is quantized on the
device as it arrives (models/quant.quantize_block), so neither the host nor
the device ever holds a second copy of the model.

The port's native format is one flat safetensors file of its own parameter
tree ('/'-joined keys, int8 codes and fp32 scales as they are), read and
written by utils/safetensors.py.  The JAX package's native format, an
orbax directory, is n/a on CUDA (orbax does not run there): such a
directory raises an error that names the reference-format route.

`dit_params_from_numpy` and `vae_params_from_numpy` take the nested dicts
(and lists) of numpy arrays that the JAX package's `init_dit_params` /
`init_vae_params` produce after `jax.device_get`, and return the port's
parameter dicts, doing every layout change here:

* DiT: blocks stacked on a leading axis (nb, ...) become a list of
  per-block dicts; dense weights (in, out) become (out, in); the context
  embedding table keeps its (num, C_ctx) layout.  Quantized leaves (the
  trees of the JAX package's quantize_dit_params): codes 'q' (K, N) int8
  become (N, K) int8, the (out, in) layout that is also the K-contiguous B
  operand of the int8 matmul kernel; scales 's' / 'sa' ((N,) or (G, N))
  and the 'hs' / 'di' input transforms (K,) keep their layout and fp32;
* VAE: conv weights (kt, kh, kw, Cin, Cout) become (Cout, Cin, kt, kh, kw);
  dense weights (in, out) become (out, in).

Both are strict: a missing leaf, an extra leaf or a wrong shape raises.
`train_state_from_numpy` carries a JAX TrainState over (params, then
optax adamw's ScaleByAdamState(count, mu, nu)), mapping the params and
both moments as DiT trees; JAX's gradients map the same way.
The expected structure is the port's own random init built on the 'meta'
device, so the two trees cannot drift apart silently.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import DiTConfig, VAEConfig
from .models.dit import init_dit_params
from .models.quant import QUANTIZED_BLOCK_WEIGHTS, is_quantized, quantize_block, quantize_tensor
from .models.vae import init_vae_params
from .utils.device import DeviceLike, resolve_device
from .utils.safetensors import SafetensorsFile, read_header, write_safetensors
from .utils.tree import flatten as _flatten

if TYPE_CHECKING:
    from .training.train import TrainState

Params = Dict[str, Any]


def _fill(expected: Any, leaves: Dict[str, np.ndarray],
          convert: Callable[[str, np.ndarray], np.ndarray],
          device, dtype: Optional[torch.dtype], prefix: str = "") -> Any:
    """Rebuild `expected`'s structure from `leaves`, popping each leaf used."""
    if isinstance(expected, dict):
        return {k: _fill(v, leaves, convert, device, dtype, f"{prefix}/{k}" if prefix else k)
                for k, v in expected.items()}
    if isinstance(expected, list):
        return [_fill(v, leaves, convert, device, dtype, f"{prefix}/{i}")
                for i, v in enumerate(expected)]
    if prefix not in leaves:
        raise KeyError(f"missing parameter leaf {prefix!r}")
    arr = convert(prefix, np.asarray(leaves.pop(prefix)))
    if tuple(arr.shape) != tuple(expected.shape):
        raise ValueError(f"leaf {prefix!r} has shape {tuple(arr.shape)} after "
                         f"conversion, expected {tuple(expected.shape)}")
    t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    keep = dtype is None or not t.is_floating_point() or _is_quant_scale(prefix)
    return t.to(device=device, dtype=t.dtype if keep else dtype)


_QUANT_SCALES = ("s", "sa", "hs", "di")


def _is_quant_scale(key: str) -> bool:
    """Scales and transforms of a quantized leaf: they keep fp32."""
    return key.rsplit("/", 1)[-1] in _QUANT_SCALES


def _check_consumed(leaves: Dict[str, Any]) -> None:
    if leaves:
        raise KeyError(f"unexpected parameter leaves: {sorted(leaves)}")


def dit_params_from_numpy(tree: Dict[str, Any], cfg: DiTConfig, *,
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX DiT pytree (numpy leaves) -> the port's DiT parameters, on
    CUDA unless `device` says otherwise."""
    device = resolve_device(device)
    leaves = {}
    for key, arr in _flatten(tree).items():
        if key.startswith("blocks/"):
            arr = np.asarray(arr)
            if arr.shape[0] != cfg.num_blocks:
                raise ValueError(f"stacked leaf {key!r} has {arr.shape[0]} blocks, "
                                 f"expected {cfg.num_blocks}")
            sub = key[len("blocks/"):]
            for i in range(cfg.num_blocks):
                leaves[f"blocks/{i}/{sub}"] = arr[i]
        else:
            leaves[key] = arr

    def convert(key: str, arr: np.ndarray) -> np.ndarray:
        if arr.ndim == 2 and key != "context_embedding/weight" and not _is_quant_scale(key):
            return arr.T  # (in, out) -> (out, in), int8 codes included
        return arr

    expected = _expected_dit_tree(cfg, leaves)
    params = _fill(expected, leaves, convert, device, dtype)
    _check_consumed(leaves)
    return params


def _adam_state(opt_state: Any) -> Any:
    """The first node of an optax state with count, mu and nu (adamw's
    ScaleByAdamState, first in its chain)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_numpy(state: Any, cfg: DiTConfig, *, device: DeviceLike = None,
                           dtype: Optional[torch.dtype] = None) -> TrainState:
    """A JAX TrainState(params, opt_state, step) with numpy leaves (after
    jax.device_get) -> the port's TrainState on CUDA unless `device` says
    otherwise: the params and optax's first and second moments through
    dit_params_from_numpy, the Adam count and the step as ints."""
    from .training.train import AdamState, TrainState  # the I/O layer imports no trainer

    params, opt_state, step = state
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam state (count, mu, nu)")

    def tree(t):
        return dit_params_from_numpy(t, cfg, device=device, dtype=dtype)

    return TrainState(tree(params), AdamState(int(np.asarray(adam.count)), tree(adam.mu),
                                              tree(adam.nu)), int(np.asarray(step)))


def _expected_dit_tree(cfg: DiTConfig, leaves: Dict[str, Any]) -> Dict[str, Any]:
    """The port's own 'meta' init, with every block matmul that arrives
    quantized replaced by the port's quantize_tensor of it, under the
    options its leaves show: 'sa' (W8A8) or 's', grouped scales (G, N),
    'hs' (Hadamard), 'di' (migration)."""
    expected = init_dit_params(cfg, device="meta", dtype=torch.float32)
    for i, bp in enumerate(expected["blocks"]):
        for sub, names in QUANTIZED_BLOCK_WEIGHTS.items():
            for name in names:
                key = f"blocks/{i}/{sub}/{name}"
                if f"{key}/q" not in leaves:
                    continue
                w = bp[sub][name]
                scale = leaves.get(f"{key}/sa", leaves.get(f"{key}/s"))
                grouped = scale is not None and np.ndim(scale) == 2
                bp[sub][name] = quantize_tensor(
                    w, act_quant=f"{key}/sa" in leaves,
                    group_size=w.shape[1] // np.shape(scale)[0] if grouped else None,
                    hadamard=f"{key}/hs" in leaves,
                    migrate=(torch.ones(w.shape[1], device="meta")
                             if f"{key}/di" in leaves else None))
    return expected


def vae_params_from_numpy(tree: Dict[str, Any], cfg: VAEConfig, *,
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX VAE pytree (numpy leaves) -> the port's VAE parameters, on
    CUDA unless `device` says otherwise.  Norm scales/biases and latent
    statistics keep their (fp32) dtype."""
    device = resolve_device(device)
    leaves = _flatten(tree)

    def convert(key: str, arr: np.ndarray) -> np.ndarray:
        if arr.ndim == 5:
            return arr.transpose(4, 3, 0, 1, 2)  # DHWIO -> (Cout, Cin, kt, kh, kw)
        if arr.ndim == 2 and not key.startswith("latents_"):
            return arr.T  # (in, out) -> (out, in)
        return arr

    expected = init_vae_params(cfg, device="meta", dtype=torch.float32)
    params = _fill(expected, leaves, convert, device, None)
    _check_consumed(leaves)
    if dtype is not None:
        params = _cast_weights(params, dtype)
    return params


def _cast_weights(tree: Any, dtype: torch.dtype, key: str = "") -> Any:
    """Cast every leaf to `dtype` except norm parameters and latent
    statistics, which the VAE keeps in fp32."""
    if isinstance(tree, dict):
        return {k: _cast_weights(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_weights(v, dtype, key) for v in tree]
    if key in ("scale", "bias", "latents_mean", "latents_std"):
        return tree
    return tree.to(dtype)


# ---------------------------------------------------------------------------
# The reference checkpoint format
# ---------------------------------------------------------------------------

_ATTN_FIELDS = (
    ("adaln_w1", "adaLN_modulation.1.weight"), ("adaln_w2", "adaLN_modulation.2.weight"),
    ("wq", "block.attn.to_q.0.weight"), ("wk", "block.attn.to_k.0.weight"),
    ("wv", "block.attn.to_v.0.weight"), ("wo", "block.attn.to_out.0.weight"),
    ("q_norm", "block.attn.to_q.1.weight"), ("k_norm", "block.attn.to_k.1.weight"),
)
_MLP_FIELDS = (
    ("adaln_w1", "adaLN_modulation.1.weight"), ("adaln_w2", "adaLN_modulation.2.weight"),
    ("w1", "block.layer1.weight"), ("w2", "block.layer2.weight"),
)
_SUB_FIELDS = (("fa", _ATTN_FIELDS), ("ca", _ATTN_FIELDS), ("mlp", _MLP_FIELDS))

Path = Tuple[Any, ...]


def _dit_key_map(cfg: DiTConfig) -> List[Tuple[str, Path]]:
    """(reference name without the prefix, path in the port's tree) of every
    DiT parameter, in the order the JAX package's converter reads them, so
    that the first missing key reported is the one it reports."""
    m: List[Tuple[str, Path]] = [
        ("x_embedder.proj.1.weight", ("x_embedder", "weight")),
        ("t_embedder.1.linear_1.weight", ("t_embedder", "w1")),
        ("t_embedder.1.linear_2.weight", ("t_embedder", "w2")),
        ("affline_norm.weight", ("affline_norm", "weight")),
    ]
    for j, (sub, fields) in enumerate(_SUB_FIELDS):
        for leaf, ref in fields:
            m += [(f"blocks.block{i}.blocks.{j}.{ref}", ("blocks", i, sub, leaf))
                  for i in range(cfg.num_blocks)]
    m += [
        ("final_layer.adaLN_modulation.1.weight", ("final", "adaln_w1")),
        ("final_layer.adaLN_modulation.2.weight", ("final", "adaln_w2")),
        ("final_layer.linear.weight", ("final", "linear")),
    ]
    if cfg.patch_embed_bias:
        m.append(("x_embedder.proj.1.bias", ("x_embedder", "bias")))
    if cfg.use_context_embedding:
        m.append(("context_embedding.weight", ("context_embedding", "weight")))
    return m


def _get(tree: Any, path: Path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Dict[str, Any], path: Path, value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def convert_dit_state_dict(
    state_dict: Mapping[str, Any],
    cfg: DiTConfig,
    dtype: torch.dtype = torch.bfloat16,
    prefix: str = "net.",
    quantize_int8: bool = False,
    act_quant: bool = False,
    group_size: Optional[int] = None,
    keep_bf16: Iterable[str] = (),
    mse_clip: bool = False,
    hadamard: bool = False,
    *,
    device: DeviceLike = None,
) -> Params:
    """A reference-format state dict (tensors or numpy arrays; a
    SafetensorsFile streams from disk) -> the port's DiT parameters on
    `device` (CUDA unless it says otherwise), in `dtype`.

    Raises KeyError on a missing parameter and ValueError on an unconsumed
    one (strict both ways) or a wrong shape, before any weight is moved.
    quantize_int8 quantizes each block's matmul weights on the device as the
    block arrives, from the checkpoint's own precision, with
    models/quant.quantize_block's meaning of act_quant (W8A8), group_size,
    keep_bf16, mse_clip and hadamard."""
    device = resolve_device(device)
    keymap = _dit_key_map(cfg)
    present = set(state_dict.keys())
    for name, _ in keymap:
        if prefix + name not in present:
            raise KeyError(f"Checkpoint missing parameter: {prefix + name}")
    # The training-time logvar head and the RoPE position buffer (derived
    # data, recomputed here) are read and discarded.
    consumed = {prefix + name for name, _ in keymap}
    consumed |= {k for k in present if k.startswith("logvar.") or k == prefix + "pos_embedder.seq"}
    leftovers = present - consumed
    if leftovers:
        raise ValueError(f"Unconsumed checkpoint parameters ({len(leftovers)}): "
                         f"{sorted(leftovers)[:8]}...")
    expected = init_dit_params(cfg, device="meta", dtype=torch.float32)
    for name, path in keymap:
        shape = tuple(_shape_of(state_dict, prefix + name))
        if shape != tuple(_get(expected, path).shape):
            raise ValueError(f"checkpoint parameter {prefix + name!r} has shape {shape}, "
                             f"expected {tuple(_get(expected, path).shape)}")
    # A SafetensorsFile hands out fresh tensors; other mappings' values are
    # copied, so the parameters never alias the caller's arrays.
    fresh = isinstance(state_dict, SafetensorsFile)

    def load(name: str, cast: bool = True) -> torch.Tensor:
        t = state_dict[prefix + name]
        t = t.detach() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
        t = t.to(device, copy=not fresh and t.device == device)
        return t.to(dtype) if cast else t

    params: Params = {}
    per_block: List[List[Tuple[str, Path]]] = [[] for _ in range(cfg.num_blocks)]
    for name, path in keymap:
        if path[0] == "blocks":
            per_block[path[1]].append((name, path))
        else:
            _set(params, path, load(name))
    blocks = []
    for entries in per_block:
        bp: Params = {sub: {} for sub, _ in _SUB_FIELDS}
        for name, (_, _, sub, leaf) in entries:
            matmul = leaf in QUANTIZED_BLOCK_WEIGHTS[sub]
            bp[sub][leaf] = load(name, cast=not (quantize_int8 and matmul))
        if quantize_int8:
            bp = quantize_block(bp, act_quant=act_quant, group_size=group_size,
                                keep_bf16=tuple(keep_bf16), mse_clip=mse_clip,
                                hadamard=hadamard)
            bp = {sub: {k: v if is_quantized(v) else v.to(dtype) for k, v in sp.items()}
                  for sub, sp in bp.items()}
        blocks.append(bp)
    params["blocks"] = blocks
    return {k: params[k] for k in expected}  # the init's key order


def _shape_of(state_dict: Mapping[str, Any], key: str) -> Tuple[int, ...]:
    if isinstance(state_dict, SafetensorsFile):
        return state_dict.shape_of(key)  # from the header, reading no data
    return tuple(np.shape(state_dict[key]))


def export_dit_state_dict(params: Params, cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """Inverse of convert_dit_state_dict: the port's DiT parameters ->
    a reference-named state dict of the same tensors (no copy; their dtype
    and device kept).  Quantized parameters cannot be exported."""
    out: Dict[str, torch.Tensor] = {}
    for name, path in _dit_key_map(cfg):
        v = _get(params, path)
        if is_quantized(v):
            raise ValueError(
                "export_dit_state_dict: quantized parameters cannot be exported "
                "to the reference torch layout — export the unquantized source "
                "checkpoint instead")
        out["net." + name] = v
    return out


def load_torch_file(path: str, device: DeviceLike = None) -> Mapping[str, torch.Tensor]:
    """A `.pt` / `.pth` / `.safetensors` checkpoint as a mapping of tensors,
    with the optional {"model": ...} unwrap.  `.safetensors` gives a
    SafetensorsFile (each tensor read when looked up, onto `device`, the
    host when None; close it when done); other files go through
    torch.load(mmap=True, weights_only=True), whose tensors stay mapped on
    the host."""
    if path.endswith(".safetensors"):
        return SafetensorsFile(path, device)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(path) and any(os.path.exists(os.path.join(path, m))
                                   for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an orbax checkpoint directory, the JAX package's native "
            "format, which the port does not read (orbax does not run on CUDA). "
            "Load the reference-format checkpoint (.pt or .safetensors) instead, "
            "or write one from a JAX tree with checkpoint.export_dit_state_dict.")


def is_native_checkpoint(path: str) -> bool:
    """True if `path` is a flat safetensors file of a parameter tree
    ('/'-joined keys), as save_native and save_vae_native write."""
    if not os.path.isfile(path):
        return False
    try:
        entries, _ = read_header(path)
    except (OSError, ValueError):
        return False
    return any("/" in k for k in entries)


def load_dit_checkpoint(
    path: str,
    cfg: DiTConfig,
    dtype: torch.dtype = torch.bfloat16,
    quantize_int8: bool = False,
    act_quant: bool = False,
    group_size: Optional[int] = None,
    keep_bf16: Iterable[str] = (),
    mse_clip: bool = False,
    hadamard: bool = False,
    *,
    device: DeviceLike = None,
) -> Params:
    """Load a DiT checkpoint onto `device` (CUDA unless it says otherwise).

    Reference `.pt` / `.safetensors` files are converted (and optionally
    quantized) on load, streamed tensor by tensor; a native file (save_native)
    restores directly, and the quantization flags are then ignored: the
    saved tree describes itself (int8 'q' and scale leaves)."""
    _refuse_orbax(path)
    device = resolve_device(device)
    if is_native_checkpoint(path):
        return restore_native(path, device=device)
    sd = load_torch_file(path, device=device)
    try:
        return convert_dit_state_dict(
            sd, cfg, dtype, quantize_int8=quantize_int8, act_quant=act_quant,
            group_size=group_size, keep_bf16=keep_bf16, mse_clip=mse_clip,
            hadamard=hadamard, device=device)
    finally:
        if isinstance(sd, SafetensorsFile):
            sd.close()


# ---------------------------------------------------------------------------
# The port's native format: one flat safetensors file
# ---------------------------------------------------------------------------

def save_native(path: str, params: Params) -> None:
    """Write a parameter tree (dicts and lists of tensors, any dtype the
    safetensors module supports, on any device) as one flat safetensors
    file with '/'-joined keys, one tensor at a time."""
    write_safetensors(path, _flatten(params))


def _unflatten(flat: Mapping[str, Any]) -> Params:
    """'/'-joined keys -> nested dicts; a dict whose keys are 0..n-1 becomes
    a list."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        _set(root, tuple(key.split("/")), val)
    return _listify(root)


def _listify(node: Any) -> Any:
    """Nested dicts with every dict keyed 0..n-1 (ints or digit strings)
    turned into a list."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) or k.isdigit() for k in node):
        return [_listify(node[k]) for k in sorted(node, key=int)]
    return {k: _listify(v) for k, v in node.items()}


def restore_native(path: str, device: DeviceLike = None) -> Params:
    """The tree save_native wrote, each leaf in its saved dtype on `device`
    (CUDA unless it says otherwise)."""
    _refuse_orbax(path)
    with SafetensorsFile(path, resolve_device(device)) as f:
        return _unflatten({k: f[k] for k in f})
