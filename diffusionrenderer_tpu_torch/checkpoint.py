"""Weights carried over from the JAX package's parameter trees.

`dit_params_from_numpy` and `vae_params_from_numpy` take the nested dicts
(and lists) of numpy arrays that the JAX package's `init_dit_params` /
`init_vae_params` produce after `jax.device_get`, and return the port's
parameter dicts, doing every layout change here:

* DiT: blocks stacked on a leading axis (nb, ...) become a list of
  per-block dicts; dense weights (in, out) become (out, in); the context
  embedding table keeps its (num, C_ctx) layout;
* VAE: conv weights (kt, kh, kw, Cin, Cout) become (Cout, Cin, kt, kh, kw);
  dense weights (in, out) become (out, in).

Both are strict: a missing leaf, an extra leaf or a wrong shape raises.
The expected structure is the port's own random init built on the 'meta'
device, so the two trees cannot drift apart silently.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .config import DiTConfig, VAEConfig
from .models.dit import init_dit_params
from .models.vae import init_vae_params
from .utils.device import DeviceLike, resolve_device


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


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
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


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
        if arr.ndim == 2 and key != "context_embedding/weight":
            return arr.T  # (in, out) -> (out, in)
        return arr

    expected = init_dit_params(cfg, device="meta", dtype=torch.float32)
    params = _fill(expected, leaves, convert, device, dtype)
    _check_consumed(leaves)
    return params


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
