"""Weights drawn from the run's seed on the device, in a few large calls:
each leaf is a tensor of its own, as a checkpoint's loader makes them; the
leaves of one kind and dtype, laid end to end, are filled by chunks of one
torch.Generator's normals, then scaled per kind.  The layouts are the
references' (`reference.dit.param_shapes`, `reference.vae.param_shapes`);
the program is handed the same tensors."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..reference import dit as ref_dit
from ..reference import vae as ref_vae

CHUNK = 1 << 28  # normals per generator call (1 GiB of float32 scratch)


def _fill_normal(leaves: List[torch.Tensor], gen: torch.Generator, std: float,
                 mean: float = 0.0):
    """Fill the leaves, taken end to end, with chunks of normals: the same
    values as one flat buffer filled chunk by chunk."""
    flats = [t.view(-1) for t in leaves if t.numel()]
    total = sum(f.numel() for f in flats)
    i, off = 0, 0  # the leaf the next value goes to, and the offset in it
    for s in range(0, total, CHUNK):
        draw = torch.randn(min(CHUNK, total - s), generator=gen, device=flats[0].device,
                           dtype=torch.float32).mul_(std).add_(mean)
        d = 0
        while d < draw.numel():
            n = min(flats[i].numel() - off, draw.numel() - d)
            flats[i][off:off + n] = draw[d:d + n]
            d, off = d + n, off + n
            if off == flats[i].numel():
                i, off = i + 1, 0


def _set(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


# kind -> (dtype is the served one?, mean, std, per-leaf std from fan-in?)
_DIT_KINDS = {"normal": (True, 0.0, 0.02, False), "embed": (True, 0.0, 1.0, False),
              "scale": (True, 1.0, 0.1, False)}
_VAE_KINDS = {"conv": (True, 0.0, 1.0, True), "conv_out": (True, 0.0, 0.1, True),
              "dense": (True, 0.0, 1.0, True),
              "bias": (True, 0.0, 0.02, False), "gn_scale": (False, 1.0, 0.1, False),
              "gn_bias": (False, 0.0, 0.1, False), "lat_mean": (False, 0.0, 0.3, False),
              "lat_std": (False, 1.0, 0.2, False)}


def _draw(shapes, kinds, gen, device, dtype) -> Dict:
    tree: Dict = {}
    by_kind: Dict[str, List] = {}
    for path, shape, kind in shapes:
        by_kind.setdefault(kind, []).append((path, shape))
    for kind in sorted(by_kind):
        served, mean, std, fan_in = kinds[kind]
        items = by_kind[kind]
        leaves = [torch.empty(shape, device=device, dtype=dtype if served else torch.float32)
                  for _, shape in items]
        _fill_normal(leaves, gen, std, mean)
        for (path, shape), leaf in zip(items, leaves):
            if fan_in:
                leaf.mul_(1.0 / math.sqrt(math.prod(shape) // shape[0]))
            _set(tree, path, leaf)
    return tree


def draw(cfg: Dict, seed: int, device, dtype: torch.dtype, vae: bool = True) -> Dict:
    """{'dit': tree, 'vae': tree} for the configuration's sizes (the VAE's
    draws come after the DiT's, so vae=False leaves the DiT's as they are)."""
    gen = torch.Generator(device).manual_seed(int(seed))
    out = {"dit": _draw(ref_dit.param_shapes(cfg["net"]), _DIT_KINDS, gen, device, dtype)}
    if vae:
        out["vae"] = _draw(ref_vae.param_shapes(cfg["vae"]), _VAE_KINDS, gen, device, dtype)
        # A latent standard deviation is positive.
        out["vae"]["latents_std"].abs_().clamp_(min=0.2)
    return out
