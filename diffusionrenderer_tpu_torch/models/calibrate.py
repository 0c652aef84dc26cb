"""Quantization calibration capture: per-(block, site) activation statistics.

Counterpart of diffusionrenderer_tpu/models/calibrate.py.  The calibrated
quantizers of models/quant.py (the '_awq' scale migration and '_gptq'
error-compensating rounding) need what each quantized matmul sees.  One
dit_forward runs with a capture hook (models/dit.block_apply's `capture`)
that reduces each site's input (models/quant.LEAF_SITE) on the device as
the block runs and keeps only the statistics, on the host:

* `amean`: per-input-channel mean |x| over the tokens, (K,) fp32, at every
  site;
* `h`: the GPTQ Hessian sum x^T x, (K, K) fp32, at the requested sites only
  (the 16384-wide mlp.w2 H is 1 GiB a block and is off by default).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..config import DiTConfig
from .dit import dit_forward

ALL_SITES = ("fa.qkv", "fa.wo", "ca.wv", "ca.wo", "mlp.w1", "mlp.w2")
DEFAULT_HESSIAN_SITES = ("fa.qkv", "fa.wo", "mlp.w1")


def capture_dit_stats(params: Dict[str, Any], cfg: DiTConfig, x: torch.Tensor,
                      sigma: torch.Tensor, latent_condition: torch.Tensor,
                      context_index: Optional[torch.Tensor], *,
                      hessian_sites: Sequence[str] = DEFAULT_HESSIAN_SITES,
                      prev: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run one denoiser forward (dit_forward's inputs, preconditioned as the
    pipeline feeds them) and return {"amean": {site: (nb, K)}, "h": {site:
    (nb, K, K)}, "count": {site: tokens}} as CPU tensors, which
    quant.quantize_dit_params_host takes.  `prev` accumulates over
    calibration batches (token-weighted amean, summed H)."""
    hset = frozenset(hessian_sites)
    raw: Dict[str, Dict[str, list]] = {}

    def hook(block: int, site: str, t: torch.Tensor) -> None:
        tf = t.reshape(-1, t.shape[-1]).float()
        slot = raw.setdefault(site, {"amean": [], "h": [], "count": []})
        slot["amean"].append(tf.abs().mean(dim=0).cpu())
        slot["count"].append(float(tf.shape[0]))
        if site in hset:
            slot["h"].append((tf.T @ tf).cpu())

    with torch.no_grad():
        dit_forward(params, x, sigma, latent_condition, context_index, cfg, capture=hook)
    stats: Dict[str, Any] = {"amean": {}, "h": {}, "count": {}}
    for site, slot in raw.items():
        stats["amean"][site] = torch.stack(slot["amean"])
        stats["count"][site] = slot["count"][0]
        if slot["h"]:
            stats["h"][site] = torch.stack(slot["h"])
    return accumulate_stats(prev, stats) if prev is not None else stats


def accumulate_stats(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Merge two capture results: amean token-weighted, H summed."""
    out: Dict[str, Any] = {"amean": {}, "h": {}, "count": {}}
    for site in set(a["amean"]) | set(b["amean"]):
        if site in a["amean"] and site in b["amean"]:
            na, nb_ = a["count"][site], b["count"][site]
            out["amean"][site] = (a["amean"][site] * (na / (na + nb_))
                                  + b["amean"][site] * (nb_ / (na + nb_)))
            out["count"][site] = na + nb_
        else:
            src = a if site in a["amean"] else b
            out["amean"][site] = src["amean"][site]
            out["count"][site] = src["count"][site]
        ha, hb = a["h"].get(site), b["h"].get(site)
        if ha is not None and hb is not None:
            out["h"][site] = ha + hb
        elif ha is not None or hb is not None:
            out["h"][site] = ha if ha is not None else hb
    return out
