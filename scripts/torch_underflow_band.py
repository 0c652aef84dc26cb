"""The bounded softmax in fp32's underflow band: the PyTorch port against the
JAX package on the CPU.

Inputs: numpy default_rng(0) standard normals, (B, L, H, D) = (1, 256, 2, 64),
q multiplied by 14 (and by 17).  Each row is shifted by its Cauchy-Schwarz
bound mb_i, which overshoots the row's true max by 104 to 187 log2 units
here.  Prints, per case and per overshoot class, max |port - JAX|; the port
against an fp64 evaluation with exp2 flushed below 2^-126; the same
function in fp32 without that flush (the port before it flushed); and with
the P V products and the running sums also flushed, as XLA's CPU backend
flushes subnormals.

    JAX_PLATFORMS=cpu python scripts/torch_underflow_band.py
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusionrenderer_tpu.ops import flash_attention as jfa  # noqa: E402
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa  # noqa: E402

TINY = 2.0 ** -126


def flush(x):
    return torch.where(x.abs() < TINY, torch.zeros_like(x), x)


def band(q_scale: float) -> dict:
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 256, 2, 64)).astype(np.float32) for _ in range(3))
    q = q * q_scale
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    port = tfa.flash_attention(tq, tk, tv, bounded=True, pipelined=True).numpy()
    jax_out = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             interpret=True, bounded=True, pipelined=True))
    mb = tfa.row_bound(tq, tk)
    s = tfa._scores(tq, tk) - mb[..., None]  # (B, H, Lq, Lk) fp32
    over = -s.amax(-1).permute(0, 2, 1).numpy()  # mb_i - max_j s_ij, (B, Lq, H)
    p = torch.exp2(s.double())
    p = torch.where(p < TINY, 0.0, p)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, tv.double())
    fp64 = (acc / p.sum(-1).clamp_min(1e-37).permute(0, 2, 1)[..., None]).numpy()
    pu = torch.exp2(s)  # subnormal weights kept
    unflushed = (torch.einsum("bhqk,bkhd->bqhd", pu, tv)
                 / pu.sum(-1).clamp_min(1e-37).permute(0, 2, 1)[..., None]).numpy()
    # Products and partial sums flushed too, summed key by key in fp32.
    pf = flush(torch.exp2(s))
    acc_f = torch.zeros(1, 256, 2, 64)
    l_f = torch.zeros(1, 2, 256)
    for j in range(256):
        prod = flush(pf[..., j].permute(0, 2, 1)[..., None] * tv[:, j:j + 1])
        acc_f = flush(acc_f + prod)
        l_f = flush(l_f + pf[..., j])
    all_flushed = (acc_f / l_f.clamp_min(1e-37).permute(0, 2, 1)[..., None]).numpy()
    diff = np.abs(port - jax_out).max(-1)
    classes = {"under_105": over < 105, "105_to_135": (over >= 105) & (over < 135),
               "135_and_over": over >= 135}
    return {
        "q_scale": q_scale, "overshoot_min": float(over.min()), "overshoot_max": float(over.max()),
        "rows": {name: int(m.sum()) for name, m in classes.items()},
        "max_abs_port_vs_jax": {name: float(diff[m].max()) if m.any() else None
                                for name, m in classes.items()},
        "max_abs_jax": float(np.abs(jax_out).max()),
        "zero_rows_port": float((np.abs(port).max(-1) == 0).mean()),
        "zero_rows_jax": float((np.abs(jax_out).max(-1) == 0).mean()),
        "max_abs_port_vs_fp64_flushed": float(np.abs(port - fp64).max()),
        "max_abs_unflushed_vs_jax": float(np.abs(unflushed - jax_out).max()),
        "max_abs_all_flushed_vs_jax": float(np.abs(all_flushed - jax_out).max()),
    }


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for scale in (14.0, 17.0):
        print(json.dumps(band(scale)))
