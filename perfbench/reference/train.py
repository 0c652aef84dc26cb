"""The DiT's training step, plainly: the EDM denoising loss (ln sigma ~
N(P_mean, P_std^2), x_t = x0 + sigma n, D = c_skip x_t + c_out F(c_in x_t;
sigma), loss = mean(lambda(sigma) (D - x0)^2) with lambda = (sigma^2 +
sd^2) / (sigma sd)^2; a sample's condition and context index dropped when
its uniform falls under the drop rate), its gradient, and AdamW as optax
states it (b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay on every
leaf, a missing gradient taken as zero).

Computation is float32 (TF32 off), each DiT block recomputed in the
backward pass so that one block's float32 weights are live at a time.  The
state is stored as the configuration states it: parameters, gradients and
moments in the parameters' dtype (bf16, no float32 master copy).
`matmul_fp8=True` rounds both operands of every DiT matmul to fp8 (e4m3,
per-tensor scale): the control, one precision step below bf16."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import dit
from .precision import fp32_exact

B1, B2, EPS = 0.9, 0.95, 1e-8
FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to fp8 e4m3 under a per-tensor scale; the gradient passes
    straight through (the matmul's backward reads the rounded operands)."""
    scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
    rounded = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (rounded - t).detach()


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) in depth-first insertion order."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def draws(gen: torch.Generator, x0: torch.Tensor):
    """The step's draws from `gen`, in the documented order: normals for
    ln sigma (B,), the noise (x0's shape), uniforms for the keep mask (B,)."""
    b, dev = x0.shape[0], gen.device
    return (torch.randn(b, generator=gen, device=dev), torch.randn(x0.shape, generator=gen,
                                                                  device=dev),
            torch.rand(b, generator=gen, device=dev))


def loss(params: Dict, net: Dict, x0, cond, ctx, d, *, sigma_data: float, p_mean: float,
         p_std: float, drop_rate: float, matmul_fp8: bool = False) -> torch.Tensor:
    normal, noise, keep_u = (t.float() for t in d)
    sigma = torch.exp(p_mean + p_std * normal)
    sig = sigma[:, None, None, None, None]
    x_t = x0.float() + sig * noise
    c_in = 1 / torch.sqrt(sig ** 2 + sigma_data ** 2)
    c_skip = sigma_data ** 2 / (sig ** 2 + sigma_data ** 2)
    c_out = sig * sigma_data / torch.sqrt(sig ** 2 + sigma_data ** 2)
    keep = keep_u >= drop_rate
    cond = cond.float() * keep[:, None, None, None, None].float()
    ctx = torch.where(keep, ctx, torch.zeros_like(ctx))
    f = dit.forward(params, net, x_t * c_in, sigma, cond, ctx,
                    block_runner=lambda fn, *a: checkpoint(fn, *a, use_reentrant=False),
                    quantize=_fp8 if matmul_fp8 else None)
    den = c_skip * x_t + c_out * f
    lam = (sig ** 2 + sigma_data ** 2) / (sig * sigma_data) ** 2
    return torch.mean(lam * (den - x0.float()) ** 2)


def adamw_(params, grads, mu, nu, count: int, lr: float, wd: float) -> None:
    """One optax.adamw step in place, float32 arithmetic, stored in each
    tensor's dtype."""
    t = count + 1
    for p, g, m, v in zip(params, grads, mu, nu):
        gf = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
        mf = B1 * m.float() + (1 - B1) * gf
        vf = B2 * v.float() + (1 - B2) * gf * gf
        upd = (mf / (1 - B1 ** t)) / (torch.sqrt(vf / (1 - B2 ** t)) + EPS)
        p.copy_(p.float() - lr * (upd + wd * p.float()))
        m.copy_(mf)
        v.copy_(vf)


def run_steps(params: Dict, net: Dict, batches: Sequence[Dict], gen: torch.Generator, *,
              lr: float, wd: float, sigma_data: float, p_mean: float, p_std: float,
              drop_rate: float, matmul_fp8: bool = False):
    """Train `params` in place over the batches; returns (losses, each
    step's gradient norm per leaf path)."""
    named = leaves(params)
    ps = [p for _, p in named]
    mu = [torch.zeros_like(p) for p in ps]
    nu = [torch.zeros_like(p) for p in ps]
    losses: List[float] = []
    grad_norms: List[Dict[str, float]] = []
    with fp32_exact():
        for k, batch in enumerate(batches):
            for p in ps:
                p.grad = None
                p.requires_grad_(True)
            x0 = batch["latents"]
            value = loss(params, net, x0, batch["latent_condition"], batch["context_index"],
                         draws(gen, x0), sigma_data=sigma_data, p_mean=p_mean, p_std=p_std,
                         drop_rate=drop_rate, matmul_fp8=matmul_fp8)
            value.backward()
            losses.append(float(value.detach()))
            grads = [p.grad for p in ps]
            for p in ps:
                p.requires_grad_(False)
                p.grad = None
            grad_norms.append({path: (0.0 if g is None else float(g.float().norm()))
                               for (path, _), g in zip(named, grads)})
            with torch.no_grad():
                adamw_(ps, grads, mu, nu, k, lr, wd)
            del grads
    return losses, grad_norms
