"""EDM training step for the DiT (counterpart of
diffusionrenderer_tpu/training/train.py).

Loss: EDM denoising score matching with the sampler's preconditioning
(c_skip / c_out / c_in):

    x_t = x0 + sigma * n,   n ~ N(0, I),   ln(sigma) ~ N(P_mean, P_std^2)
    D(x_t) = c_skip * x_t + c_out * F(c_in * x_t; sigma)
    L = E[ lambda(sigma) * ||D(x_t) - x0||^2 ],
    lambda = (sigma^2 + sd^2) / (sigma * sd)^2

Condition dropout zeroes latent_condition and context_index per sample with
condition_drop_rate (0.1 inverse / 0.05 forward), which is what makes
guidance > 0 work at inference.

What differs from the JAX package, and why:

* Randomness.  torch's generators are not `jax.random`: a loss draws its
  ln-sigma normals, its noise and its keep uniforms (`EdmDraws`, in that
  order) from an explicit `torch.Generator`, or takes them injected
  (`draws=`), which is how the tests feed JAX's draws for a key.  With
  grad_accum > 1 the microbatches draw from the step's generator in turn
  (JAX folds the microbatch index into the key).
* The optimizer.  `make_optimizer` is optax's `adamw` (b1 0.9, b2 0.95, eps
  1e-8, eps_root 0, decay on every leaf), moments in the parameters'
  dtype, computed in place by PyTorch's AdamW, fused on CUDA: at 7B in bf16
  the parameters, gradients and two moments already take 54 GiB, and the
  fused update builds no whole-model intermediates.
* The step.  Gradients accumulate in the leaves' `.grad` (one backward per
  microbatch), so a grad_accum step holds one set of gradients, not two;
  `donate=True` updates the state's tensors in place (JAX donates its
  buffers), `donate=False` works on a copy.  A leaf that no op reads (the
  cross-attention's q and k projections and norms, which the exact
  single-key collapse removes) gets no gradient here and a zero one in JAX:
  the optimizer treats a missing gradient as zeros, bit for bit.

* Under a mesh.  `seq_sharding_constraint`
  (parallel.token_sharding_constraint(mesh)) and `block_executor`
  (parallel.make_pp_executor) go to dit_forward as in JAX.  Every rank
  passes the whole batch and draws the whole batch's randomness from the
  same generator; the loss is computed whole on every rank, and each
  rank's gradients of its parameter shards come out whole
  (models/dit.py), so the optimizer updates every shard on its own rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.optim.adamw import adamw as _adamw

from ..config import DiTConfig
from ..models.dit import AttnBackend, dit_forward
from ..utils.tree import leaves as tree_leaves
from ..utils.tree import tree_map


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: the update count and the two moments, each
    a tree like the parameters."""

    count: int
    mu: Any
    nu: Any


class EdmDraws(NamedTuple):
    """The random draws of one edm_loss call: standard normals (B,) for
    ln sigma, the noise (x0's shape) and uniforms (B,) for the dropout keep
    mask, all fp32."""

    log_sigma_normal: torch.Tensor
    noise: torch.Tensor
    keep_uniform: torch.Tensor


def _copy(tree: Any) -> Any:
    """A copy of every tensor of a tree (other leaves as they are)."""
    return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamW:
    """optax.adamw(learning_rate, b1=0.9, b2=0.95, eps=1e-8, eps_root=0,
    weight_decay), moments in the parameters' dtype, applied in place by
    PyTorch's AdamW (`torch.optim.adamw.adamw`), fused on CUDA: one pass
    over each tensor group that computes in fp32 and rounds once per stored
    tensor, with no whole-model intermediates.  It equals optax's update in
    exact arithmetic (the decay is applied as p * (1 - lr * wd) before the
    Adam step instead of inside it); in bf16 it rounds once where optax
    rounds after each operation."""

    B1, B2, EPS = 0.9, 0.95, 1e-8

    def __init__(self, learning_rate: float = 1e-4, weight_decay: float = 0.01):
        self.learning_rate, self.weight_decay = learning_rate, weight_decay

    def init(self, params: Any) -> AdamState:
        # Zeros with each parameter's strides: the fused update pairs the
        # elements of a parameter, its gradient and its moments by memory
        # offset, not by index.
        return AdamState(0, tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamState, params: Any) -> Tuple[Any, AdamState]:
        """Apply one step in place to `params` and the moments of `state`;
        grads is a tree like params whose leaves may be None (a zero
        gradient).  Returns (params, the state with count + 1)."""
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, ns = tree_leaves(state.mu), tree_leaves(state.nu)
        if not len(ps) == len(gs) == len(ms) == len(ns):
            raise ValueError("params, grads and the moments must have one structure")
        # A None parameter is a block another pipeline stage holds.
        quads = [q for q in zip(ps, gs, ms, ns) if q[0] is not None]
        ps, gs, ms, ns = (list(z) for z in zip(*quads)) if quads else ([], [], [], [])
        if any(not p.stride() == m.stride() == n.stride() == (p if g is None else g).stride()
               for p, g, m, n in zip(ps, gs, ms, ns)):
            raise ValueError("each gradient and moment must have its parameter's strides")
        zeros: Dict[Tuple, torch.Tensor] = {}

        def zero_like(p: torch.Tensor) -> torch.Tensor:
            """A missing gradient: one read-only zero per layout."""
            key = (p.shape, p.stride(), p.dtype, p.device)
            if key not in zeros:
                zeros[key] = torch.zeros_like(p)
            return zeros[key]

        gs = [zero_like(p) if g is None else g for p, g in zip(ps, gs)]
        # The count, one fp32 scalar tensor per leaf as torch.optim keeps it;
        # adamw adds the 1.
        steps = [torch.full((), float(state.count), device=p.device) for p in ps]
        # Fused on CUDA.  On the CPU, after the fused kernel (or with the
        # counts as views of one tensor) a later torch.sin on another tensor
        # read wrong values in about half of the test runs; the CPU takes
        # PyTorch's foreach implementation of the same update.
        cuda = ps[0].is_cuda
        _adamw(ps, gs, ms, ns, [], steps, fused=cuda, foreach=not cuda, amsgrad=False,
               beta1=self.B1, beta2=self.B2, lr=self.learning_rate,
               weight_decay=self.weight_decay, eps=self.EPS, maximize=False)
        return params, AdamState(state.count + 1, state.mu, state.nu)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    """AdamW with b1 0.9, b2 0.95 (optax.adamw's settings in the JAX package)."""
    return AdamW(learning_rate, weight_decay)


def init_train_state(params: Any, optimizer: AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------

def edm_draws(generator: torch.Generator, x0: torch.Tensor) -> EdmDraws:
    """One loss's draws from `generator`, in a fixed order, on x0's device."""
    b, dev = x0.shape[0], generator.device
    draws = EdmDraws(torch.randn(b, generator=generator, device=dev),
                     torch.randn(x0.shape, generator=generator, device=dev),
                     torch.rand(b, generator=generator, device=dev))
    return EdmDraws(*(t.to(x0.device) for t in draws))


def edm_loss(
    params: Any,
    x0: torch.Tensor,
    latent_condition: torch.Tensor,
    context_index: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: DiTConfig,
    sigma_data: float = 0.5,
    p_mean: float = -1.2,
    p_std: float = 1.2,
    condition_drop_rate: float = 0.0,
    seq_sharding_constraint=None,
    block_executor=None,
    *,
    draws: Optional[EdmDraws] = None,
    attn_backend: AttnBackend = "auto",
) -> torch.Tensor:
    """x0: (B, T, H, W, C) clean latents (already sigma_data-scaled).  The
    draws come from `generator` unless given as `draws`.  Returns the fp32
    scalar loss.  seq_sharding_constraint, block_executor: dit_forward's
    (the whole batch on every rank)."""
    if draws is None:
        if generator is None:
            raise ValueError("edm_loss needs a torch.Generator or draws=")
        draws = edm_draws(generator, x0)
    log_sigma = p_mean + p_std * draws.log_sigma_normal.float()
    sigma = torch.exp(log_sigma)
    sig = sigma[:, None, None, None, None]
    x_t = x0.float() + sig * draws.noise.float()

    c_in = 1.0 / torch.sqrt(sig ** 2 + sigma_data ** 2)
    c_skip = sigma_data ** 2 / (sig ** 2 + sigma_data ** 2)
    c_out = sig * sigma_data / torch.sqrt(sig ** 2 + sigma_data ** 2)

    if condition_drop_rate > 0:
        keep = draws.keep_uniform >= condition_drop_rate
        latent_condition = latent_condition * keep[:, None, None, None, None].to(
            latent_condition.dtype)
        context_index = torch.where(keep, context_index, torch.zeros_like(context_index))

    f = dit_forward(params, (x_t * c_in).to(x0.dtype), sigma, latent_condition,
                    context_index, cfg, attn_backend=attn_backend,
                    seq_sharding_constraint=seq_sharding_constraint,
                    block_executor=block_executor).float()
    denoised = c_skip * x_t + c_out * f
    weight = (sig ** 2 + sigma_data ** 2) / (sig * sigma_data) ** 2
    return torch.mean(weight * torch.square(denoised - x0.float()))


def make_train_step(
    cfg: DiTConfig,
    optimizer: AdamW,
    sigma_data: float = 0.5,
    condition_drop_rate: float = 0.0,
    seq_sharding_constraint=None,
    donate: bool = True,
    block_executor=None,
    grad_accum: int = 1,
) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """The train step: step(state, batch, generator=None, *, draws=None) ->
    (state, loss).

    batch: dict with 'latents' (B, T, H, W, C), 'latent_condition' and
    'context_index' (B,).  grad_accum splits the batch into that many
    microbatches along the batch axis (B must divide evenly), each with its
    own draws (from `generator` in turn, or draws[i]); the summed loss and
    gradients are divided by grad_accum before ONE optimizer update, as the
    JAX step's scan does.  The loss stays on the device.
    seq_sharding_constraint, block_executor: edm_loss's; under them the
    state holds this rank's parameter shards (parallel.shard_params,
    pp_block_shardings), and every rank passes the whole batch."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, *,
             draws: Optional[Sequence[EdmDraws]] = None):
        b = batch["latents"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
        if draws is not None and len(draws) != grad_accum:
            raise ValueError(f"draws holds {len(draws)} microbatches, grad_accum is {grad_accum}")
        params, opt_state = state.params, state.opt_state
        if not donate:
            params, opt_state = _copy(params), _copy(opt_state)
        leaves = [t for t in tree_leaves(params) if t is not None]
        if any(not t.is_floating_point() for t in leaves):
            raise RuntimeError("the parameters hold int8 (quantized) leaves, which have no "
                               "gradient: train the bf16 / fp32 model")
        mb = b // grad_accum
        loss_sum = None
        try:
            for p in leaves:
                p.grad = None
                p.requires_grad_(True)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss = edm_loss(params, micro["latents"], micro["latent_condition"],
                                micro["context_index"], generator, cfg, sigma_data=sigma_data,
                                condition_drop_rate=condition_drop_rate,
                                seq_sharding_constraint=seq_sharding_constraint,
                                block_executor=block_executor,
                                draws=None if draws is None else draws[i])
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = tree_map(lambda p: p.grad, params)
        finally:
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        if grad_accum > 1:
            loss_sum = loss_sum / grad_accum
            for g in tree_leaves(grads):
                if g is not None:
                    g.div_(grad_accum)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return TrainState(params, opt_state, state.step + 1), loss_sum

    return step
