"""The port's trainer (training/train.py) against the JAX package's, in fp32
on the CPU, at the tiny config of tests/test_train_loop.py (64 wide, 2
blocks, 4 heads) and a 128-wide variant with 2 heads of 64, a head dim the
flash kernels take.  Weights and JAX states cross over through
checkpoint.dit_params_from_numpy / train_state_from_numpy; the port's
losses take JAX's draws for the same key (EdmDraws), since torch's
generators are not jax.random.

Tolerances, each for fp32 through two blocks in another summation order:
the loss 1e-5 relative; each gradient leaf 1e-5 of its largest element;
parameters after an SGD step (linear in the gradient) 2e-5 relative and
2e-7 absolute, as tests/test_train_loop.py holds JAX's own grad_accum step;
the AdamW update on identical gradients 1e-6 relative / 1e-9 absolute (one
rounding of the fp32 bias correction).  After AdamW steps on gradients
computed by the two packages, an element whose gradient is rounding noise
moves by about +-lr either way (AdamW's first update is lr * sign(g)), so
those comparisons hold the losses, and the parameters to 1e-6 on all but
0.5% of the elements and to 2 lr * steps on every one."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init
from diffusionrenderer_tpu.training import init_train_state as j_init_state
from diffusionrenderer_tpu.training import make_optimizer as j_make_optimizer
from diffusionrenderer_tpu.training import make_train_step as j_make_train_step
from diffusionrenderer_tpu.training.train import edm_loss as j_edm_loss
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy, train_state_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
from diffusionrenderer_tpu_torch.models.quant import quantize_dit_params
from diffusionrenderer_tpu_torch.training import (EdmDraws, edm_loss, init_train_state,
                                                  make_optimizer, make_train_step)
from diffusionrenderer_tpu_torch.training.train import AdamState, TrainState
from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves
from diffusionrenderer_tpu_torch.utils.tree import tree_map

CFG = DiTConfig(model_channels=64, num_blocks=2, num_heads=4, adaln_lora_dim=8,
                crossattn_emb_channels=16, additional_concat_ch=16)
CFG_D64 = dataclasses.replace(CFG, model_channels=128, num_heads=2)
LR = 1e-3


def jcfg(cfg):
    return JDiTConfig(**dataclasses.asdict(cfg))


def np_batch(seed, b=2, t=2, h=8, w=8):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((b, t, h, w, 16)).astype(np.float32),
            "latent_condition": rng.standard_normal((b, t, h, w, 16)).astype(np.float32),
            "context_index": np.array([3, 1, 0, 5][:b], np.int32)}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "context_index" else torch.from_numpy(v)
            for k, v in batch.items()}


def jax_draws(key, b, shape):
    """JAX edm_loss's draws for `key`: split in three, normal, normal, uniform."""
    ks, kn, kd = jax.random.split(key, 3)
    return EdmDraws(*(torch.from_numpy(np.asarray(x)) for x in (
        jax.random.normal(ks, (b,), jnp.float32), jax.random.normal(kn, shape, jnp.float32),
        jax.random.uniform(kd, (b,)))))


def step_draws(key, batch, grad_accum):
    """The draws of JAX's train step for `key`: the key itself, or with
    grad_accum > 1 fold_in(key, i) per microbatch."""
    x = batch["latents"]
    if grad_accum == 1:
        return [jax_draws(key, x.shape[0], x.shape)]
    mb = x.shape[0] // grad_accum
    return [jax_draws(jax.random.fold_in(key, i), mb, (mb,) + x.shape[1:])
            for i in range(grad_accum)]


@functools.lru_cache(maxsize=None)
def j_params(cfg):
    return j_init(jax.random.key(0), jcfg(cfg), dtype=jnp.float32)


def both_params(cfg):
    jp = j_params(cfg)
    return jp, dit_params_from_numpy(jax.device_get(jp), cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def j_loss_fn(cfg, drop):
    """JAX's edm_loss, jitted: (params, x0, cond, ctx, key) -> loss."""
    return jax.jit(functools.partial(j_edm_loss, cfg=jcfg(cfg), condition_drop_rate=drop))


@functools.lru_cache(maxsize=None)
def j_adamw_step():
    """JAX's AdamW train step (condition dropout 0.5), shared by the tests."""
    return j_make_train_step(jcfg(CFG), j_make_optimizer(LR), donate=False,
                             condition_drop_rate=0.5)


def assert_leaves_close(got_tree, want_tree, rtol, atol=0.0):
    for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("drop", [0.0, 0.8])
def test_edm_loss_matches_jax(drop):
    """With condition_drop_rate 0.8 the second row's keep uniform (0.759)
    drops its condition and context index."""
    jp, tp = both_params(CFG)
    nb = np_batch(0)
    key = jax.random.key(5)
    want = j_loss_fn(CFG, drop)(jp, *jax_batch(nb).values(), key)
    b = torch_batch(nb)
    draws = jax_draws(key, 2, nb["latents"].shape)
    assert bool((draws.keep_uniform >= drop).any()) and (drop == 0 or not bool(
        (draws.keep_uniform >= drop).all()))
    got = edm_loss(tp, *b.values(), None, CFG, condition_drop_rate=drop, draws=draws)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("cfg,backend", [(CFG, "auto"), (CFG_D64, "auto"), (CFG_D64, "pallas")],
                         ids=["d16_auto", "d64_auto", "d64_flash_function"])
def test_grads_of_every_leaf_match_jax(cfg, backend):
    """jax.grad of JAX's edm_loss (XLA attention on the CPU) vs loss.backward()
    through the port; 'pallas' puts FlashAttentionFunction (its plain
    forward) on the DiT's path.  The cross-attention's q / k projections and
    norms get no gradient in the port and exactly zero in JAX."""
    jp, tp = both_params(cfg)
    nb = np_batch(1)
    key = jax.random.key(7)
    jb = jax_batch(nb)
    jloss, jgrads = jax.value_and_grad(j_loss_fn(cfg, 0.5))(jp, *jb.values(), key)
    want = dit_params_from_numpy(jax.device_get(jgrads), cfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss = edm_loss(tp, *torch_batch(nb).values(), None, cfg, condition_drop_rate=0.5,
                    draws=jax_draws(key, 2, nb["latents"].shape), attn_backend=backend)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    unused = 0
    for p, w in zip(tree_leaves(tp), tree_leaves(want)):
        if p.grad is None:
            unused += 1
            assert float(w.abs().max()) == 0.0
            continue
        err = float((p.grad - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (tuple(p.shape), err)
    assert unused == 4 * cfg.num_blocks  # ca wq, wk, q_norm, k_norm per block


def test_adamw_update_matches_optax():
    """Three updates on identical gradients (numpy seeds), with a zero-
    gradient leaf standing in for the unused ones (None in the port)."""
    jp, tp = both_params(CFG)
    opt_j = j_make_optimizer(LR)
    opt_t = make_optimizer(LR)
    state_j, state_t = opt_j.init(jp), opt_t.init(tp)

    @jax.jit
    def j_update(g, state, params):
        updates, state = opt_j.update(g, state, params)
        return optax.apply_updates(params, updates), state

    rng = np.random.default_rng(3)
    for step in range(3):
        gnp = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 1e-2,
                           jax.device_get(jp))
        gnp["blocks"]["ca"]["wq"] = np.zeros_like(gnp["blocks"]["ca"]["wq"])
        jp, state_j = j_update(jax.tree.map(jnp.asarray, gnp), state_j, jp)
        gt = dit_params_from_numpy(gnp, CFG, device="cpu")
        for blk in gt["blocks"]:
            blk["ca"]["wq"] = None
        tp, state_t = opt_t.update(gt, state_t, tp)
    want = dit_params_from_numpy(jax.device_get(jp), CFG, device="cpu")
    assert_leaves_close(tp, want, rtol=1e-6, atol=1e-9)
    assert state_t.count == int(state_j[0].count) == 3
    assert_leaves_close(state_t.nu, dit_params_from_numpy(jax.device_get(state_j[0].nu), CFG,
                                                          device="cpu"), rtol=1e-6, atol=1e-12)
    # The carried-over weights are transposed views: contiguous moments
    # would pair their elements in another order, and are refused.
    with pytest.raises(ValueError, match="strides"):
        opt_t.update(gt, state_t._replace(mu=tree_map(torch.Tensor.contiguous, state_t.mu)), tp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_missing_gradient_is_a_zero_gradient(dtype):
    """A None gradient leaf updates as a zero gradient does, bit for bit
    (the moments decay, the weight decay applies), and the moments keep the
    parameters' dtype, as optax's do."""
    _, tp = both_params(CFG)
    out = []
    for missing in (False, True):
        params = tree_map(lambda t: t.to(dtype, copy=True), tp)
        grads = tree_map(torch.sin, params)
        for blk in grads["blocks"]:
            blk["ca"]["wq"] = None if missing else torch.zeros_like(blk["ca"]["wq"])
        opt = make_optimizer(LR)
        state = opt.init(params)
        for _ in range(2):
            params, state = opt.update(grads, state, params)
        out.append(tree_leaves([params, state.mu, state.nu]))
        assert state.count == 2
    for a, b in zip(*out, strict=True):
        assert a.dtype == dtype and torch.equal(a, b)


class _SGD:
    """A linear optimizer (p - lr g; None as zero) for checking the step's
    gradients: the port's make_train_step takes any object with update."""

    def __init__(self, lr):
        self.lr = lr

    def update(self, grads, state, params):
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            if g is not None:
                p.sub_(g, alpha=self.lr)
        return params, state


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_step_gradients_match_jax_scan(grad_accum):
    """make_train_step(grad_accum=n) against JAX's scan, through SGD (linear
    in the summed and divided gradients): each microbatch with JAX's
    fold_in draws, ONE update."""
    jp, tp = both_params(CFG)
    nb = np_batch(2, b=4)
    key = jax.random.key(11)
    j_step = j_make_train_step(jcfg(CFG), optax.sgd(0.1), donate=False, grad_accum=grad_accum,
                               condition_drop_rate=0.5)
    j_state, j_loss = j_step(j_init_state(jp, optax.sgd(0.1)), jax_batch(nb), key)
    t_step = make_train_step(CFG, _SGD(0.1), donate=False, grad_accum=grad_accum,
                             condition_drop_rate=0.5)
    t_state, t_loss = t_step(TrainState(tp, (), 0), torch_batch(nb),
                             draws=step_draws(key, nb, grad_accum))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert t_state.step == int(j_state.step) == 1
    want = dit_params_from_numpy(jax.device_get(j_state.params), CFG, device="cpu")
    assert_leaves_close(t_state.params, want, rtol=2e-5, atol=2e-7)
    # donate=False left the input state as it was
    assert_leaves_close(tp, dit_params_from_numpy(jax.device_get(jp), CFG, device="cpu"), 0.0)


def assert_adamw_params_close(got_tree, want_tree, steps):
    got = np.concatenate([t.detach().numpy().ravel() for t in tree_leaves(got_tree)])
    want = np.concatenate([t.numpy().ravel() for t in tree_leaves(want_tree)])
    err = np.abs(got - want)
    assert err.max() <= 2 * LR * steps
    assert np.mean(err > 1e-6) < 5e-3


def test_three_step_trajectory_matches_jax():
    jp, tp = both_params(CFG)
    keys = [jax.random.key(100 + s) for s in range(3)]
    batches = [np_batch(10 + s) for s in range(3)]
    j_step = j_adamw_step()
    j_state = j_init_state(jp, j_make_optimizer(LR))
    t_step = make_train_step(CFG, make_optimizer(LR), condition_drop_rate=0.5)
    t_state = init_train_state(tp, make_optimizer(LR))
    j_losses, t_losses = [], []
    for key, nb in zip(keys, batches):
        j_state, loss = j_step(j_state, jax_batch(nb), key)
        j_losses.append(float(loss))
        t_state, loss = t_step(t_state, torch_batch(nb), draws=step_draws(key, nb, 1))
        t_losses.append(float(loss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_state.step == 3 and t_state.opt_state.count == 3
    assert_adamw_params_close(t_state.params,
                              dit_params_from_numpy(jax.device_get(j_state.params), CFG,
                                                    device="cpu"), 3)


def test_jax_state_carried_mid_run():
    """Two JAX AdamW steps, the state carried over with
    train_state_from_numpy, then the next step in both packages."""
    jp, _ = both_params(CFG)
    j_step = j_adamw_step()
    j_state = j_init_state(jp, j_make_optimizer(LR))
    for s in range(2):
        j_state, _ = j_step(j_state, jax_batch(np_batch(20 + s)), jax.random.key(s))
    t_state = train_state_from_numpy(jax.device_get(j_state), CFG, device="cpu")
    assert isinstance(t_state.opt_state, AdamState)
    assert t_state.step == 2 and t_state.opt_state.count == 2
    assert_leaves_close(t_state.opt_state.mu, dit_params_from_numpy(
        jax.device_get(j_state.opt_state[0].mu), CFG, device="cpu"), 0.0)
    nb, key = np_batch(22), jax.random.key(2)
    j_state, j_loss = j_step(j_state, jax_batch(nb), key)
    t_state, t_loss = make_train_step(CFG, make_optimizer(LR), condition_drop_rate=0.5)(
        t_state, torch_batch(nb), draws=step_draws(key, nb, 1))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert t_state.step == 3
    want = train_state_from_numpy(jax.device_get(j_state), CFG, device="cpu")
    assert_adamw_params_close(t_state.params, want.params, 1)
    assert_adamw_params_close(t_state.opt_state.mu, want.opt_state.mu, 1)


def test_generator_draws_are_reproducible_and_per_microbatch():
    """From a torch.Generator, a grad_accum=2 step equals two draws in turn;
    the same seed gives the same step."""
    _, tp = both_params(CFG)
    nb = torch_batch(np_batch(4))
    step = make_train_step(CFG, make_optimizer(LR), donate=False, grad_accum=2)
    state = init_train_state(tp, make_optimizer(LR))
    out = [step(state, nb, torch.Generator().manual_seed(9)) for _ in range(2)]
    assert torch.equal(out[0][1], out[1][1])
    g = torch.Generator().manual_seed(9)
    mb = [{k: v[i:i + 1] for k, v in nb.items()} for i in range(2)]
    first = [edm_loss(tp, *m.values(), g, CFG) for m in mb]
    assert torch.equal(out[0][1], (first[0] + first[1]) / 2)


def test_refusals_under_grad():
    _, tp = both_params(CFG_D64)
    nb = torch_batch(np_batch(5))
    opt = make_optimizer(LR)
    # Quantized leaves: no gradient for the int8 codes nor the W8A8 kernel.
    for act_quant in (False, True):
        qp = quantize_dit_params(tp, act_quant=act_quant)
        x = nb["latents"].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="quantized weight"):
            dit_forward(qp, x, torch.ones(2), nb["latent_condition"], nb["context_index"],
                        CFG_D64)
        with pytest.raises(RuntimeError, match="quantized"):
            make_train_step(CFG_D64, opt)(init_train_state(qp, opt), nb,
                                          torch.Generator().manual_seed(0))
        with torch.no_grad():  # inference on the same tree still runs
            dit_forward(qp, x, torch.ones(2), nb["latent_condition"], nb["context_index"],
                        CFG_D64)
    with pytest.raises(ValueError, match="not divisible by grad_accum 3"):
        make_train_step(CFG_D64, opt, grad_accum=3)(init_train_state(tp, opt), nb,
                                                    torch.Generator())


def test_init_dit_params_trains_on_the_cpu():
    """The port's own init, a step from a CPU generator: finite loss, every
    leaf but the unused cross-attention ones moved, step and count 1."""
    params = init_dit_params(CFG_D64, device="cpu", dtype=torch.float32, seed=3)
    before = [p.clone() for p in tree_leaves(params)]
    opt = make_optimizer(LR, weight_decay=0.0)
    state, loss = make_train_step(CFG_D64, opt)(
        init_train_state(params, opt), torch_batch(np_batch(6)), torch.Generator().manual_seed(1))
    assert np.isfinite(float(loss)) and state.step == 1 and state.opt_state.count == 1
    moved = [not torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params))]
    assert sum(not m for m in moved) == 4 * CFG_D64.num_blocks
    assert all(not p.requires_grad and p.grad is None for p in tree_leaves(state.params))
