"""The port's dit_forward against the JAX package's, in fp32, with the same
weights (carried by checkpoint.dit_params_from_numpy) and the same numpy
inputs: the inverse tiny config of tests/test_golden_e2e.py and a forward
variant (136 condition channels, zero context), each with the default
attention backend and with the flash path forced (JAX: Pallas in interpret
mode; the port: the kernels' plain version).  Tolerance 1e-4 relative /
absolute: fp32 through two blocks of differently ordered sums."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models.dit import dit_forward as j_dit_forward
from diffusionrenderer_tpu.models.dit import dit_param_count as j_param_count
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward, dit_param_count, init_dit_params

NET = DiTConfig(
    model_channels=96, num_blocks=2, num_heads=2, in_channels=16, out_channels=16,
    additional_concat_ch=16, adaln_lora_dim=8, crossattn_emb_channels=16,
    use_context_embedding=True,
)
FWD_NET = dataclasses.replace(NET, additional_concat_ch=136, use_context_embedding=False)


def jax_cfg(cfg):
    return JDiTConfig(**dataclasses.asdict(cfg))


def run_both(cfg, backend, seed=0):
    jparams = j_init(jax.random.key(seed), jax_cfg(cfg), dtype=jnp.float32)
    tparams = dit_params_from_numpy(jax.device_get(jparams), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    b, t, h, w = 2, 2, 4, 6
    x = rng.standard_normal((b, t, h, w, cfg.in_channels)).astype(np.float32)
    cond = rng.standard_normal((b, t, h, w, cfg.additional_concat_ch)).astype(np.float32)
    sigma = np.array([80.0, 0.5], np.float32)
    ctx = np.array([3, 0], np.int32)
    jfwd = jax.jit(functools.partial(j_dit_forward, cfg=jax_cfg(cfg), attn_backend=backend))
    want = jfwd(jparams, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(cond), jnp.asarray(ctx))
    got = dit_forward(tparams, torch.from_numpy(x), torch.from_numpy(sigma),
                      torch.from_numpy(cond), torch.from_numpy(ctx).long(), cfg,
                      attn_backend=backend)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("cfg", [NET, FWD_NET], ids=["inverse", "forward"])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_dit_forward_matches_jax(cfg, backend):
    got, want = run_both(cfg, backend)
    assert got.shape == want.shape == (2, 2, 4, 6, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_context_index_changes_inverse_output():
    tparams = init_dit_params(NET, device="cpu", dtype=torch.float32, seed=3)
    x = torch.randn(2, 1, 4, 4, 16)
    cond = torch.randn(2, 1, 4, 4, 16)
    sig = torch.tensor([1.0, 1.0])
    a = dit_forward(tparams, x, sig, cond, torch.tensor([0, 0]), NET)
    b = dit_forward(tparams, x, sig, cond, torch.tensor([0, 4]), NET)
    torch.testing.assert_close(a[0], b[0])
    assert (a[1] - b[1]).abs().max() > 0


@pytest.mark.parametrize("cfg", [NET, FWD_NET, DiTConfig()], ids=["inverse", "forward", "7b"])
def test_param_count_matches_jax(cfg):
    assert dit_param_count(cfg) == j_param_count(jax_cfg(cfg))
    meta = init_dit_params(cfg, device="meta")
    leaves = [meta["x_embedder"], meta["t_embedder"], meta["affline_norm"], meta["final"],
              meta.get("context_embedding", {})] + [
        sub for blk in meta["blocks"] for sub in blk.values()]
    assert sum(t.numel() for d in leaves for t in d.values()) == dit_param_count(cfg)


def test_weight_carry_over_is_strict():
    tree = jax.device_get(j_init(jax.random.key(0), jax_cfg(NET), dtype=jnp.float32))
    missing = {**tree, "final": {k: v for k, v in tree["final"].items() if k != "linear"}}
    with pytest.raises(KeyError, match="final/linear"):
        dit_params_from_numpy(missing, NET, device="cpu")
    extra = {**tree, "logvar": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="logvar"):
        dit_params_from_numpy(extra, NET, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        dit_params_from_numpy(tree, dataclasses.replace(NET, crossattn_emb_channels=8),
                              device="cpu")
