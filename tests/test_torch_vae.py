"""The port's VAE against the JAX package's, in fp32, on the TINY VAE of
tests/test_vae.py with the same weights (a JAX-layout tree carried over by
checkpoint.vae_params_from_numpy):
encode and decode of one 64x64 frame and of a 9-frame 32x32 video, with the
default attention backend and with the flash path forced, and the three
convention switches.  Tolerance 1e-4 relative / absolute (fp32 through
~20 convolutions with differently ordered sums)."""

import dataclasses
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.config import VAEConfig as JVAEConfig
from diffusionrenderer_tpu.models import vae as jv
from diffusionrenderer_tpu_torch.checkpoint import vae_params_from_numpy
from diffusionrenderer_tpu_torch.config import VAEConfig
from diffusionrenderer_tpu_torch.models import vae as tv

TINY = VAEConfig(
    encoder_block_out_channels=(8, 12, 16, 16),
    decode_block_out_channels=(12, 16, 16, 16),
    num_layers=1,
)
TOL = dict(rtol=1e-4, atol=1e-4)


def numpy_vae_tree(cfg, seed):
    """The JAX VAE's parameter tree, its structure and shapes taken from
    JAX's own init (traced, not run), filled with seeded numpy values:
    weights N(0, 1/fan_in), non-zero biases and norm affines, non-identity
    latent statistics, so that every parameter's use is checked."""
    shapes = jax.eval_shape(
        lambda key: jv.init_vae_params(key, JVAEConfig(**dataclasses.asdict(cfg)), jnp.float32),
        jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "w":
            return (rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "latents_std":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


ALT = dataclasses.replace(TINY, dwt_rescale="orthonormal", stats_location="external")
FRAME64, VIDEO9 = (1, 1, 64, 64, 3), (1, 9, 32, 32, 3)


@pytest.fixture(scope="module")
def jax_tree():
    """One tree serves every case: the convention switches do not change
    the parameter shapes."""
    return numpy_vae_tree(TINY, seed=0)


@pytest.fixture(scope="module")
def both(jax_tree):
    return (TINY, JVAEConfig(**dataclasses.asdict(TINY)),
            jax.tree_util.tree_map(jnp.asarray, jax_tree),
            vae_params_from_numpy(jax_tree, TINY, device="cpu"))


@pytest.mark.parametrize("cfg,shape,backend", [
    (TINY, FRAME64, "auto"), (TINY, VIDEO9, "auto"), (TINY, FRAME64, "pallas"),
    (ALT, VIDEO9, "auto"),
], ids=["frame64", "video9x32", "frame64-flash", "orthonormal-external-video9x32"])
def test_encode_decode_match_jax(both, cfg, shape, backend, monkeypatch):
    _, _, jparams, tparams = both
    jcfg = JVAEConfig(**dataclasses.asdict(cfg))
    if backend == "pallas":
        # Force the flash path of the spatial attention on both sides.
        jatt = importlib.import_module("diffusionrenderer_tpu.ops.attention")
        jitted = jatt.attention
        monkeypatch.setattr(jatt, "attention",
                            lambda q, k, v, backend="auto": jitted(q, k, v, backend="pallas"))
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    z_want = np.asarray(jax.jit(functools.partial(jv.vae_encode, cfg=jcfg))(
        jparams, jnp.asarray(x)))
    z_got = tv.vae_encode(tparams, torch.from_numpy(x), cfg, attn_backend=backend)
    assert z_got.shape == z_want.shape
    np.testing.assert_allclose(z_got.numpy(), z_want, **TOL)

    y_want = np.asarray(jax.jit(functools.partial(jv.vae_decode, cfg=jcfg))(
        jparams, jnp.asarray(z_want)))
    y_got = tv.vae_decode(tparams, torch.from_numpy(z_want.copy()), cfg,
                          attn_backend=backend)
    assert y_got.shape == y_want.shape == shape
    np.testing.assert_allclose(y_got.numpy(), y_want, **TOL)


def test_channels_first_layouts_agree(both):
    cfg, _, _, tparams = both
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 1, 32, 32, 3))
                         .astype(np.float32))
    z = tv.vae_encode(tparams, x, cfg)
    torch.testing.assert_close(tv.vae_encode(tparams, x.permute(0, 4, 1, 2, 3), cfg,
                                             in_layout="NCDHW"), z)
    torch.testing.assert_close(tv.vae_decode(tparams, z, cfg, out_layout="NCDHW"),
                               tv.vae_decode(tparams, z, cfg).permute(0, 4, 1, 2, 3))


@pytest.mark.parametrize("t", [1, 5, 9])
def test_haar_roundtrip_and_match(t):
    x = np.random.default_rng(t).standard_normal((1, 3, t, 8, 8)).astype(np.float32)
    got = tv.haar_patch(torch.from_numpy(x), 2)
    want = jv.haar_patch(jnp.asarray(x), 2, in_layout="NCDHW")  # emits NDHWC
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tv.haar_unpatch(got, 2, t).numpy(), x, rtol=1e-5, atol=1e-5)


def test_weight_carry_over_is_strict(jax_tree):
    tree = jax_tree
    broken = {**tree, "encoder": {k: v for k, v in tree["encoder"].items() if k != "norm_out"}}
    with pytest.raises(KeyError, match="encoder/norm_out"):
        vae_params_from_numpy(broken, TINY, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        vae_params_from_numpy({**tree, "extra": np.zeros(1)}, TINY, device="cpu")
    bf16 = vae_params_from_numpy(tree, TINY, device="cpu", dtype=torch.bfloat16)
    assert bf16["encoder"]["conv_in"]["conv_s"]["w"].dtype == torch.bfloat16
    assert bf16["encoder"]["norm_out"]["scale"].dtype == torch.float32
