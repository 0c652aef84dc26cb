"""The port's forward (relighting) render against the JAX package's, in fp32
on the CPU, on a tiny forward DiT (136 condition channels, no context
embedding) and the TINY VAE of tests/test_torch_pipeline.py with the same
weights:

* the conditions that forward_render hands to generate (the five
  G-buffers, and env_ldr, env_log, env_nrm as one frame (B, 1, H, W, 3))
  equal the JAX package's for every env_format, with flip and rotation, at
  1e-5;
* generate on the eight conditions with the same injected initial state
  (JAX's x_init_override) gives the same uint8 video within 1 count, at one
  frame and at 9 frames, where the one-frame env conditions are broadcast
  over time inside the condition encode;
* forward_render and load_hdr through the public API on the CPU."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu import api as japi
from diffusionrenderer_tpu import pipeline as jpipe
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.config import VAEConfig as JVAEConfig
from diffusionrenderer_tpu.config import get_forward_renderer_config as j_forward_cfg
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.models.vae import init_vae_params as j_init_vae
from diffusionrenderer_tpu.sampling.edm import edm_sigmas as j_sigmas
from diffusionrenderer_tpu_torch import api as tapi
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy, vae_params_from_numpy
from diffusionrenderer_tpu_torch.config import FORWARD_CONDITION_KEYS, DiTConfig, VAEConfig
from diffusionrenderer_tpu_torch.envmap import clear_environment_cache
from diffusionrenderer_tpu_torch.io import save_hdr
from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline

NET = DiTConfig(
    model_channels=96, num_blocks=2, num_heads=2, in_channels=16, out_channels=16,
    additional_concat_ch=17 * 8, adaln_lora_dim=8, crossattn_emb_channels=16,
    use_context_embedding=False,
)
TINY = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                 decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
STEPS = 3
H, W = 32, 48
GBUFFERS = ("depth", "normal", "roughness", "metallic", "basecolor")


@pytest.fixture(scope="module")
def weights():
    """JAX trees: the forward DiT from JAX's init, the VAE's structure from
    JAX's init traced and filled with seeded N(0, 1/fan_in) weights."""
    jd = j_init_dit(jax.random.key(0), JDiTConfig(**dataclasses.asdict(NET)), dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda key: j_init_vae(key, JVAEConfig(**dataclasses.asdict(TINY)), jnp.float32),
        jax.random.key(1))
    rng = np.random.default_rng(1)

    def fill(path, s):
        name = path[-1].key
        if name == "w":
            return jnp.asarray(rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1])),
                               jnp.float32)
        return jnp.ones(s.shape) if name in ("scale", "latents_std") else jnp.zeros(s.shape)

    return jd, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pipe(weights):
    jd, jv = weights
    return DiffusionRendererPipeline(
        dit_params_from_numpy(jax.device_get(jd), NET, device="cpu"),
        vae_params_from_numpy(jax.device_get(jv), TINY, device="cpu"),
        model_type="forward", num_steps=STEPS, net_config=NET, vae_config=TINY)


def gbuffers(t, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    shape = (1, t, H, W, 3) if t > 1 else (1, H, W, 3)
    if dtype == np.uint8:
        return {k: rng.integers(0, 256, shape, dtype=np.uint8) for k in GBUFFERS}
    return {k: rng.uniform(size=shape).astype(np.float32) for k in GBUFFERS}


def panorama(seed, h=32, w=64):
    rng = np.random.default_rng(seed)
    pano = (np.abs(rng.standard_normal((h, w, 3))) * 50.0).astype(np.float32)
    pano[2, 3] = [np.nan, np.inf, 1.0]
    return pano


class Capture:
    """Stands in for a pipeline: records what forward_render passes to
    generate and returns a black video."""

    device = torch.device("cpu")

    def set_model_type(self, model_type):
        self.model_type = model_type

    def generate(self, data_batch, seed=None):
        self.batch = {k: np.asarray(v) for k, v in data_batch.items()}
        b, t, h, w, _ = self.batch["depth"].shape
        return np.zeros((b, t, h, w, 3), np.uint8)


@pytest.mark.parametrize("env_format,flip,rot", [("proj", False, 180.0), ("proj", True, 90.0),
                                                 ("proj_direct", True, 180.0),
                                                 ("ball", False, 180.0)])
def test_forward_render_builds_the_conditions_jax_builds(env_format, flip, rot):
    g = gbuffers(3, seed=1)
    env = panorama(2)
    kw = dict(guidance=0.0, seed=3, env_format=env_format, env_brightness=1.5,
              env_flip_horizontal=flip, env_rotation=rot)
    got, want = Capture(), Capture()
    clear_environment_cache()
    out = tapi.forward_render(got, *(g[k] for k in GBUFFERS), env, **kw)
    japi.forward_render(want, *(g[k] for k in GBUFFERS), env, **kw)
    assert got.model_type == "forward" and out.shape == (3, H, W, 3)
    assert sorted(got.batch) == sorted(want.batch)
    for key in (*GBUFFERS, "video"):
        np.testing.assert_array_equal(got.batch[key], want.batch[key])
    for key in ("env_ldr", "env_log", "env_nrm"):
        assert got.batch[key].shape == (1, 1, H, W, 3), key
        np.testing.assert_allclose(got.batch[key], want.batch[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("frames", [1, 9])
def test_forward_generate_matches_jax(weights, pipe, frames):
    """Eight conditions (five G-buffers over the clip's frames, three env
    maps as one frame) -> encode -> EDM Euler -> decode, with the same
    initial state in both packages."""
    jd, jv = weights
    rng = np.random.default_rng(frames)
    conds = {k: rng.uniform(-1, 1, (1, frames, H, W, 3)).astype(np.float32) for k in GBUFFERS}
    for k in ("env_ldr", "env_log", "env_nrm"):
        conds[k] = rng.uniform(-1, 1, (1, 1, H, W, 3)).astype(np.float32)
    cfg = j_forward_cfg(H, W, frames, net=JDiTConfig(**dataclasses.asdict(NET)),
                        vae=JVAEConfig(**dataclasses.asdict(TINY)), compute_dtype="float32")
    lt = cfg.latent_shape[1]
    x_init = (rng.standard_normal((1, lt, H // 8, W // 8, 16)).astype(np.float32)
              * float(j_sigmas(STEPS)[0]))
    want = np.asarray(jpipe._generate_jit(
        jd, jv, tuple(jnp.asarray(conds[k].transpose(0, 4, 1, 2, 3)) for k in cfg.condition_keys),
        jnp.zeros((1,), jnp.int32), jax.random.key(0), jnp.asarray(0.0, jnp.float32),
        jnp.zeros((1,), jnp.float32), jnp.asarray(x_init), cfg=cfg, num_steps=STEPS,
        use_cfg=False, present=(True,) * len(cfg.condition_keys)))

    assert tuple(cfg.condition_keys) == FORWARD_CONDITION_KEYS
    pipe.guidance = 0.0
    got = pipe.generate(conds, x_init=torch.from_numpy(x_init))
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, frames, H, W, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("env_format", ["proj", "proj_direct", "ball"])
def test_api_forward_render_on_cpu(tmp_path, env_format):
    pipe = tapi.load_pipeline(model_type="forward", net_config=NET, vae_config=TINY, num_steps=2,
                              dtype=torch.float32, device="cpu")
    path = str(tmp_path / "env.hdr")
    save_hdr(path, np.nan_to_num(panorama(4), posinf=1e3))
    env = tapi.load_hdr(path)
    assert env.shape == (1, 32, 64, 3)
    g = gbuffers(1, seed=5, dtype=np.float32)
    out = tapi.forward_render(pipe, *(g[k] for k in GBUFFERS), env, env_format=env_format)
    assert out.shape == (1, H, W, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0
    with pytest.raises(ValueError, match="env_format"):
        tapi.forward_render(pipe, *(g[k] for k in GBUFFERS), env, env_format="sphere")
