"""The port's inverse render end to end against the JAX package's staged
path, in fp32, on the tiny DiT of tests/test_golden_e2e.py and the TINY VAE
of tests/test_vae.py with the same weights and the same injected noise:
VAE encode -> 5-pass batched conditions -> EDM Euler loop -> decode ->
uint8.  The uint8 output must agree within 1 count (as
tests/test_golden_e2e.py).  Also: batched 5-pass equals serial, the API on
the CPU, resume_dir, and that the entry points refuse to run without CUDA
unless asked for the CPU."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu import pipeline as jpipe
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.config import VAEConfig as JVAEConfig
from diffusionrenderer_tpu.config import get_inverse_renderer_config as j_inverse_cfg
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.models.vae import init_vae_params as j_init_vae
from diffusionrenderer_tpu.sampling.edm import edm_sigmas as j_sigmas
from diffusionrenderer_tpu_torch.api import INVERSE_PASSES, inverse_render, load_pipeline
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy, vae_params_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig
from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline

NET = DiTConfig(
    model_channels=96, num_blocks=2, num_heads=2, in_channels=16, out_channels=16,
    additional_concat_ch=16, adaln_lora_dim=8, crossattn_emb_channels=16,
    use_context_embedding=True,
)
TINY = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                 decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
STEPS = 3
H, W = 32, 48


@pytest.fixture(scope="module")
def weights():
    """JAX parameter trees: the DiT's from JAX's init; the VAE's structure
    from JAX's init traced (not run: that takes seconds), filled with seeded
    numpy weights N(0, 1/fan_in) and identity norms and statistics."""
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
        model_type="inverse", num_steps=STEPS, net_config=NET, vae_config=TINY)


def image(seed):
    return np.random.default_rng(seed).uniform(size=(1, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("guidance", [0.0, 2.0])
def test_five_pass_inverse_matches_jax_staged(weights, pipe, guidance):
    jd, jv = weights
    n = len(INVERSE_PASSES)
    video = image(0)[:, None] * 2.0 - 1.0  # (1, 1, H, W, 3) in [-1, 1]
    cfg = j_inverse_cfg(H, W, 1, net=JDiTConfig(**dataclasses.asdict(NET)),
                        vae=JVAEConfig(**dataclasses.asdict(TINY)), compute_dtype="float32")
    ctx = np.arange(n, dtype=np.int32)  # basecolor .. depth
    mask = np.array([p == "normal" for p in INVERSE_PASSES], np.float32)
    noise = np.random.default_rng(1).standard_normal((1, 1, H // 8, W // 8, 16)).astype(np.float32)
    sig = np.asarray(j_sigmas(STEPS))
    x_init = np.tile(noise, (n, 1, 1, 1, 1)) * sig[0]

    lat = jpipe._encode_one_condition_jit(jv, jnp.asarray(video.transpose(0, 4, 1, 2, 3)),
                                          cfg=cfg)
    cond = jpipe._assemble_conditions_jit((lat,), cfg=cfg, present=(True,), tile=n)
    sample = jpipe._sample_segment_jit(
        jd, cond, jnp.asarray(ctx), jnp.asarray(x_init), jnp.asarray(guidance, jnp.float32),
        jnp.asarray(np.stack([sig[:-1], sig[1:]], axis=1)), cfg=cfg, use_cfg=guidance > 0)
    want = np.asarray(jpipe._decode_jit(jv, sample, jnp.asarray(mask), cfg=cfg))
    want = want.reshape(n, 1, H, W, 3)

    pipe.guidance = guidance
    got = pipe.generate({"rgb": video, "context_index": ctx}, normalize_normal=mask,
                        noise_tile=n, batch_tile=n, x_init=torch.from_numpy(x_init))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batched_equals_serial(pipe):
    img = image(2)
    a = inverse_render(pipe, img, batch_passes=True, seed=5)
    b = inverse_render(pipe, img, batch_passes=False, seed=5)
    for p in INVERSE_PASSES:
        np.testing.assert_allclose(a[p], b[p], rtol=0, atol=1 / 255 + 1e-7, err_msg=p)


def test_per_row_seeds_reproduce_solo_runs(pipe):
    video = image(6)[:, None] * 2.0 - 1.0
    two = np.concatenate([video, video])
    batch = pipe.generate({"rgb": two, "context_index": np.array([0, 3])}, seed=[11, 12])
    for row, (seed, ctx) in enumerate(((11, 0), (12, 3))):
        solo = pipe.generate({"rgb": video, "context_index": np.array([ctx])}, seed=seed)
        assert np.abs(batch[row].astype(int) - solo[0].astype(int)).max() <= 1
    with pytest.raises(ValueError, match="per-row seeds"):
        pipe.generate({"rgb": two}, seed=[1, 2, 3])


def test_api_on_cpu_returns_five_unit_range_passes():
    pipe = load_pipeline(net_config=NET, vae_config=TINY, num_steps=2, dtype=torch.float32,
                         device="cpu")
    out = inverse_render(pipe, (image(3) * 255).astype(np.uint8))
    assert set(out) == set(INVERSE_PASSES)
    for v in out.values():
        assert v.shape == (1, H, W, 3) and v.dtype == np.float32
        assert 0.0 <= v.min() and v.max() <= 1.0


def test_resume_dir(pipe, tmp_path):
    img = image(4)
    plain = inverse_render(pipe, img, passes=("basecolor", "normal"), batch_passes=False)
    first = inverse_render(pipe, img, passes=("basecolor", "normal"), resume_dir=str(tmp_path))
    for p in plain:
        np.testing.assert_array_equal(first[p], plain[p])
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "basecolor.npy", "manifest.json", "normal.npy"]
    np.save(tmp_path / "normal.npy", np.zeros((1, 1, H, W, 3), np.uint8))
    again = inverse_render(pipe, img, passes=("basecolor", "normal"), resume_dir=str(tmp_path))
    assert again["normal"].max() == 0.0  # loaded from disk, not recomputed
    with pytest.raises(ValueError, match="different job"):
        inverse_render(pipe, img, seed=7, passes=("basecolor",), resume_dir=str(tmp_path))


def test_entry_points_need_cuda_or_an_explicit_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pipeline(net_config=NET, vae_config=TINY)
    jd, jv = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        dit_params_from_numpy(jax.device_get(jd), NET)
    with pytest.raises(RuntimeError, match="CUDA"):
        vae_params_from_numpy(jax.device_get(jv), TINY)
    with pytest.raises(FileNotFoundError):
        load_pipeline(dit_checkpoint="model.pt", device="cpu")
