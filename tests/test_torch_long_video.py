"""The port's long-video machinery and its checkpoint-loaded pipeline
against the JAX package's, in fp32, on the TINY VAE and the tiny DiT of
tests/test_torch_pipeline.py: the four chunked VAE variants; the
pipeline's overlapped chunked decode of one latent sample (3 and 5 latent
frames, and 2 batch rows) within 1 uint8 count, with (T_lat-1)*8+1 frames;
encode / decode with the sigma_data scaling and reset_dtype; and
load_pipeline(dit_checkpoint, vae_checkpoint, vae_config_json) in both
packages followed by a generation with the same injected noise (the
unchunked render, and a 17-frame render decoded in chunks), equal within 1
uint8 count."""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from diffusionrenderer_tpu import api as japi
from diffusionrenderer_tpu import checkpoint as jckpt
from diffusionrenderer_tpu import pipeline as jpipe
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.config import VAEConfig as JVAEConfig
from diffusionrenderer_tpu.config import get_inverse_renderer_config as j_inverse_cfg
from diffusionrenderer_tpu.models import vae as jv
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.models.quant import quantize_dit_params as j_quantize
from diffusionrenderer_tpu.sampling.edm import edm_sigmas as j_sigmas
from diffusionrenderer_tpu_torch import api as tapi
from diffusionrenderer_tpu_torch.checkpoint import (_flatten, dit_params_from_numpy,
                                                    vae_params_from_numpy)
from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig, get_inverse_renderer_config
from diffusionrenderer_tpu_torch.models import vae as tv
from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline

NET = DiTConfig(
    model_channels=96, num_blocks=2, num_heads=2, in_channels=16, out_channels=16,
    additional_concat_ch=16, adaln_lora_dim=8, crossattn_emb_channels=16,
    use_context_embedding=True,
)
TINY = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                 decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
JNET, JTINY = JDiTConfig(**dataclasses.asdict(NET)), JVAEConfig(**dataclasses.asdict(TINY))
H, W, STEPS = 32, 48, 3


def assert_close(got, want, tol=1e-5):
    """max |got - want| within tol of the output's scale, max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= tol * max(1.0, np.abs(want).max()), err


def assert_u8_close(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def vae_trees():
    """The JAX VAE tree (structure from JAX's init traced, values seeded
    numpy: weights N(0, 1/fan_in), norm affines near identity, non-identity
    statistics) and the port's copy of it."""
    shapes = jax.eval_shape(lambda key: jv.init_vae_params(key, JTINY, jnp.float32),
                            jax.random.key(0))
    rng = np.random.default_rng(1)

    def fill(path, s):
        name = path[-1].key
        if name == "w":
            return (rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if name in ("scale", "latents_std"):
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    jtree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jtree, vae_params_from_numpy(jtree, TINY, device="cpu")


def video(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Chunked VAE variants
# ---------------------------------------------------------------------------

def test_batch_chunked_encode_and_decode_match_jax(vae_trees):
    jtree, tparams = vae_trees
    x = video((3, 9, 16, 16, 3), 0)
    z_want = np.asarray(jv.vae_encode_chunked(jtree, jnp.asarray(x), JTINY, max_batch=2))
    z_got = tv.vae_encode_chunked(tparams, torch.from_numpy(x), TINY, max_batch=2).numpy()
    assert z_got.shape == (3, 2, 2, 2, 16)
    assert_close(z_got, z_want)
    y_want = np.asarray(jv.vae_decode_chunked(jtree, jnp.asarray(z_want), JTINY, max_batch=2))
    y_got = tv.vae_decode_chunked(tparams, torch.from_numpy(np.array(z_want)), TINY,
                                  max_batch=2).numpy()
    assert y_got.shape == x.shape
    assert_close(y_got, y_want)
    # Micro-batching changes nothing row by row.
    whole = tv.vae_encode(tparams, torch.from_numpy(x), TINY).numpy()
    assert_close(z_got, whole)


def test_temporal_chunks_match_jax(vae_trees):
    jtree, tparams = vae_trees
    x = video((1, 18, 16, 16, 3), 1)  # two causal chunks of 9 frames
    z_want = np.asarray(jv.vae_encode_temporal_chunks(jtree, jnp.asarray(x), JTINY, 9,
                                                      max_batch=1))
    z_got = tv.vae_encode_temporal_chunks(tparams, torch.from_numpy(x), TINY, 9,
                                          max_batch=1).numpy()
    assert z_got.shape == (1, 4, 2, 2, 16)
    assert_close(z_got, z_want)
    y_want = np.asarray(jv.vae_decode_temporal_chunks(jtree, jnp.asarray(z_want), JTINY, 2))
    y_got = tv.vae_decode_temporal_chunks(tparams, torch.from_numpy(np.array(z_want)), TINY,
                                          2).numpy()
    assert y_got.shape == x.shape
    assert_close(y_got, y_want)
    with pytest.raises(ValueError, match="divisible"):
        tv.vae_encode_temporal_chunks(tparams, torch.from_numpy(x), TINY, 7)


# ---------------------------------------------------------------------------
# The pipeline's overlapped decode, encode / decode, reset_dtype
# ---------------------------------------------------------------------------

def pipelines(vae_trees, jdit=None, tdit=None):
    jtree, tparams = vae_trees
    jp = jpipe.DiffusionRendererPipeline(jdit or {}, jtree, model_type="inverse",
                                         net_config=JNET, vae_config=JTINY,
                                         compute_dtype="float32")
    tp = DiffusionRendererPipeline(tdit or {}, tparams, model_type="inverse",
                                   net_config=NET, vae_config=TINY)
    return jp, tp


@pytest.mark.parametrize("rows,t_lat,chunk", [(1, 3, 2), (1, 5, 3), (2, 3, 2)])
def test_overlapped_decode_matches_jax(vae_trees, rows, t_lat, chunk):
    jp, tp = pipelines(vae_trees)
    frames = (t_lat - 1) * 8 + 1
    jcfg = j_inverse_cfg(16, 16, frames, net=JNET, vae=JTINY, compute_dtype="float32")
    tcfg = get_inverse_renderer_config(16, 16, frames, net=NET, vae=TINY,
                                       compute_dtype="float32")
    sample = np.random.default_rng(t_lat).standard_normal((rows, t_lat, 2, 2, 16)
                                                          ).astype(np.float32) * 0.5
    mask = np.array([0.0, 1.0][:rows], np.float32)
    want = jp._decode_overlapped(jnp.asarray(sample), jnp.asarray(mask), jcfg, chunk)
    want = np.asarray(want).reshape(rows, frames, 16, 16, 3)
    got = tp._decode_overlapped(torch.from_numpy(sample), torch.from_numpy(mask), tcfg, chunk)
    assert got.shape == (rows, frames, 16, 16, 3)
    assert_u8_close(got, want)
    # The first chunk's frames are the unchunked decode's of its latents.
    from diffusionrenderer_tpu_torch.pipeline import decode

    first = decode(tp.vae_params, torch.from_numpy(sample[:1, :chunk]),
                   torch.from_numpy(mask[:1]), cfg=tcfg).numpy()
    np.testing.assert_array_equal(got[:1, :first.shape[1]], first)


def test_encode_decode_scale_by_sigma_data_like_jax(vae_trees):
    jp, tp = pipelines(vae_trees)
    x = video((1, 9, 16, 16, 3), 2)
    z_want = np.asarray(jp.encode(jnp.asarray(x)))
    z_got = tp.encode(torch.from_numpy(x)).numpy()
    assert_close(z_got, z_want)
    assert_close(z_got, tv.vae_encode(tp.vae_params, torch.from_numpy(x), TINY).numpy() * 0.5)
    assert_close(tp.decode(torch.from_numpy(np.array(z_want))).numpy(),
                 np.asarray(jp.decode(jnp.asarray(z_want))))


def test_reset_dtype_matches_jax(vae_trees):
    jd = j_quantize(j_init_dit(jax.random.key(0), JNET, dtype=jnp.float32), act_quant=True,
                    group_size=32)
    jp, tp = pipelines(vae_trees, jd, dit_params_from_numpy(jax.device_get(jd), NET,
                                                            device="cpu"))
    jp.vae_params = jax.tree.map(jnp.asarray, jp.vae_params)
    jp.reset_dtype(jnp.bfloat16)
    tp.reset_dtype(torch.bfloat16)
    jleaves = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): x
               for path, x in jax.tree_util.tree_leaves_with_path(jp.dit_params)}
    got = _flatten(tp.dit_params)
    seen = set()
    for key, t in got.items():
        parts = key.split("/")
        jkey = "/".join(parts[:1] + parts[2:]) if parts[0] == "blocks" else key
        assert str(t.dtype).replace("torch.", "") == str(jleaves[jkey].dtype), key
        seen.add(str(t.dtype))
    assert {"torch.int8", "torch.float32", "torch.bfloat16"} <= seen
    jv_leaves = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): x
                 for path, x in jax.tree_util.tree_leaves_with_path(jp.vae_params)}
    for key, t in _flatten(tp.vae_params).items():
        assert str(t.dtype).replace("torch.", "") == str(jv_leaves[key].dtype), key


# ---------------------------------------------------------------------------
# load_pipeline from checkpoints, then a generation, in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, vae_trees):
    """A reference-format DiT file, a diffusers VAE directory (config.json
    with one statistics table) and a second config.json whose table
    replaces it, plus both packages' pipelines loaded from them."""
    root = tmp_path_factory.mktemp("ckpt")
    jd = j_init_dit(jax.random.key(3), JNET, dtype=jnp.float32)
    dit = str(root / "dit.safetensors")
    np_save_file(jckpt.export_dit_state_dict(jd, JNET), dit)
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_vae_oracle import oracle_from_vae_config

    rng = np.random.default_rng(4)
    sd = {}
    for name, t in oracle_from_vae_config(TINY).state_dict().items():
        shape = tuple(t.shape)
        if "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("weight"):
            v = rng.standard_normal(shape) / math.sqrt(math.prod(shape[1:]))
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    vae = root / "vae"
    vae.mkdir()
    np_save_file(sd, str(vae / "diffusion_pytorch_model.safetensors"))
    tables = []
    for seed in (5, 6):
        r = np.random.default_rng(seed)
        tables.append({"latents_mean": (0.2 * r.standard_normal(256)).tolist(),
                       "latents_std": r.uniform(0.7, 1.3, 256).tolist()})
    (vae / "config.json").write_text(json.dumps(tables[0]))
    override = root / "vae_config.json"
    override.write_text(json.dumps(tables[1]))
    kw = dict(dit_checkpoint=dit, vae_checkpoint=str(vae), vae_config_json=str(override),
              num_steps=STEPS, net_config=NET, vae_config=TINY)
    jpipe_ = japi.load_pipeline(**{**kw, "net_config": JNET, "vae_config": JTINY},
                                dtype=jnp.float32)
    tpipe = tapi.load_pipeline(**kw, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tpipe.vae_params["latents_std"].numpy().reshape(-1),
                                  np.asarray(tables[1]["latents_std"], np.float32))
    return jpipe_, tpipe


def test_load_pipeline_loads_the_same_weights(checkpoints):
    jp, tp = checkpoints
    want = _flatten(dit_params_from_numpy(jax.device_get(jp.dit_params), NET, device="cpu"))
    for k, v in _flatten(tp.dit_params).items():
        assert torch.equal(v, want[k]), k
    want = _flatten(vae_params_from_numpy(jax.device_get(jp.vae_params), TINY, device="cpu"))
    for k, v in _flatten(tp.vae_params).items():
        assert torch.equal(v, want[k]), k


def _sigmas():
    return np.asarray(j_sigmas(STEPS))


def test_generate_from_checkpoints_matches_jax(checkpoints):
    jp, tp = checkpoints
    frames = 9
    x = video((1, frames, H, W, 3), 7)
    cfg = j_inverse_cfg(H, W, frames, net=JNET, vae=JTINY, compute_dtype="float32")
    lt = cfg.latent_shape[1]
    x_init = (np.random.default_rng(8).standard_normal((1, lt, H // 8, W // 8, 16))
              .astype(np.float32) * float(_sigmas()[0]))
    want = np.asarray(jpipe._generate_jit(
        jp.dit_params, jp.vae_params, (jnp.asarray(x.transpose(0, 4, 1, 2, 3)),),
        jnp.array([2], jnp.int32), jax.random.key(0), jnp.asarray(0.0, jnp.float32),
        jnp.zeros((1,), jnp.float32), jnp.asarray(x_init), cfg=cfg, num_steps=STEPS,
        use_cfg=False, present=(True,)))
    tp.guidance = 0.0
    got = tp.generate({"rgb": x, "context_index": np.array([2])}, x_init=torch.from_numpy(x_init))
    assert got.shape == (1, frames, H, W, 3)
    assert_u8_close(got, want)


def test_chunked_generate_from_checkpoints_matches_jax(checkpoints):
    """A 17-frame render (3 latent frames) decoded in chunks of 2 latents,
    against JAX's staged path with its _decode_overlapped."""
    jp, tp = checkpoints
    frames = 17
    x = video((1, frames, H, W, 3), 9)
    cfg = j_inverse_cfg(H, W, frames, net=JNET, vae=JTINY, compute_dtype="float32")
    sig = _sigmas()
    x_init = (np.random.default_rng(10).standard_normal((1, 3, H // 8, W // 8, 16))
              .astype(np.float32) * float(sig[0]))
    lat = jpipe._encode_one_condition_jit(jp.vae_params, jnp.asarray(x.transpose(0, 4, 1, 2, 3)),
                                          cfg=cfg)
    cond = jpipe._assemble_conditions_jit((lat,), cfg=cfg, present=(True,))
    sample = jpipe._sample_segment_jit(
        jp.dit_params, cond, jnp.array([1], jnp.int32), jnp.asarray(x_init),
        jnp.asarray(0.0, jnp.float32), jnp.asarray(np.stack([sig[:-1], sig[1:]], axis=1)),
        cfg=cfg, use_cfg=False)
    want = jp._decode_overlapped(sample, jnp.zeros((1,), jnp.float32), cfg, 2)
    want = np.asarray(want).reshape(1, frames, H, W, 3)
    tp.decode_chunk_frames = 2
    try:
        got = tp.generate({"rgb": x, "context_index": np.array([1])},
                          x_init=torch.from_numpy(x_init))
    finally:
        tp.decode_chunk_frames = None
    assert got.shape == (1, frames, H, W, 3)
    assert_u8_close(got, want)
