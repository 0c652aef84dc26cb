"""The port's VAE checkpoint I/O against the JAX package's, on the TINY VAE
in fp32: a diffusers AutoencoderKLCosmos state dict (the key layout of
tests/torch_vae_oracle.py, filled with numpy-seeded values) saved as a
directory with config.json, and as a bare safetensors file, loads in both
packages to the same parameters, and encode / decode agree within 1e-5 of
the outputs' scale;
the norm_nesting hint, the bundled latent statistics, the convention
calibration with injected encode / decode, and native files (the port's,
and the JAX package's DHWIO ones) behave as in JAX."""

import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from diffusionrenderer_tpu import checkpoint_vae as jcv
from diffusionrenderer_tpu.config import VAEConfig as JVAEConfig
from diffusionrenderer_tpu.models import vae as jv
from diffusionrenderer_tpu_torch import checkpoint_vae as tcv
from diffusionrenderer_tpu_torch.checkpoint import _flatten, vae_params_from_numpy
from diffusionrenderer_tpu_torch.config import VAEConfig
from diffusionrenderer_tpu_torch.models import vae as tv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_vae_oracle import oracle_from_vae_config  # noqa: E402

TINY = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                 decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
JTINY = JVAEConfig(**dataclasses.asdict(TINY))


def assert_close(got, want, tol=1e-5):
    """max |got - want| within tol of the output's scale, max(1, max |want|):
    fp32 sums in another order through ~20 convolutions, at outputs of a
    few units."""
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= tol * max(1.0, np.abs(want).max()), err


def diffusers_state_dict(cfg, seed=0):
    """The diffusers key layout and shapes of the oracle, with seeded numpy
    values: weights N(0, 1/fan_in), norm affines near identity, small
    biases, so that every parameter's use is checked."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in oracle_from_vae_config(cfg).state_dict().items():
        shape = tuple(t.shape)
        if "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name.endswith("weight"):
            v = rng.standard_normal(shape) / math.sqrt(math.prod(shape[1:]))
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def stats(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(256).astype(np.float32).tolist(),
            rng.uniform(0.5, 1.5, 256).astype(np.float32).tolist())


def write_diffusers_dir(root, sd, with_stats=True, name="diffusion_pytorch_model.safetensors"):
    os.makedirs(root, exist_ok=True)
    np_save_file(sd, os.path.join(root, name))
    config = {"_class_name": "AutoencoderKLCosmos", "latent_channels": 16}
    if with_stats:
        config["latents_mean"], config["latents_std"] = stats()
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    return root


def assert_same_params(tparams, jtree):
    want = _flatten(vae_params_from_numpy(jax.device_get(jtree), TINY, device="cpu"))
    got = _flatten(tparams)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def encode_decode_both(tparams, jtree, seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    z_want = np.asarray(jv.vae_encode(jtree, jnp.asarray(x), JTINY))
    z_got = tv.vae_encode(tparams, torch.from_numpy(x), TINY).numpy()
    assert_close(z_got, z_want)
    y_want = np.asarray(jv.vae_decode(jtree, jnp.asarray(z_want), JTINY))
    y_got = tv.vae_decode(tparams, torch.from_numpy(np.array(z_want)), TINY).numpy()
    assert_close(y_got, y_want)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A diffusers directory of the seeded state dict, and the JAX
    package's load of it (its converter takes seconds: once per module)."""
    sd = diffusers_state_dict(TINY)
    path = write_diffusers_dir(str(tmp_path_factory.mktemp("vae")), sd)
    return sd, path, jcv.load_vae_checkpoint(path, JTINY, jnp.float32)


def test_diffusers_directory_loads_like_jax(jax_dir):
    _, path, jtree = jax_dir
    tparams = tcv.load_vae_checkpoint(path, TINY, torch.float32, device="cpu")
    assert_same_params(tparams, jtree)
    mean, _ = stats()
    np.testing.assert_array_equal(tparams["latents_mean"].numpy().reshape(-1), mean)
    encode_decode_both(tparams, jtree)


def test_model_safetensors_name_and_bare_file_load_like_jax(tmp_path, jax_dir):
    sd, _, jtree = jax_dir
    path = write_diffusers_dir(str(tmp_path / "vae"), sd, name="model.safetensors")
    assert_same_params(tcv.load_vae_checkpoint(path, TINY, torch.float32, device="cpu"), jtree)
    bare = str(tmp_path / "vae.safetensors")
    np_save_file(sd, bare)
    jbare = jcv.load_vae_checkpoint(bare, JTINY, jnp.float32)
    tbare = tcv.load_vae_checkpoint(bare, TINY, torch.float32, device="cpu")
    assert_same_params(tbare, jbare)
    assert bool((tbare["latents_std"] == 1).all())  # non-flagship: identity kept


def test_bf16_load_keeps_norms_and_stats_fp32(jax_dir):
    _, path, _ = jax_dir
    tparams = tcv.load_vae_checkpoint(path, TINY, torch.bfloat16, device="cpu")
    assert tparams["encoder"]["conv_in"]["conv_s"]["w"].dtype == torch.bfloat16
    assert tparams["encoder"]["conv_in"]["conv_s"]["b"].dtype == torch.bfloat16
    assert tparams["encoder"]["norm_out"]["scale"].dtype == torch.float32
    assert tparams["latents_mean"].dtype == torch.float32


@pytest.mark.parametrize("edit", ["missing", "extra"])
def test_strict_keys_raise_like_jax(edit):
    sd = diffusers_state_dict(TINY)
    if edit == "missing":
        del sd["decoder.mid_block.attentions.0.to_q.weight"]
        exc = KeyError
    else:
        sd["decoder.bogus.weight"] = np.zeros(3, np.float32)
        exc = ValueError
    with pytest.raises(exc) as want:
        jcv.convert_diffusers_vae_state_dict(sd, JTINY, jnp.float32)
    with pytest.raises(exc) as got:
        tcv.convert_diffusers_vae_state_dict(sd, TINY, torch.float32, device="cpu")
    assert str(got.value) == str(want.value)


def test_flat_norm_convention_raises_the_hint_like_jax():
    sd = diffusers_state_dict(TINY)
    sd["encoder.norm_out.weight"] = sd.pop("encoder.norm_out.norm.weight")
    sd["encoder.norm_out.bias"] = sd.pop("encoder.norm_out.norm.bias")
    with pytest.raises(KeyError, match="norm_nesting") as want:
        jcv.convert_diffusers_vae_state_dict(sd, JTINY, jnp.float32)
    with pytest.raises(KeyError, match="norm_nesting") as got:
        tcv.convert_diffusers_vae_state_dict(sd, TINY, torch.float32, device="cpu")
    assert str(got.value) == str(want.value)
    # With the switch flipped, every norm is read flat.
    flat = {k.replace(".norm.weight", ".weight").replace(".norm.bias", ".bias")
            if ".norm." in k and "group_norm" not in k else k: v for k, v in sd.items()}
    flat_cfg = dataclasses.replace(TINY, norm_nesting="flat")
    jtree = jcv.convert_diffusers_vae_state_dict(
        flat, JVAEConfig(**dataclasses.asdict(flat_cfg)), jnp.float32)
    tparams = tcv.convert_diffusers_vae_state_dict(flat, flat_cfg, torch.float32, device="cpu")
    assert_same_params(tparams, jtree)


# ---------------------------------------------------------------------------
# Latent statistics
# ---------------------------------------------------------------------------

def identity_params():
    return {"latents_mean": torch.zeros(16, 16), "latents_std": torch.ones(16, 16)}


def test_bundled_table_is_the_jax_packages():
    assert tcv.bundled_latent_stats() == jcv.bundled_latent_stats()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "data/cosmos_cv8x8x8_latent_stats.json"
    with open(os.path.join(root, "diffusionrenderer_tpu", name), "rb") as a, \
            open(os.path.join(root, "diffusionrenderer_tpu_torch", name), "rb") as b:
        assert a.read() == b.read()


def test_flagship_detection_like_jax():
    for cfg in (VAEConfig(), TINY, dataclasses.replace(VAEConfig(), max_latent_frames=8)):
        assert tcv._is_flagship_vae(cfg) == jcv._is_flagship_vae(
            JVAEConfig(**dataclasses.asdict(cfg)))
    assert tcv._is_flagship_vae(VAEConfig()) and not tcv._is_flagship_vae(TINY)


@pytest.mark.parametrize("case", ["flagship_identity", "flagship_loaded", "non_flagship"])
def test_ensure_latent_stats_like_jax(case):
    params = identity_params()
    if case == "flagship_loaded":
        params["latents_mean"] = torch.full((16, 16), 0.25)
    cfg = TINY if case == "non_flagship" else VAEConfig()
    got = tcv.ensure_latent_stats(params, cfg)
    want = jcv.ensure_latent_stats({k: v.numpy() for k, v in params.items()},
                                   JVAEConfig(**dataclasses.asdict(cfg)))
    for k in ("latents_mean", "latents_std"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if case == "flagship_identity":
        table = tcv.bundled_latent_stats()
        np.testing.assert_array_equal(got["latents_std"].numpy().reshape(-1),
                                      np.asarray(table["latents_std"], np.float32))


def test_load_latent_stats_matches_jax():
    mean, std = stats(5)
    tparams = tv.load_latent_stats(identity_params(), mean, std, TINY)
    jparams = jv.load_latent_stats({}, mean, std, JTINY)
    np.testing.assert_array_equal(tparams["latents_mean"].numpy(), np.asarray(jparams["latents_mean"]))
    np.testing.assert_array_equal(tparams["latents_std"].numpy(), np.asarray(jparams["latents_std"]))
    assert tparams["latents_mean"].dtype == torch.float32


def test_identity_stats_on_a_flagship_vae_are_refused():
    with pytest.raises(ValueError, match="identity latents_mean/std"):
        tcv.refuse_identity_stats(identity_params(), VAEConfig(), "vae.safetensors")
    tcv.refuse_identity_stats(identity_params(), TINY, "vae.safetensors")  # no table: allowed
    loaded = tcv.ensure_latent_stats(identity_params(), VAEConfig())
    tcv.refuse_identity_stats(loaded, VAEConfig(), "vae.safetensors")


# ---------------------------------------------------------------------------
# Calibration (tests/test_vae_conventions.py's cases, with injected functions)
# ---------------------------------------------------------------------------

def test_calibration_passes_on_a_perfect_roundtrip():
    errs = tcv.calibrate_vae_conventions(
        {}, TINY, encode_fn=lambda x: x[..., :1] * 2.0,
        decode_fn=lambda z: (z / 2.0).repeat_interleave(3, dim=-1))
    want = jcv.calibrate_vae_conventions(
        {}, JTINY, encode_fn=lambda x: x[..., :1] * 2.0,
        decode_fn=lambda z: jnp.repeat(z / 2.0, 3, axis=-1))
    assert errs == want and max(errs.values()) < 1e-6


@pytest.mark.parametrize("scale,shift,names", [(20.0, 0.0, "dwt_rescale"),
                                               (1.0, 0.9, "stats_location")])
def test_calibration_names_the_suspect_like_jax(scale, shift, names):
    with pytest.raises(jcv.VAECalibrationError, match=names) as want:
        jcv.calibrate_vae_conventions(
            {}, JTINY, encode_fn=lambda x: x[..., :1] * scale + shift,
            decode_fn=lambda z: jnp.repeat(z, 3, axis=-1))
    with pytest.raises(tcv.VAECalibrationError, match=names) as got:
        tcv.calibrate_vae_conventions(
            {}, TINY, encode_fn=lambda x: x[..., :1] * scale + shift,
            decode_fn=lambda z: z.repeat_interleave(3, dim=-1))
    assert str(got.value) == str(want.value)


def test_calibration_fails_random_weights():
    tparams = tv.init_vae_params(TINY, device="cpu", dtype=torch.float32, seed=0)
    with pytest.raises(tcv.VAECalibrationError):
        tcv.calibrate_vae_conventions(tparams, TINY, size=16)


# ---------------------------------------------------------------------------
# Native files
# ---------------------------------------------------------------------------

def test_jax_native_file_loads_in_the_port(tmp_path, jax_dir):
    _, _, jtree = jax_dir
    native = str(tmp_path / "jax_native.safetensors")
    jcv.save_vae_native(native, jtree)
    tparams = tcv.load_vae_checkpoint(native, TINY, torch.float32, device="cpu")
    assert_same_params(tparams, jtree)
    encode_decode_both(tparams, jtree, seed=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_native_round_trip_is_bitwise(tmp_path, jax_dir, dtype):
    _, path, _ = jax_dir
    tparams = tcv.load_vae_checkpoint(path, TINY, dtype, device="cpu")
    native = str(tmp_path / "native.safetensors")
    tcv.save_vae_native(native, tparams)
    back = tcv.load_vae_checkpoint(native, TINY, dtype, device="cpu")
    a, b = _flatten(tparams), _flatten(back)
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        assert b[k].dtype == v.dtype and torch.equal(b[k], v), k


def test_orbax_directory_is_refused(tmp_path, jax_dir):
    _, _, jtree = jax_dir
    path = str(tmp_path / "orbax_vae")
    from diffusionrenderer_tpu.checkpoint import save_native

    save_native(path, jtree)
    with pytest.raises(ValueError, match="orbax"):
        tcv.load_vae_checkpoint(path, TINY, torch.float32, device="cpu")


def test_export_is_the_converters_inverse(jax_dir):
    """export_diffusers_vae_state_dict gives back the diffusers dict, every
    key of the oracle's module tree and no other."""
    sd, path, _ = jax_dir
    tparams = tcv.load_vae_checkpoint(path, TINY, torch.float32, device="cpu")
    out = tcv.export_diffusers_vae_state_dict(tparams, TINY)
    assert sorted(out) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)
