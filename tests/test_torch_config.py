"""The port's config module against the JAX package's: every preset's
fields, derived shapes, frame math, validation and config_hash agree."""

import dataclasses

import pytest

import diffusionrenderer_tpu.config as jcfg
import diffusionrenderer_tpu_torch.config as tcfg


@pytest.mark.parametrize("name", jcfg.PRESET_NAMES)
def test_presets_match(name):
    j, t = jcfg.get_preset_config(name), tcfg.get_preset_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.latent_shape == j.latent_shape
    assert t.net.patch_dim == j.net.patch_dim
    assert t.net.head_dim == j.net.head_dim
    assert t.net.hidden_dim == j.net.hidden_dim
    assert t.config_hash() == j.config_hash()
    tcfg.validate_config(t)


def test_preset_names_match():
    assert tcfg.PRESET_NAMES == jcfg.PRESET_NAMES
    assert tcfg.GBUFFER_INDEX_MAPPING == jcfg.GBUFFER_INDEX_MAPPING
    assert tcfg.FORWARD_CONDITION_KEYS == jcfg.FORWARD_CONDITION_KEYS


@pytest.mark.parametrize("frames", [1, 2, 9, 17, 57, 121])
def test_frame_math(frames):
    jv, tv = jcfg.VAEConfig(), tcfg.VAEConfig()
    assert tv.latent_num_frames(frames) == jv.latent_num_frames(frames)
    assert tv.pixel_num_frames(frames) == jv.pixel_num_frames(frames)


@pytest.mark.parametrize("model_type,shape", [
    ("inverse", (1, 3, 1, 512, 512)),
    ("forward", (2, 3, 9, 256, 384)),
])
def test_shape_derived_config(model_type, shape):
    j = jcfg.get_config_from_tensor_shape(model_type, shape, compute_dtype="float32")
    t = tcfg.get_config_from_tensor_shape(model_type, shape, compute_dtype="float32")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.config_hash() == j.config_hash()


def test_validation_rejects_what_jax_rejects():
    bad_net = {"net": tcfg.DiTConfig(additional_concat_ch=136)}
    with pytest.raises(ValueError, match="additional_concat_ch"):
        tcfg.validate_config(tcfg.get_inverse_renderer_config(**bad_net))
    with pytest.raises(ValueError, match="additional_concat_ch"):
        jcfg.validate_config(jcfg.get_inverse_renderer_config(
            net=jcfg.DiTConfig(additional_concat_ch=136)))
    with pytest.raises(ValueError, match="height"):
        tcfg.validate_config(tcfg.get_inverse_renderer_config(height=500))
    with pytest.raises(ValueError, match="Unknown model type"):
        tcfg.get_config_by_model_type("sideways")
