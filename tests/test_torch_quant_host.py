"""The port's convert-time quantizers (models/quant.py host half) and
calibration capture (models/calibrate.py) against the JAX package's, on a
tiny DiT in fp32 with the same weights and inputs.

The JAX host quantizers already run in torch; the port runs the same
operations on the same (K, N) contiguous layout, so the int8 codes, scales,
migration multipliers and '_mixN' block choices are bitwise equal.  The
captured statistics are fp32 reductions in another order: rtol 1e-5 with an
atol of 1e-5 of the largest entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models import calibrate as jcal
from diffusionrenderer_tpu.models import quant as jq
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models import calibrate as tcal
from diffusionrenderer_tpu_torch.models import quant as tq

NET = DiTConfig(
    model_channels=128, num_blocks=3, num_heads=2, in_channels=16, out_channels=16,
    additional_concat_ch=16, adaln_lora_dim=8, crossattn_emb_channels=16,
    use_context_embedding=True,
)


def jax_cfg(cfg):
    return JDiTConfig(**dataclasses.asdict(cfg))


def weight(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05
    w[3] *= 30.0
    return w


def assert_leaf_equal(got, want):
    """A port leaf (N, K codes) against a JAX leaf (K, N codes)."""
    assert set(got) == set(want)
    for key, v in want.items():
        v = np.asarray(v)
        g = got[key].numpy()
        np.testing.assert_array_equal(g.T if key == "q" else g, v, err_msg=key)


@pytest.mark.parametrize("kw", [
    {}, {"group_size": 64, "act_quant": True}, {"mse_clip": True}, {"hadamard": True},
    {"hadamard": True, "group_size": 128, "mse_clip": True},
], ids=lambda kw: "_".join(f"{k}{v}" for k, v in kw.items()) or "rtn")
def test_quantize_tensor_host_bitwise(kw):
    w = weight(256, 96, seed=1)
    di = np.random.default_rng(2).uniform(0.5, 2.0, 256).astype(np.float32)
    for migrate in (None, di):
        want = jq.quantize_tensor_host(w, migrate=migrate, **kw)
        got = tq.quantize_tensor_host(torch.from_numpy(w.T.copy()), migrate=migrate, **kw)
        assert_leaf_equal(got, want)


def stats(k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((300, k)).astype(np.float32) * rng.uniform(0.2, 3.0, k)
    return np.abs(x).mean(0).astype(np.float32), (x.T @ x).astype(np.float32)


@pytest.mark.parametrize("act_quant,group", [(False, None), (True, 64)])
def test_awq_and_gptq_host_bitwise(act_quant, group):
    w = weight(128, 80, seed=3)
    amean, h = stats(128, seed=4)
    tw = torch.from_numpy(w.T.copy())
    di_j = jq.awq_migration_host(torch.from_numpy(w), amean, act_quant=act_quant,
                                 group_size=group, ex2=np.diagonal(h).copy())
    di_t = tq.awq_migration_host(tw, amean, act_quant=act_quant, group_size=group,
                                 ex2=np.diagonal(h).copy())
    assert torch.equal(di_t, di_j)
    for mse in (False, True):
        want = jq.gptq_quantize_host(torch.from_numpy(w), torch.from_numpy(h),
                                     act_quant=act_quant, group_size=group, mse_clip=mse)
        got = tq.gptq_quantize_host(tw, torch.from_numpy(h), act_quant=act_quant,
                                    group_size=group, mse_clip=mse)
        assert_leaf_equal(got, want)


@pytest.mark.parametrize("mode", ["w8a8_awq_gptq_had", "w8_g64_awq", "w8a8_gptq_mse"])
def test_quantize_leaf_host_bitwise(mode):
    w = weight(128, 80, seed=5)
    amean, h = stats(128, seed=6)
    want = jq.quantize_leaf_host(w, jq.parse_quant_mode(mode), amean=amean, hessian=h)
    got = tq.quantize_leaf_host(torch.from_numpy(w.T.copy()), tq.parse_quant_mode(mode),
                                amean=amean, hessian=h)
    assert_leaf_equal(got, want)


@pytest.fixture(scope="module")
def model():
    """JAX params, the port's copy, DiT inputs, and both captures."""
    jparams = j_init_dit(jax.random.key(0), jax_cfg(NET), dtype=jnp.float32)
    tparams = dit_params_from_numpy(jax.device_get(jparams), NET, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, 8, 6, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 1, 8, 6, 16)).astype(np.float32)
    sigma = np.array([3.0, 0.5], np.float32)
    ctx = np.array([1, 4], np.int32)
    jstats = jcal.capture_dit_stats(jparams, jax_cfg(NET), jnp.asarray(x), jnp.asarray(sigma),
                                    jnp.asarray(cond), jnp.asarray(ctx))
    tstats = tcal.capture_dit_stats(tparams, NET, torch.from_numpy(x), torch.from_numpy(sigma),
                                    torch.from_numpy(cond), torch.from_numpy(ctx).long())
    return jparams, tparams, jstats, tstats


def test_capture_matches_jax(model):
    _, _, jstats, tstats = model
    assert set(tstats["amean"]) == set(jstats["amean"]) == set(tcal.ALL_SITES)
    assert set(tstats["h"]) == set(jstats["h"]) == set(tcal.DEFAULT_HESSIAN_SITES)
    for kind in ("amean", "h"):
        for site, want in jstats[kind].items():
            got = tstats[kind][site].numpy()
            assert got.shape == want.shape, (kind, site)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{kind} {site}")
    assert tstats["count"] == jstats["count"]
    merged = tcal.accumulate_stats(tstats, tstats)
    assert merged["count"]["fa.qkv"] == 2 * tstats["count"]["fa.qkv"]
    torch.testing.assert_close(merged["h"]["mlp.w1"], 2 * tstats["h"]["mlp.w1"])
    torch.testing.assert_close(merged["amean"]["fa.wo"], tstats["amean"]["fa.wo"])


@pytest.mark.parametrize("mode", ["w8a8_g64_mix1", "w8_keepres_mix2"])
def test_mix_block_damage_and_choice_match_jax(model, mode):
    jparams, tparams, jstats, _ = model
    jhost = jax.device_get(jparams)
    for calib in (None, jstats):
        want = jq.mix_block_damage(jhost, mode, calib)
        got = tq.mix_block_damage(tparams, mode, calib)
        np.testing.assert_array_equal(got, want)
        m = jq.parse_quant_mode(mode)
        assert tq._mix_bf16_set(tparams, tq.parse_quant_mode(mode), calib, NET.num_blocks) == \
            jq._mix_bf16_set(jhost, m, calib, NET.num_blocks)


@pytest.mark.parametrize("mode", ["w8a8_g64_awq_gptq", "w8_had_mix1", "w8a8_gptq_mix2"])
def test_quantize_dit_params_host_bitwise(model, mode):
    """Whole-tree host quantization with the captured stats, '_mixN' blocks
    included: the port's list of block dicts against JAX's segments."""
    jparams, tparams, jstats, _ = model
    want = jq.quantize_dit_params_host(jax.device_get(jparams), mode, jstats)
    got = tq.quantize_dit_params_host(tparams, mode, jstats)
    segs = want["blocks"] if isinstance(want["blocks"], tuple) else (want["blocks"],)
    jblocks = []
    for seg in segs:
        n = np.shape(seg["fa"]["adaln_w1"])[0]
        jblocks += [jax.tree.map(lambda a, i=i: np.asarray(a)[i], seg) for i in range(n)]
    assert len(got["blocks"]) == len(jblocks) == NET.num_blocks
    for bt, bj in zip(got["blocks"], jblocks):
        for sub, names in tq.QUANTIZED_BLOCK_WEIGHTS.items():
            for name in names:
                if tq.is_quantized(bt[sub][name]):
                    assert_leaf_equal(bt[sub][name], bj[sub][name])
                else:
                    assert not jq.is_quantized(bj[sub][name]), (sub, name)
                    np.testing.assert_array_equal(bt[sub][name].numpy().T, bj[sub][name])


def test_calibrated_modes_require_stats(model):
    _, tparams, _, _ = model
    with pytest.raises(ValueError, match="calibration"):
        tq.quantize_dit_params_host(tparams, "w8_awq")
    with pytest.raises(ValueError, match="hessian"):
        tq.quantize_dit_params_host(tparams, "w8_gptq", {"amean": {}, "h": {}})
