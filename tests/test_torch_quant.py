"""The port's quantized DiT (models/quant.py runtime half, checkpoint carry-over
of quantized trees, the quantized dit_forward and generate) against the JAX
package's, in fp32, on numpy-seeded inputs given to both.

* quantize_tensor (RTN per channel and grouped, '_mse', '_had', migration):
  the int8 codes and fp32 scales are bitwise equal to JAX's (transposed to
  the port's (out, in) layout).  Both round half to even; the Hadamard
  einsum flips no code on these inputs.
* dense_maybe_quantized for every leaf kind: 2e-5 (fp32 sums in another
  order; the int8 codes of the W8A8 activations agree exactly here).
* dit_forward of a tiny DiT under w8, w8_g64, w8a8 and w8a8_g64, the
  quantized tree carried by checkpoint.dit_params_from_numpy: 2e-5 for the
  weight-only modes; relative L2 <= 1e-3 for W8A8, where an fp32 ulp of
  difference in a block's input can move an int8 activation code across a
  .5 boundary (measured here: relative L2 1.6e-7 at most, so no code
  flipped; one flip would move it to ~1e-3).
* A tiny 5-pass generate under w8a8_g64 with injected noise: uint8 within
  1 count."""

import dataclasses
import functools
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
from diffusionrenderer_tpu.models import quant as jq
from diffusionrenderer_tpu.models.dit import dit_forward as j_dit_forward
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.models.vae import init_vae_params as j_init_vae
from diffusionrenderer_tpu.sampling.edm import edm_sigmas as j_sigmas
from diffusionrenderer_tpu_torch.api import load_pipeline
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy, vae_params_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig
from diffusionrenderer_tpu_torch.models import quant as tq
from diffusionrenderer_tpu_torch.models.dit import dit_forward
from diffusionrenderer_tpu_torch.ops import quant_matmul as tqm
from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline

NET = DiTConfig(
    model_channels=128, num_blocks=2, num_heads=2, in_channels=16, out_channels=16,
    additional_concat_ch=16, adaln_lora_dim=8, crossattn_emb_channels=16,
    use_context_embedding=True,
)
MODES = ["w8", "w8_g64", "w8a8", "w8a8_g64"]


def jax_cfg(cfg):
    return JDiTConfig(**dataclasses.asdict(cfg))


def weight(k, n, seed):
    """A (K, N) weight in JAX's layout with an outlier row."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05
    w[3] *= 30.0
    return w


def port_leaf(jleaf):
    """A JAX quantized leaf (K, N codes) in the port's (N, K) layout."""
    return {k: torch.from_numpy(np.asarray(v).T.copy() if k == "q" else np.asarray(v).copy())
            for k, v in jleaf.items()}


@pytest.mark.parametrize("mode", ["w8", "w8a8_g128_keepres_mse_had_awq_gptq_mix4",
                                  "w8a8_keepattn", "w8_g32", "w8a8_mix12"])
def test_parse_quant_mode_matches_jax(mode):
    assert tuple(tq.parse_quant_mode(mode)) == tuple(jq.parse_quant_mode(mode))
    assert tq.parse_quant_mode(mode).needs_calibration == jq.parse_quant_mode(
        mode).needs_calibration


def test_parse_quant_mode_refuses_unknown():
    for bad in ("w4", "w8_g", "w8a8_bogus"):
        with pytest.raises(ValueError):
            tq.parse_quant_mode(bad)


@pytest.mark.parametrize("kw", [
    {}, {"act_quant": True}, {"group_size": 128}, {"group_size": 64, "act_quant": True},
    {"mse_clip": True}, {"group_size": 64, "mse_clip": True}, {"hadamard": True},
    {"hadamard": True, "group_size": 128, "act_quant": True}, {"group_size": 1000},
], ids=lambda kw: "_".join(f"{k}{v}" for k, v in kw.items()) or "rtn")
def test_quantize_tensor_bitwise_equal_to_jax(kw):
    w = weight(512, 384, seed=len(kw))
    want = jq.quantize_tensor(jnp.asarray(w), **kw)
    got = tq.quantize_tensor(torch.from_numpy(w.T.copy()), **kw)
    assert set(got) == set(want)
    for key, v in port_leaf(want).items():
        assert got[key].dtype == v.dtype, key
        assert torch.equal(got[key], v), key


def test_quantize_tensor_migration_bitwise_equal_to_jax():
    w = weight(256, 192, seed=9)
    di = np.random.default_rng(9).uniform(0.5, 2.0, 256).astype(np.float32)
    want = jq.quantize_tensor(jnp.asarray(w), act_quant=True, migrate=jnp.asarray(di))
    got = tq.quantize_tensor(torch.from_numpy(w.T.copy()), act_quant=True,
                             migrate=torch.from_numpy(di))
    for key, v in port_leaf(want).items():
        assert torch.equal(got[key], v), key


@pytest.mark.parametrize("group", [None, 64])
def test_dequantize_tensor_matches_jax(group):
    w = weight(256, 96, seed=2)
    jleaf = jq.quantize_tensor(jnp.asarray(w), group_size=group)
    want = np.asarray(jq.dequantize_tensor(jleaf, jnp.float32)).T
    got = tq.dequantize_tensor(port_leaf(jleaf), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    None, {}, {"group_size": 64}, {"act_quant": True}, {"act_quant": True, "group_size": 64},
    {"act_quant": True, "hadamard": True}, {"act_quant": True, "migrate": True},
    {"hadamard": True, "group_size": 128},
], ids=lambda kw: "bf16" if kw is None else
    ("_".join(f"{k}{v}" for k, v in kw.items()) or "w8"))
@pytest.mark.parametrize("rows", [(7,), (2, 600)])
def test_dense_maybe_quantized_matches_jax(kw, rows):
    k, n = 256, 192
    w = weight(k, n, seed=5)
    x = np.random.default_rng(6).standard_normal((*rows, k)).astype(np.float32)
    if kw is None:
        jw, tw = jnp.asarray(w), torch.from_numpy(w.T.copy())
    else:
        kw = dict(kw)
        if kw.pop("migrate", False):
            kw["migrate"] = jnp.asarray(np.random.default_rng(7).uniform(0.5, 2, k), jnp.float32)
        jw = jq.quantize_tensor(jnp.asarray(w), **kw)
        tw = port_leaf(jw)
    want = np.asarray(jq.dense_maybe_quantized(jnp.asarray(x), jw))
    tqm.reset_counts()
    got = tq.dense_maybe_quantized(torch.from_numpy(x), tw).numpy()
    assert tqm.LAUNCHES["quant_matmul_w8a8"] == 0  # CPU tensors never reach the kernel
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_activation_quantize_rounds_in_x_dtype():
    """The XLA-path counterpart multiplies x * inv in x's dtype (bf16 here),
    as JAX's _quantize_activation does: the same codes and dequant scales."""
    x = np.random.default_rng(3).standard_normal((64, 256)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jxq, jdq = jq._quantize_activation(jx)
    txq, tdq = tq._quantize_activation(tx)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tdq.numpy(), np.asarray(jdq))


def forward_both(mode, seed=0):
    m = tq.parse_quant_mode(mode)
    jparams = j_init_dit(jax.random.key(seed), jax_cfg(NET), dtype=jnp.float32)
    jparams = jq.quantize_dit_params(jparams, act_quant=m.act_quant, group_size=m.group_size)
    tparams = dit_params_from_numpy(jax.device_get(jparams), NET, device="cpu")
    rng = np.random.default_rng(seed)
    b, t, h, w = 2, 1, 8, 6
    x = rng.standard_normal((b, t, h, w, 16)).astype(np.float32)
    cond = rng.standard_normal((b, t, h, w, 16)).astype(np.float32)
    sigma = np.array([80.0, 0.5], np.float32)
    ctx = np.array([3, 0], np.int32)
    jfwd = jax.jit(functools.partial(j_dit_forward, cfg=jax_cfg(NET)))
    want = np.asarray(jfwd(jparams, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(cond),
                           jnp.asarray(ctx)))
    got = dit_forward(tparams, torch.from_numpy(x), torch.from_numpy(sigma),
                      torch.from_numpy(cond), torch.from_numpy(ctx).long(), NET).numpy()
    return got, want, tparams


@pytest.mark.parametrize("mode", MODES)
def test_quantized_dit_forward_matches_jax(mode):
    got, want, tparams = forward_both(mode)
    assert got.shape == want.shape == (2, 1, 8, 6, 16)
    if mode.startswith("w8a8"):
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # The carried tree is what the port's own quantizer makes of the same weights.
    m = tq.parse_quant_mode(mode)
    jraw = j_init_dit(jax.random.key(0), jax_cfg(NET), dtype=jnp.float32)
    own = tq.quantize_dit_params(dit_params_from_numpy(jax.device_get(jraw), NET, device="cpu"),
                                 act_quant=m.act_quant, group_size=m.group_size)
    for bo, bt in zip(own["blocks"], tparams["blocks"]):
        for sub in ("fa", "ca", "mlp"):
            for name, leaf in bt[sub].items():
                if tq.is_quantized(leaf):
                    for key in leaf:
                        assert torch.equal(bo[sub][name][key], leaf[key]), (sub, name, key)


def test_quantized_carry_over_is_strict():
    jparams = jq.quantize_dit_params(
        j_init_dit(jax.random.key(0), jax_cfg(NET), dtype=jnp.float32), act_quant=True)
    tree = jax.device_get(jparams)
    fa = dict(tree["blocks"]["fa"])
    fa["wq"] = {k: v for k, v in fa["wq"].items() if k != "sa"}
    with pytest.raises(KeyError, match="wq"):
        dit_params_from_numpy({**tree, "blocks": {**tree["blocks"], "fa": fa}}, NET,
                              device="cpu")
    fa = dict(tree["blocks"]["fa"])
    fa["wq"] = {**fa["wq"], "sa": np.zeros((2, 7), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        dit_params_from_numpy({**tree, "blocks": {**tree["blocks"], "fa": fa}}, NET,
                              device="cpu")
    params = dit_params_from_numpy(tree, NET, device="cpu", dtype=torch.bfloat16)
    leaf = params["blocks"][0]["fa"]["wq"]
    assert leaf["q"].dtype == torch.int8 and leaf["sa"].dtype == torch.float32
    assert params["blocks"][0]["fa"]["adaln_w1"].dtype == torch.bfloat16


TINY = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                 decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
H, W, STEPS = 32, 48, 3


def test_quantized_five_pass_generate_matches_jax():
    """w8a8_g64 through the staged 5-pass inverse generation (as
    tests/test_torch_pipeline.py does it for bf16 weights)."""
    jd = jq.quantize_dit_params(
        j_init_dit(jax.random.key(0), jax_cfg(NET), dtype=jnp.float32),
        act_quant=True, group_size=64)
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

    jv = jax.tree_util.tree_map_with_path(fill, shapes)
    n = 5
    video = np.random.default_rng(0).uniform(size=(1, 1, H, W, 3)).astype(np.float32) * 2 - 1
    cfg = j_inverse_cfg(H, W, 1, net=jax_cfg(NET), vae=JVAEConfig(**dataclasses.asdict(TINY)),
                        compute_dtype="float32")
    ctx = np.arange(n, dtype=np.int32)
    mask = np.array([i == 3 for i in range(n)], np.float32)
    noise = np.random.default_rng(1).standard_normal((1, 1, H // 8, W // 8, 16)).astype(np.float32)
    sig = np.asarray(j_sigmas(STEPS))
    x_init = np.tile(noise, (n, 1, 1, 1, 1)) * sig[0]
    lat = jpipe._encode_one_condition_jit(jv, jnp.asarray(video.transpose(0, 4, 1, 2, 3)),
                                          cfg=cfg)
    cond = jpipe._assemble_conditions_jit((lat,), cfg=cfg, present=(True,), tile=n)
    sample = jpipe._sample_segment_jit(
        jd, cond, jnp.asarray(ctx), jnp.asarray(x_init), jnp.asarray(0.0, jnp.float32),
        jnp.asarray(np.stack([sig[:-1], sig[1:]], axis=1)), cfg=cfg, use_cfg=False)
    want = np.asarray(jpipe._decode_jit(jv, sample, jnp.asarray(mask), cfg=cfg))
    want = want.reshape(n, 1, H, W, 3)

    pipe = DiffusionRendererPipeline(
        dit_params_from_numpy(jax.device_get(jd), NET, device="cpu"),
        vae_params_from_numpy(jax.device_get(jv), TINY, device="cpu"),
        model_type="inverse", num_steps=STEPS, net_config=NET, vae_config=TINY)
    got = pipe.generate({"rgb": video, "context_index": ctx}, normalize_normal=mask,
                        noise_tile=n, batch_tile=n, x_init=torch.from_numpy(x_init))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_load_pipeline_quantizes_the_same_weights():
    """load_pipeline(quantize_int8=...) quantizes each block as it is drawn:
    the result is the port's quantizer applied to the unquantized init of
    the same seed, and the non-block leaves are unchanged."""
    kw = dict(net_config=NET, vae_config=TINY, dtype=torch.float32, device="cpu")
    plain = load_pipeline(**kw).dit_params
    quant = load_pipeline(**kw, quantize_int8=True, act_quant=True, quant_group_size=64,
                          quant_keep_bf16=("mlp.w2",)).dit_params
    want = tq.quantize_dit_params(plain, act_quant=True, group_size=64, keep_bf16=("mlp.w2",))
    assert torch.equal(quant["final"]["linear"], plain["final"]["linear"])
    for bq, bw in zip(quant["blocks"], want["blocks"]):
        assert not tq.is_quantized(bq["mlp"]["w2"])
        assert set(bq["fa"]["wq"]) == {"q", "sa"} and bq["fa"]["wq"]["sa"].shape == (2, 128)
        for sub in bq:
            for name, leaf in bq[sub].items():
                ref = bw[sub][name]
                pairs = leaf.items() if tq.is_quantized(leaf) else [("w", leaf)]
                for key, v in pairs:
                    assert torch.equal(v, ref[key] if tq.is_quantized(leaf) else ref), (sub, name)
