"""The port's ComfyUI nodes (diffusionrenderer_tpu_torch/comfy_nodes.py)
against the JAX package's (diffusionrenderer_tpu/comfy_nodes.py): the same
declarations, defaults, coercions and loader arguments; the renderer nodes
end to end on tiny fp32 pipelines on the CPU, equal to the port's api and
within 1 uint8 level of the JAX nodes on the same weights and the same
noise (the port's noise_init replaced, in the test only, by the JAX
package's draw for the same seed)."""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusionrenderer_tpu_torch
from diffusionrenderer_tpu import comfy_nodes as jnodes
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.config import VAEConfig as JVAEConfig
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.models.vae import init_vae_params as j_init_vae
from diffusionrenderer_tpu.native import rgbe
from diffusionrenderer_tpu.pipeline import DiffusionRendererPipeline as JPipeline
from diffusionrenderer_tpu_torch import api as tapi
from diffusionrenderer_tpu_torch import comfy_nodes as tnodes
from diffusionrenderer_tpu_torch import pipeline as tpipe
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy, vae_params_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig
from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline
from test_torch_cli import jax_noise_init

NETS = {
    "inverse": dict(model_channels=48, num_blocks=2, num_heads=2, adaln_lora_dim=8,
                    crossattn_emb_channels=16, additional_concat_ch=16,
                    use_context_embedding=True),
    "forward": dict(model_channels=48, num_blocks=2, num_heads=2, adaln_lora_dim=8,
                    crossattn_emb_channels=16, additional_concat_ch=17 * 8,
                    use_context_embedding=False),
}
VAE = dict(encoder_block_out_channels=(8, 12, 16, 16),
           decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
STEPS = 2


def no_tooltips(spec):
    """INPUT_TYPES without its help texts (they name each package's own
    file formats)."""
    if isinstance(spec, dict):
        return {k: no_tooltips(v) for k, v in spec.items() if k != "tooltip"}
    if isinstance(spec, (tuple, list)):
        return type(spec)(no_tooltips(v) for v in spec)
    return spec


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

def test_mappings_and_quant_modes_match_jax():
    assert list(tnodes.NODE_CLASS_MAPPINGS) == list(jnodes.NODE_CLASS_MAPPINGS)
    assert list(tnodes.NODE_DISPLAY_NAME_MAPPINGS) == list(jnodes.NODE_DISPLAY_NAME_MAPPINGS)
    assert tnodes.QUANT_MODES == jnodes.QUANT_MODES
    assert all(v.endswith("(CUDA)") for v in tnodes.NODE_DISPLAY_NAME_MAPPINGS.values())


@pytest.mark.parametrize("name", list(jnodes.NODE_CLASS_MAPPINGS))
def test_node_declarations_match_jax(name):
    ours, theirs = tnodes.NODE_CLASS_MAPPINGS[name], jnodes.NODE_CLASS_MAPPINGS[name]
    assert no_tooltips(ours.INPUT_TYPES()) == no_tooltips(theirs.INPUT_TYPES())
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
        assert getattr(ours, attr, None) == getattr(theirs, attr, None), attr
    import inspect

    fn, jfn = getattr(ours, ours.FUNCTION), getattr(theirs, theirs.FUNCTION)
    assert inspect.signature(fn) == inspect.signature(jfn)


def test_package_exposes_mappings_lazily():
    assert diffusionrenderer_tpu_torch.NODE_CLASS_MAPPINGS is tnodes.NODE_CLASS_MAPPINGS
    assert (diffusionrenderer_tpu_torch.NODE_DISPLAY_NAME_MAPPINGS
            is tnodes.NODE_DISPLAY_NAME_MAPPINGS)
    with pytest.raises(AttributeError):
        diffusionrenderer_tpu_torch.NOT_A_THING


COERCE_CASES = {
    "3d": lambda: torch.rand(4, 6, 3, generator=torch.Generator().manual_seed(0)),
    "4d": lambda: torch.rand(2, 4, 6, 3, generator=torch.Generator().manual_seed(1)),
    "5d": lambda: torch.rand(2, 3, 4, 6, 3, generator=torch.Generator().manual_seed(2)),
    "list": lambda: [torch.full((2, 4, 6, 3), float(i)) for i in range(3)],
    "ragged_list": lambda: [torch.ones(1, 4, 6, 3), torch.zeros(1, 8, 6, 3)],
    "2d": lambda: torch.zeros(4, 6),
    "6d": lambda: torch.zeros(1, 1, 1, 4, 6, 3),
    "string": lambda: "nope",
    "numpy": lambda: np.zeros((4, 6, 3)),
}


@pytest.mark.parametrize("case", list(COERCE_CASES))
def test_coerce_5d_matches_jax(case):
    results = []
    for fn in (tnodes._coerce_5d_torch, jnodes._coerce_5d_torch):
        try:
            results.append(fn(COERCE_CASES[case](), "x"))
        except (TypeError, ValueError) as e:
            results.append(e)
    got, want = results
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
    else:
        assert got.shape == want.shape and torch.equal(got, want)
        if case == "5d":
            value = COERCE_CASES[case]()
            assert tnodes._coerce_5d_torch(value, "x") is value


def test_example_workflow_validates_against_the_port_nodes():
    """docs/example_workflow.json references only node classes and input
    fields the port declares, and every link points at an existing output."""
    path = os.path.join(os.path.dirname(__file__), "..", "docs", "example_workflow.json")
    with open(path) as f:
        wf = json.load(f)
    nodes = {k: v for k, v in wf.items() if isinstance(v, dict)}
    builtin = {"LoadImage", "SaveImage"}
    for spec in nodes.values():
        if spec["class_type"] in builtin:
            continue
        cls = tnodes.NODE_CLASS_MAPPINGS[spec["class_type"]]
        declared = cls.INPUT_TYPES()
        fields = set(declared["required"]) | set(declared.get("optional", {}))
        for field, value in spec["inputs"].items():
            assert field in fields, (spec["class_type"], field)
            if isinstance(value, list):  # a link: [node_id, slot]
                src = nodes[value[0]]
                if src["class_type"] not in builtin:
                    assert value[1] < len(tnodes.NODE_CLASS_MAPPINGS[src["class_type"]]
                                          .RETURN_TYPES)
            elif field in declared.get("optional", {}):
                choices = declared["optional"][field][0]
                if isinstance(choices, list):
                    assert value in choices, (field, value)


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", jnodes.QUANT_MODES)
def test_loader_arguments_match_jax(monkeypatch, mode):
    seen = {}
    for name, mod in (("port", tnodes), ("jax", jnodes)):
        monkeypatch.setattr(mod.api, "load_pipeline",
                            lambda name=name, **kw: seen.setdefault(name, kw) and "PIPE")
        (pipe,) = mod.LoadDiffusionRendererModel().load_pipeline(
            "/models/dit.safetensors", quant_mode=mode, vae_path="/models/vae")
    assert seen["port"] == seen["jax"]
    assert seen["port"]["dit_checkpoint"] == "/models/dit.safetensors"
    assert seen["port"]["vae_checkpoint"] == "/models/vae"
    assert ("quantize_int8" in seen["port"]) == (mode != "bf16")


def test_loader_default_is_w8a8_and_refuses_calibrated_modes(monkeypatch):
    seen = {}
    monkeypatch.setattr(tnodes.api, "load_pipeline", lambda **kw: seen.update(kw) or "PIPE")
    tnodes.LoadDiffusionRendererModel().load_pipeline("/models/dit")
    assert seen["quantize_int8"] and seen["act_quant"] and seen["vae_checkpoint"] is None
    assert seen["quant_group_size"] is None
    for mode in ("w8a8_awq", "w8a8_gptq"):
        with pytest.raises(ValueError, match="calibration"):
            tnodes.LoadDiffusionRendererModel().load_pipeline("/models/dit", quant_mode=mode)


def test_loader_needs_a_card(monkeypatch):
    """The loader's pipeline lands on CUDA; without a card it raises rather
    than loading on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnodes.LoadDiffusionRendererModel().load_pipeline("/models/dit.safetensors",
                                                          quant_mode="bf16")


# ---------------------------------------------------------------------------
# The renderer nodes
# ---------------------------------------------------------------------------

def jax_weights(model_type):
    """The DiT's JAX init; the VAE's JAX tree filled with seeded numpy
    weights N(0, 1/fan_in), identity norms and statistics."""
    jnet, jvae = JDiTConfig(**NETS[model_type]), JVAEConfig(**VAE)
    jd = j_init_dit(jax.random.key(0), jnet, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda key: j_init_vae(key, jvae, jnp.float32), jax.random.key(1))
    rng = np.random.default_rng(1)

    def fill(path, s):
        name = path[-1].key
        if name == "w":
            return jnp.asarray(rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1])),
                               jnp.float32)
        return jnp.ones(s.shape) if name in ("scale", "latents_std") else jnp.zeros(s.shape)

    return jd, jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def make_pipes(model_type):
    """(JAX pipeline, port pipeline) on the same weights."""
    jd, jv = jax_weights(model_type)
    jnet, jvae = JDiTConfig(**NETS[model_type]), JVAEConfig(**VAE)
    net, vae = DiTConfig(**NETS[model_type]), VAEConfig(**VAE)
    jp = JPipeline(jd, jv, model_type=model_type, num_steps=STEPS, compute_dtype="float32",
                   net_config=jnet, vae_config=jvae)
    tp = DiffusionRendererPipeline(dit_params_from_numpy(jax.device_get(jd), net, device="cpu"),
                                   vae_params_from_numpy(jax.device_get(jv), vae, device="cpu"),
                                   model_type=model_type, num_steps=STEPS, net_config=net,
                                   vae_config=vae)
    return jp, tp


@pytest.fixture(params=["inverse", "forward"])
def pipes(request):
    return (request.param, *make_pipes(request.param))


def images(seed, shape=(1, 16, 16, 3)):
    return torch.from_numpy(np.random.default_rng(seed).uniform(size=shape).astype(np.float32))


def assert_within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert (got * 255 - want * 255).abs().max().item() <= 1 + 1e-3


def test_renderer_node_matches_api_and_jax(pipes, monkeypatch):
    model_type, jp, tp = pipes
    if model_type == "inverse":
        img = images(0)
        node_out = tnodes.Cosmos1InverseRenderer().run_inverse_pass(tp, img, guidance=0.0,
                                                                   seed=7)
        assert len(node_out) == 5
        ref = tapi.inverse_render(tp, img.numpy(), guidance=0.0, seed=7)
        for name, t in zip(tnodes.Cosmos1InverseRenderer.RETURN_NAMES, node_out):
            v = t.numpy()
            assert t.shape == (1, 16, 16, 3) and np.isfinite(v).all()
            assert v.min() >= 0 and v.max() <= 1
            np.testing.assert_array_equal(v, ref["basecolor" if name == "base_color" else name])
        monkeypatch.setattr(tpipe, "noise_init", jax_noise_init)
        got = tnodes.Cosmos1InverseRenderer().run_inverse_pass(tp, img, seed=7)
        want = jnodes.Cosmos1InverseRenderer().run_inverse_pass(jp, img, seed=7)
    else:
        g = {k: images(i + 1) for i, k in enumerate(("depth", "normal", "roughness",
                                                     "metallic", "base_color"))}
        env = images(9, (1, 8, 16, 3)) * 4
        kw = dict(env_map=env, guidance=0.0, seed=3, env_format="proj", env_rotation=90.0,
                  **g)
        (out,) = tnodes.Cosmos1ForwardRenderer().run_forward_pass(tp, **kw)
        ref = tapi.forward_render(tp, *(g[k].numpy() for k in (
            "depth", "normal", "roughness", "metallic", "base_color")), env.numpy(),
            seed=3, env_rotation=90.0)
        np.testing.assert_array_equal(out.numpy(), ref)
        monkeypatch.setattr(tpipe, "noise_init", jax_noise_init)
        got = tnodes.Cosmos1ForwardRenderer().run_forward_pass(tp, **kw)
        want = jnodes.Cosmos1ForwardRenderer().run_forward_pass(jp, **kw)
    for a, b in zip(got, want):
        assert_within_one_level(a, b)


def test_forward_node_ball_mode():
    _, tp = make_pipes("forward")
    g = {k: images(i + 1) for i, k in enumerate(("depth", "normal", "roughness", "metallic",
                                                 "base_color"))}
    (out,) = tnodes.Cosmos1ForwardRenderer().run_forward_pass(
        tp, env_map=images(10) * 2, env_format="ball", **g)
    assert out.shape == (1, 16, 16, 3)
    assert bool(torch.isfinite(out).all()) and 0 <= out.min() and out.max() <= 1


def test_load_hdr_node_matches_jax(tmp_path):
    img = np.abs(np.random.default_rng(3).standard_normal((8, 16, 3))).astype(np.float32) * 10
    path = str(tmp_path / "env.hdr")
    rgbe.save_hdr(path, img)
    (got,) = tnodes.LoadHDRImage().load_hdr(path)
    (want,) = jnodes.LoadHDRImage().load_hdr(path)
    assert got.shape == (1, 8, 16, 3) and float(got.max()) > 1.0
    assert torch.equal(got, want)
