"""The port's DiT checkpoint I/O against the JAX package's, on the tiny DiT
of tests/test_torch_dit.py in fp32: a reference-format state dict that the
JAX package exports loads in the port from `.safetensors` and from `.pt`
(with and without the {"model": ...} wrapper) and runs the same forward;
the port's export equals JAX's; missing, extra and training-only keys
behave as in JAX; quantize-on-load gives JAX's codes.  Also the port's own
safetensors reader and writer against the `safetensors` library, and its
native format (one flat safetensors file) against orbax directories, which
it refuses."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from diffusionrenderer_tpu import checkpoint as jckpt
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models.dit import dit_forward as j_dit_forward
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init
from diffusionrenderer_tpu_torch import checkpoint as tckpt
from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
from diffusionrenderer_tpu_torch.models.quant import quantize_dit_params
from diffusionrenderer_tpu_torch.utils.safetensors import (SafetensorsFile, read_header,
                                                           read_safetensors, write_safetensors)

NET = DiTConfig(
    model_channels=96, num_blocks=2, num_heads=2, in_channels=16, out_channels=16,
    additional_concat_ch=16, adaln_lora_dim=8, crossattn_emb_channels=16,
    use_context_embedding=True,
)
# The forward renderer's layout, with the optional patch-embedding bias.
FWD_NET = dataclasses.replace(NET, additional_concat_ch=136, use_context_embedding=False,
                              patch_embed_bias=True)


def jax_cfg(cfg):
    return JDiTConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def jax_export(cfg, seed=0):
    """JAX params and the JAX package's reference-format export of them."""
    jparams = j_init(jax.random.key(seed), jax_cfg(cfg), dtype=jnp.float32)
    if cfg.patch_embed_bias:
        bias = np.random.default_rng(seed).standard_normal(cfg.model_channels)
        jparams["x_embedder"]["bias"] = jnp.asarray(bias, jnp.float32)
    return jparams, jckpt.export_dit_state_dict(jparams, jax_cfg(cfg))


def dit_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, t, h, w = 2, 2, 4, 6
    x = rng.standard_normal((b, t, h, w, cfg.in_channels)).astype(np.float32)
    cond = rng.standard_normal((b, t, h, w, cfg.additional_concat_ch)).astype(np.float32)
    return x, np.array([80.0, 0.5], np.float32), cond, np.array([3, 0], np.int32)


def forward_both(cfg, jparams, tparams):
    x, sigma, cond, ctx = dit_inputs(cfg)
    want = j_dit_forward(jparams, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(cond),
                         jnp.asarray(ctx), jax_cfg(cfg))
    got = dit_forward(tparams, torch.from_numpy(x), torch.from_numpy(sigma),
                      torch.from_numpy(cond), torch.from_numpy(ctx).long(), cfg)
    return got.numpy(), np.asarray(want)


def write_reference(tmp_path, sd, fmt):
    """Save a reference-format dict as the reference's users do."""
    if fmt == "safetensors":
        path = str(tmp_path / "model.safetensors")
        np_save_file(dict(sd), path)
        return path
    path = str(tmp_path / "model.pt")
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save({"model": tensors} if fmt == "pt_model" else tensors, path)
    return path


@pytest.mark.parametrize("cfg", [NET, FWD_NET], ids=["inverse", "forward_bias"])
@pytest.mark.parametrize("fmt", ["safetensors", "pt", "pt_model"])
def test_jax_export_loads_and_runs_the_same_forward(tmp_path, cfg, fmt):
    jparams, sd = jax_export(cfg)
    path = write_reference(tmp_path, sd, fmt)
    tparams = tckpt.load_dit_checkpoint(path, cfg, torch.float32, device="cpu")
    got, want = forward_both(cfg, jparams, tparams)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # The loaded weights are the file's, bit for bit.
    for name, arr in tckpt.export_dit_state_dict(tparams, cfg).items():
        np.testing.assert_array_equal(arr.numpy(), sd[name], err_msg=name)


@pytest.mark.parametrize("cfg", [NET, FWD_NET], ids=["inverse", "forward_bias"])
def test_port_export_equals_jax_export(cfg):
    jparams, want = jax_export(cfg)
    tparams = tckpt.dit_params_from_numpy(jax.device_get(jparams), cfg, device="cpu")
    got = tckpt.export_dit_state_dict(tparams, cfg)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)


def test_export_refuses_quantized_params():
    tparams = init_dit_params(NET, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="quantized"):
        tckpt.export_dit_state_dict(quantize_dit_params(tparams), NET)


def _raises_alike(fn_jax, fn_port, exc):
    with pytest.raises(exc) as want:
        fn_jax()
    with pytest.raises(exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


def test_missing_key_raises_like_jax():
    _, sd = jax_export(NET)
    sd = dict(sd)
    del sd["net.blocks.block1.blocks.2.block.layer1.weight"]
    _raises_alike(lambda: jckpt.convert_dit_state_dict(sd, jax_cfg(NET), jnp.float32),
                  lambda: tckpt.convert_dit_state_dict(sd, NET, torch.float32, device="cpu"),
                  KeyError)


def test_extra_key_raises_like_jax():
    _, sd = jax_export(NET)
    sd = {**sd, "net.blocks.block9.extra.weight": np.zeros(3, np.float32),
          "net.unknown": np.zeros(2, np.float32)}
    _raises_alike(lambda: jckpt.convert_dit_state_dict(sd, jax_cfg(NET), jnp.float32),
                  lambda: tckpt.convert_dit_state_dict(sd, NET, torch.float32, device="cpu"),
                  ValueError)


def test_training_only_keys_are_discarded_like_jax(tmp_path):
    jparams, sd = jax_export(NET)
    sd = {**sd, "logvar.0.freqs": np.ones(4, np.float32), "logvar.0.phases": np.ones(4, np.float32),
          "logvar.1.weight": np.ones((1, 4), np.float32),
          "net.pos_embedder.seq": np.arange(512, dtype=np.float32)}
    path = write_reference(tmp_path, sd, "pt_model")
    jtree = jckpt.load_dit_checkpoint(path, jax_cfg(NET), jnp.float32)
    tparams = tckpt.load_dit_checkpoint(path, NET, torch.float32, device="cpu")
    got, want = forward_both(NET, jtree, tparams)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrong_shape_raises():
    _, sd = jax_export(NET)
    sd = {**sd, "net.final_layer.linear.weight": np.zeros((3, 96), np.float32)}
    with pytest.raises(ValueError, match="final_layer.linear.weight"):
        tckpt.convert_dit_state_dict(sd, NET, torch.float32, device="cpu")


# Seed 2 puts no weight at an exact .5 tie of w / scale (at a tie torch's
# division and XLA's reciprocal multiply may round the code one step apart:
# ROADMAP.md section 3).
QUANT_SEED = 2


def test_quantize_on_load_gives_jax_codes(tmp_path):
    _, sd = jax_export(NET, QUANT_SEED)
    path = write_reference(tmp_path, sd, "safetensors")
    jtree = jckpt.load_dit_checkpoint(path, jax_cfg(NET), jnp.float32, quantize_int8=True,
                                      act_quant=True, group_size=64)
    tparams = tckpt.load_dit_checkpoint(path, NET, torch.float32, quantize_int8=True,
                                        act_quant=True, group_size=64, device="cpu")
    nq = 0
    for sub, names in (("fa", ("wq", "wk", "wv", "wo")), ("ca", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w1", "w2"))):
        for name in names:
            jleaf = jtree["blocks"][sub][name]
            for i, bp in enumerate(tparams["blocks"]):
                leaf = bp[sub][name]
                assert set(leaf) == set(jleaf) == {"q", "sa"}
                jq = np.asarray(jleaf["q"][i]).T  # (K, N) -> the port's (N, K)
                assert np.abs(leaf["q"].numpy().astype(int) - jq.astype(int)).max() <= 1
                np.testing.assert_array_equal(leaf["q"].numpy(), jq, err_msg=f"{sub}.{name}")
                np.testing.assert_allclose(leaf["sa"].numpy(), np.asarray(jleaf["sa"][i]),
                                           rtol=1e-7, atol=0)
                nq += 1
    assert nq == 2 * 10
    # The unquantized leaves are the file's.
    np.testing.assert_array_equal(tparams["blocks"][1]["fa"]["q_norm"].numpy(),
                                  sd["net.blocks.block1.blocks.0.block.attn.to_q.1.weight"])


def test_quantize_on_load_is_in_memory_quantization(tmp_path):
    """Loading with quantize_int8 equals quantizing the loaded weights."""
    tparams = init_dit_params(NET, device="cpu", dtype=torch.bfloat16, seed=4)
    path = str(tmp_path / "model.safetensors")
    write_safetensors(path, tckpt.export_dit_state_dict(tparams, NET))
    kw = dict(act_quant=True, group_size=32, keep_bf16=("mlp.w2",))
    got = tckpt.load_dit_checkpoint(path, NET, torch.bfloat16, quantize_int8=True,
                                    device="cpu", **kw)
    want = quantize_dit_params(tparams, **kw)
    for g, w in zip(tckpt._flatten(got).items(), tckpt._flatten(want).items()):
        assert g[0] == w[0] and g[1].dtype == w[1].dtype and torch.equal(g[1], w[1]), g[0]


# ---------------------------------------------------------------------------
# The safetensors module
# ---------------------------------------------------------------------------

def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w.f32": torch.randn(3, 5, generator=g),
        "w.bf16": torch.randn(4, 2, generator=g).bfloat16(),
        "w.f16": torch.randn(7, generator=g).half(),
        "q.i8": torch.randint(-127, 128, (5, 3), generator=g, dtype=torch.int8),
        "i.i32": torch.arange(9, dtype=torch.int32).reshape(3, 3),
        "i.i64": torch.arange(3, dtype=torch.int64),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_reads_files_the_library_writes(tmp_path):
    want = _tensors()
    torch_save_file(want, str(tmp_path / "t.safetensors"), metadata={"who": "library"})
    arrays = {k: v.numpy() for k, v in want.items() if v.dtype != torch.bfloat16}
    np_save_file(arrays, str(tmp_path / "n.safetensors"))
    with SafetensorsFile(str(tmp_path / "t.safetensors")) as f:
        assert f.metadata == {"who": "library"} and sorted(f) == sorted(want)
        for k, v in want.items():
            assert f[k].dtype == v.dtype and torch.equal(f[k], v), k
    got = dict(read_safetensors(str(tmp_path / "n.safetensors")))
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_library_reads_files_the_module_writes(tmp_path):
    want = _tensors(1)
    path = str(tmp_path / "m.safetensors")
    # Numpy arrays and tensors alike; a strided view is written as its values.
    src = {**want, "w.view": want["w.f32"].T, "n.f32": np.arange(6, dtype=np.float32)}
    write_safetensors(path, src, metadata={"format": "x"})
    got = torch_load_file(path)
    assert sorted(got) == sorted(src)
    for k, v in src.items():
        v = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    entries, meta = read_header(path)
    assert meta == {"format": "x"}
    # The library's layout: the data start and every offset aligned to the
    # tensor's width, no gaps.
    with open(path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
    assert n % 8 == 0
    spans = sorted(e["data_offsets"] for e in entries.values())
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for name, e in entries.items():
        assert e["data_offsets"][0] % got[name].element_size() == 0
    np.testing.assert_array_equal(np_load_file(path)["n.f32"], src["n.f32"])


def test_refuses_what_is_not_safetensors(tmp_path):
    path = tmp_path / "x.pt"
    torch.save({"a": torch.ones(2)}, str(path))
    with pytest.raises(ValueError, match="not a safetensors file"):
        read_header(str(path))
    with pytest.raises(ValueError, match="dtype"):
        write_safetensors(str(tmp_path / "b.safetensors"), {"b": torch.ones(2, dtype=torch.bool)})


# ---------------------------------------------------------------------------
# Native formats
# ---------------------------------------------------------------------------

def test_native_round_trip_is_bitwise(tmp_path):
    tparams = init_dit_params(NET, device="cpu", dtype=torch.bfloat16, seed=5)
    tparams = quantize_dit_params(tparams, act_quant=True, group_size=32, keep_bf16=("wo",))
    path = str(tmp_path / "native.safetensors")
    tckpt.save_native(path, tparams)
    assert tckpt.is_native_checkpoint(path)
    back = tckpt.restore_native(path, device="cpu")
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == NET.num_blocks
    a, b = tckpt._flatten(tparams), tckpt._flatten(back)
    assert sorted(a) == sorted(b)
    dtypes = set()
    for k, v in a.items():
        assert b[k].dtype == v.dtype and torch.equal(b[k], v), k
        dtypes.add(v.dtype)
    assert {torch.bfloat16, torch.int8, torch.float32} <= dtypes
    # A native file loads through load_dit_checkpoint, flags ignored.
    again = tckpt.load_dit_checkpoint(path, NET, quantize_int8=True, device="cpu")
    assert torch.equal(again["blocks"][0]["mlp"]["w1"]["q"], tparams["blocks"][0]["mlp"]["w1"]["q"])


def test_native_detection(tmp_path):
    _, sd = jax_export(NET)
    ref = write_reference(tmp_path, sd, "safetensors")
    assert not tckpt.is_native_checkpoint(ref)
    assert not tckpt.is_native_checkpoint(write_reference(tmp_path, sd, "pt"))
    assert not tckpt.is_native_checkpoint(str(tmp_path / "missing"))
    assert not tckpt.is_native_checkpoint(str(tmp_path))


def test_orbax_directory_raises_naming_the_reference_route(tmp_path):
    jparams, _ = jax_export(NET)
    path = str(tmp_path / "orbax")
    jckpt.save_native(path, jparams)
    assert jckpt.is_native_checkpoint(path)
    for load in (lambda: tckpt.load_dit_checkpoint(path, NET, device="cpu"),
                 lambda: tckpt.restore_native(path, device="cpu")):
        with pytest.raises(ValueError, match="orbax.*reference-format"):
            load()


def test_load_pipeline_refuses_a_native_checkpoint_of_another_model_type(tmp_path):
    from diffusionrenderer_tpu_torch.api import load_pipeline

    tparams = init_dit_params(NET, device="cpu", dtype=torch.float32)
    path = str(tmp_path / "dit.safetensors")
    tckpt.save_native(path, tparams)
    with open(tmp_path / "convert_meta.json", "w") as f:
        json.dump({"model_type": "forward"}, f)
    with pytest.raises(ValueError, match="model_type='forward'"):
        load_pipeline(dit_checkpoint=path, model_type="inverse", net_config=NET,
                      device="cpu", dtype=torch.float32)
    os.remove(tmp_path / "convert_meta.json")
    from diffusionrenderer_tpu_torch.config import VAEConfig

    tiny = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                     decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
    pipe = load_pipeline(dit_checkpoint=path, net_config=NET, vae_config=tiny, device="cpu",
                         dtype=torch.float32)
    assert torch.equal(pipe.dit_params["final"]["linear"], tparams["final"]["linear"])
