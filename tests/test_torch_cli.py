"""The port's CLI (diffusionrenderer_tpu_torch/cli.py) against the JAX
package's (diffusionrenderer_tpu/cli.py), in process on the CPU at the
tiny architecture: the same parser, tiny configs and presets; inverse and
forward renders within 1 uint8 level of the JAX CLI's on the same
checkpoint files and the same noise (the port's noise_init replaced, in
the test only, by the JAX package's draw for the same seed); convert's
native files and sidecar; and no run without a card unless --cpu asks for
the CPU."""

import argparse
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

from diffusionrenderer_tpu import checkpoint as jckpt
from diffusionrenderer_tpu import cli as jcli
from diffusionrenderer_tpu import pipeline as jpipe
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.native import rgbe
from diffusionrenderer_tpu_torch import cli as tcli
from diffusionrenderer_tpu_torch import io as tio
from diffusionrenderer_tpu_torch import pipeline as tpipe
from diffusionrenderer_tpu_torch.api import load_pipeline
from diffusionrenderer_tpu_torch.checkpoint import (_flatten, convert_dit_state_dict,
                                                    load_dit_checkpoint, load_torch_file)
from diffusionrenderer_tpu_torch.checkpoint_vae import load_vae_checkpoint

STEPS = "2"


def jax_noise_init(seed, sigma0, *, shape, noise_tile, dtype, device):
    """The JAX package's initial state for the same seed (pipeline.py
    _noise_init_jit), as the port's noise_init returns it."""
    per_row = isinstance(seed, (list, tuple, np.ndarray))
    key = (jnp.stack([jax.random.PRNGKey(int(s)) for s in seed]) if per_row
           else jax.random.PRNGKey(int(seed)))
    x = jpipe._noise_init_jit(key, sigma0, shape=tuple(shape), noise_tile=noise_tile,
                              dtype_str="float32", per_row=per_row)
    return torch.from_numpy(np.array(x, np.float32)).to(device=device, dtype=dtype)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tpipe, "noise_init", jax_noise_init)


def vae_dir(root, cfg):
    """A diffusers directory of the tiny VAE: seeded weights, and a
    config.json with a seeded statistics table."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_vae_oracle import oracle_from_vae_config

    rng = np.random.default_rng(4)
    sd = {}
    for name, t in oracle_from_vae_config(cfg).state_dict().items():
        shape = tuple(t.shape)
        if "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("weight"):
            v = rng.standard_normal(shape) / math.sqrt(math.prod(shape[1:]))
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    d = root / "vae"
    d.mkdir()
    np_save_file(sd, str(d / "diffusion_pytorch_model.safetensors"))
    r = np.random.default_rng(5)
    (d / "config.json").write_text(json.dumps({
        "latents_mean": (0.2 * r.standard_normal(256)).tolist(),
        "latents_std": r.uniform(0.7, 1.3, 256).tolist()}))
    return str(d)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Tiny inverse and forward DiT files written from JAX parameters, a
    tiny diffusers VAE directory, 16 x 16 PNG frames and an .hdr sky."""
    root = tmp_path_factory.mktemp("cli")
    paths = {}
    for seed, model_type in ((3, "inverse"), (4, "forward")):
        cfg, vcfg = jcli._tiny_configs(model_type)
        params = j_init_dit(jax.random.key(seed), cfg, dtype=jnp.float32)
        paths[f"dit_{model_type}"] = str(root / f"dit_{model_type}.safetensors")
        np_save_file(jckpt.export_dit_state_dict(params, cfg), paths[f"dit_{model_type}"])
    paths["vae"] = vae_dir(root, vcfg)
    rng = np.random.default_rng(0)
    for name in ("rgb", "rgb2", "depth", "normal", "rough", "metal", "base"):
        paths[name] = str(root / f"{name}.png")
        tio.write_png(paths[name], (rng.uniform(size=(16, 16, 3)) * 255).astype(np.uint8))
    paths["hdr"] = str(root / "sky.hdr")
    rgbe.save_hdr(paths["hdr"], np.abs(rng.standard_normal((8, 16, 3))).astype(np.float32) * 4)
    return paths


def u8_close(port_png, jax_png):
    got, want = tio.read_png(port_png), tio.read_png(jax_png)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# Surface
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


def jax_parser(monkeypatch):
    """The parser the JAX CLI builds inside main()."""
    def capture(self, args=None, namespace=None):
        raise _Captured(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Captured) as e:
            jcli.main(["info"])
    return e.value.args[0]


def surface(parser):
    """Each option of the parser and of each subcommand: its strings, dest,
    default, type, choices, nargs, required flag and constant."""
    def actions(p):
        return sorted(
            (tuple(a.option_strings), a.dest, repr(a.default), getattr(a.type, "__name__", None),
             tuple(a.choices) if a.choices and not isinstance(a.choices, dict) else None,
             a.nargs, a.required, a.const)
            for a in p._actions if not isinstance(a, (argparse._HelpAction,
                                                      argparse._SubParsersAction)))

    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {"": actions(parser), "required": sub.required,
            **{name: actions(p) for name, p in sub.choices.items()}}


def test_parser_surface_matches_jax(monkeypatch):
    want = surface(jax_parser(monkeypatch))
    got = surface(tcli.build_parser())
    assert sorted(got) == sorted(want) == sorted(
        ["", "required", "inverse", "forward", "envmap", "convert", "info"])
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("model_type", ["inverse", "forward"])
def test_tiny_configs_match_jax(model_type):
    for got, want in zip(tcli._tiny_configs(model_type), jcli._tiny_configs(model_type)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_info_matches_jax(capsys):
    jcli.main(["info"])
    want = json.loads(capsys.readouterr().out)
    tcli.main(["--cpu", "info"])
    got = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["presets"] == want["presets"]
    assert got["backend"] == "cpu" and got["devices"] == 1


@pytest.mark.parametrize("argv", [
    ["info"],
    ["inverse", "--tiny", "--steps", "1", "--input", "x.png", "--output-dir", "out"],
    ["envmap", "--input", "sky.hdr", "--height", "8", "--width", "8", "--output-prefix", "e"],
    ["convert", "--tiny", "--dit", "d.safetensors", "--out", "out"],
], ids=["info", "inverse", "envmap", "convert"])
def test_without_cpu_and_without_a_card_it_raises(files, monkeypatch, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [{"x.png": files["rgb"], "sky.hdr": files["hdr"],
             "d.safetensors": files["dit_inverse"]}.get(a, a) for a in argv]
    argv = [str(tmp_path / a) if a in ("out", "e") else a for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    assert not os.path.exists(tmp_path / "out")


# ---------------------------------------------------------------------------
# Renders against the JAX CLI's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [["rgb"], ["rgb", "rgb2"] * 4 + ["rgb"]],
                         ids=["1_frame", "9_frames"])
def test_inverse_matches_jax(files, tmp_path, jax_noise, frames):
    args = ["inverse", "--tiny", "--steps", STEPS, "--passes", "depth,normal", "--seed", "7",
            "--checkpoint", files["dit_inverse"], "--vae", files["vae"],
            "--input", *[files[f] for f in frames]]
    jcli.main(args + ["--output-dir", str(tmp_path / "jax")])
    tcli.main(["--cpu"] + args + ["--output-dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 2 * len(frames)
    for n in names:
        u8_close(str(tmp_path / "port" / n), str(tmp_path / "jax" / n))


def test_forward_matches_jax(files, tmp_path, jax_noise):
    args = ["forward", "--tiny", "--steps", STEPS, "--seed", "3",
            "--checkpoint", files["dit_forward"], "--vae", files["vae"],
            "--depth", files["depth"], "--normal", files["normal"],
            "--roughness", files["rough"], "--metallic", files["metal"],
            "--basecolor", files["base"], "--env", files["hdr"], "--env-rotation", "90"]
    jcli.main(args + ["--output", str(tmp_path / "jax.png")])
    tcli.main(["--cpu"] + args + ["--output", str(tmp_path / "port.png")])
    u8_close(str(tmp_path / "port.png"), str(tmp_path / "jax.png"))


@pytest.mark.parametrize("direct", [False, True], ids=["cubemap", "direct"])
def test_envmap_matches_jax(files, tmp_path, direct):
    args = ["envmap", "--input", files["hdr"], "--height", "16", "--width", "16",
            "--env-flip"] + (["--direct"] if direct else [])
    jcli.main(args + ["--output-prefix", str(tmp_path / "jax")])
    tcli.main(["--cpu"] + args + ["--output-prefix", str(tmp_path / "port")])
    for name in ("env_ldr", "env_log"):
        u8_close(str(tmp_path / f"port_{name}.png"), str(tmp_path / f"jax_{name}.png"))


def test_resume_dir_keeps_each_pass(files, tmp_path):
    d = tmp_path / "resume"
    tcli.main(["--cpu", "inverse", "--tiny", "--steps", "1", "--passes", "depth,normal",
               "--input", files["rgb"], "--output-dir", str(tmp_path / "out"),
               "--resume-dir", str(d)])
    assert sorted(os.listdir(d)) == ["depth.npy", "manifest.json", "normal.npy"]


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_convert_w8a8_loads_bitwise_and_drives_the_cli(files, tmp_path):
    cfg, _ = tcli._tiny_configs("inverse")
    out = str(tmp_path / "native")
    tcli.main(["--cpu", "convert", "--tiny", "--dit", files["dit_inverse"], "--w8a8",
               "--out", out])
    native = _flatten(load_dit_checkpoint(os.path.join(out, "dit"), cfg, torch.float32,
                                          device="cpu"))
    want = _flatten(convert_dit_state_dict(load_torch_file(files["dit_inverse"], device="cpu"),
                                           cfg, torch.float32, quantize_int8=True,
                                           act_quant=True, device="cpu"))
    assert sorted(native) == sorted(want)
    for k, v in want.items():
        assert native[k].dtype == v.dtype and torch.equal(native[k], v), k
    # The native file drives a render through --checkpoint ...
    tcli.main(["--cpu", "inverse", "--tiny", "--steps", "1", "--passes", "depth",
               "--checkpoint", os.path.join(out, "dit"), "--input", files["rgb"],
               "--output-dir", str(tmp_path / "inv")])
    assert tio.read_png(str(tmp_path / "inv" / "depth.png")).shape == (16, 16, 3)
    # ... and the sidecar refuses it for the other model type.
    with pytest.raises(ValueError, match="model_type"):
        load_pipeline(dit_checkpoint=os.path.join(out, "dit"), model_type="forward",
                      device="cpu", dtype=torch.float32, net_config=cfg)


def test_convert_vae_loads_bitwise(files, tmp_path):
    _, vcfg = tcli._tiny_configs("inverse")
    out = str(tmp_path / "native")
    tcli.main(["--cpu", "convert", "--tiny", "--vae", files["vae"], "--out", out])
    got = _flatten(load_vae_checkpoint(os.path.join(out, "vae"), vcfg, torch.float32,
                                       device="cpu"))
    want = _flatten(load_vae_checkpoint(files["vae"], vcfg, torch.float32, device="cpu"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with open(os.path.join(out, "convert_meta.json")) as f:
        assert json.load(f) == {"tiny": True}  # no model_type: the VAE is model-agnostic


@pytest.mark.parametrize("extra", [["--w8a8"], ["--int8", "--quant-group", "32",
                                                "--quant-keep-bf16", "wo,w2"]],
                         ids=["w8a8", "w8_g32_keep"])
def test_convert_sidecar_matches_jax(files, tmp_path, extra):
    metas = {}
    for name, main in (("jax", jcli.main), ("port", lambda a: tcli.main(["--cpu"] + a))):
        out = str(tmp_path / name)
        main(["convert", "--tiny", "--dit", files["dit_inverse"], *extra, "--out", out])
        with open(os.path.join(out, "convert_meta.json")) as f:
            metas[name] = json.load(f)
    assert metas["port"] == metas["jax"]


def test_convert_sidecar_conflict_is_refused_as_in_jax(files, tmp_path):
    messages = {}
    for name, main in (("jax", jcli.main), ("port", lambda a: tcli.main(["--cpu"] + a))):
        out = str(tmp_path / name)
        main(["convert", "--tiny", "--dit", files["dit_inverse"], "--w8a8", "--out", out])
        with pytest.raises(SystemExit) as e:
            main(["convert", "--tiny", "--dit", files["dit_inverse"], "--int8", "--out", out])
        messages[name] = str(e.value).replace(out, "<out>")
        with open(os.path.join(out, "convert_meta.json")) as f:
            assert json.load(f)["quant"] == "w8a8"  # the sidecar is left as it was
    assert "already records" in messages["port"]
    assert messages["port"] == messages["jax"]
    with pytest.raises(SystemExit, match="--dit and/or --vae"):
        tcli.main(["--cpu", "convert", "--out", str(tmp_path / "none")])
