"""The port stands alone: importing it and all its submodules loads neither
JAX nor any module of the JAX package (checked in a fresh interpreter, on
whole module names: the port's own name begins with diffusionrenderer_tpu)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import diffusionrenderer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "diffusionrenderer_tpu" or m.startswith("diffusionrenderer_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for mod in ("api", "checkpoint", "pipeline", "models.dit", "models.vae", "models.quant",
                "models.calibrate", "ops.attention", "ops.flash_attention", "ops.quant_matmul",
                "ops.cuda_build", "sampling.edm", "parallel.sharding",
                "parallel.ring_attention", "parallel.flash_sp", "envmap", "io",
                "ops.resample", "utils.cache", "checkpoint_vae", "utils.safetensors",
                "cli", "serving", "comfy_nodes", "utils.profiling", "utils.metrics",
                "training", "training.train", "training.loop"):
        assert f"diffusionrenderer_tpu_torch.{mod}" in report["imported"]


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "diffusionrenderer_tpu." not in src.replace(
        "diffusionrenderer_tpu_torch", "")
