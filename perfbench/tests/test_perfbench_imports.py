"""Nothing under perfbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "diffusionrenderer_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def _files(sub=""):
    return sorted((ROOT / "perfbench" / sub).rglob("*.py"))


def test_no_jax_anywhere_in_the_benchmark():
    bad = {(str(p.relative_to(ROOT)), m) for p in _files() for m in _imports(p)
           if m in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    files = _files("reference")
    assert files
    for p in files:
        for m in _imports(p):
            assert m not in FORBIDDEN | {"diffusionrenderer_tpu_torch", "perfbench"}, (p, m)


def test_the_scan_sees_a_planted_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom diffusionrenderer_tpu import api\n"
                 "import diffusionrenderer_tpu_torch\n")
    assert set(_imports(p)) & FORBIDDEN == {"jax", "diffusionrenderer_tpu"}
