"""The port's Megatron tensor parallelism and hybrid mesh on torch.distributed,
against the JAX package on its 8-device CPU mesh built with the same
factors, and against the unsharded port.

One spawn of gloo ranks per mesh (tests/torch_mesh_worker.py), shared by
that mesh's cases, at most 4 ranks.  Covered, in fp32:

* the sharded forward of tests/test_sharding.py's tiny DiT at (data, seq,
  tensor) = (1, 1, 2), (1, 1, 4), (1, 2, 2) and (2, 1, 2): the whole batch
  through seq_sharding_constraint against JAX's sharded forward and the
  unsharded port, and the pipeline's form (mesh=, each rank's rows) with
  'auto', 'flash_sp' and 'ring': rtol 1e-4, atol 1e-5, as
  tests/test_sharding.py:55-70, :104-116 hold JAX's;
* W8A8 per channel and g128 with the 'di' and 'hs' input transforms at
  tensor = 2, against JAX's quantized forward under the mesh: relative L2
  1e-3, tests/test_torch_quant.py's bound for W8A8 (an fp32 ulp in a
  block's input may move an int8 code across .5);
* a row-parallel W8A8 matmul whose every token has its largest activation
  in the other rank's half of K: the sharded product equals the unsharded
  one (2e-5, tests/test_torch_quant.py's dense bound), and quantizing with
  each rank's own max does not;
* generate() on make_mesh() at 4 ranks ((1, 2, 2)) within 1 uint8 count of
  the unsharded port (tests/test_sharding.py:151-181);
* make_hybrid_mesh over two nodes modeled by LOCAL_WORLD_SIZE = 2: its
  layout, its forward, and the refusals of a node count and a device count
  that do not match (tests/test_sharding.py:72-102);
* dit_param_shardings' refusals of layouts that cannot split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models import quant as jq
from diffusionrenderer_tpu.models.dit import dit_forward as j_dit_forward
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.parallel import batch_sharding, dit_param_shardings
from diffusionrenderer_tpu.parallel import make_mesh as j_make_mesh
from diffusionrenderer_tpu.parallel import shard_params, token_sharding_constraint
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.models.dit import dit_forward
from diffusionrenderer_tpu_torch.models.quant import dense_maybe_quantized
from diffusionrenderer_tpu_torch.parallel import Sharding
from diffusionrenderer_tpu_torch.parallel.sharding import _leaf_shardings

MESHES = [(1, 1, 2), (1, 1, 4), (1, 2, 2), (2, 1, 2)]
QUANT_MODES = {"w8a8": None, "w8a8_g128": 128}


def jcfg(cfg):
    return JDiTConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def dit_inputs():
    rng = np.random.default_rng(1)
    return {"params": jax.device_get(j_init_dit(jax.random.key(0), jcfg(worker.SHARD_CFG),
                                                dtype=jnp.float32)),
            "x": rng.standard_normal((4, 2, 8, 8, 16)).astype(np.float32),
            "cond": rng.standard_normal((4, 2, 8, 8, 16)).astype(np.float32),
            "sigma": np.full((4,), 7.5, np.float32), "ctx": np.array([0, 1, 2, 3])}


def _quant_tree(group_size):
    """JAX's W8A8 tree of QUANT_CFG with the Hadamard signs and migration
    multipliers ('hs', 'di') on every quantized leaf."""
    params = j_init_dit(jax.random.key(3), jcfg(worker.QUANT_CFG), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    blocks = {}
    for sub, sp in params["blocks"].items():
        blocks[sub] = {}
        for name, w in sp.items():
            if name in jq.QUANTIZED_BLOCK_WEIGHTS.get(sub, ()):
                di = jnp.asarray(rng.uniform(0.5, 2.0, w.shape[:2]).astype(np.float32))
                w = jq.quantize_tensor(w, act_quant=True, group_size=group_size, hadamard=True,
                                       migrate=di)
            blocks[sub][name] = w
    return jax.device_get(dict(params, blocks=blocks))


@pytest.fixture(scope="module")
def quant_inputs():
    rng = np.random.default_rng(6)
    return {"trees": {name: _quant_tree(g) for name, g in QUANT_MODES.items()},
            "x": rng.standard_normal((2, 1, 8, 6, 16)).astype(np.float32),
            "cond": rng.standard_normal((2, 1, 8, 6, 16)).astype(np.float32),
            "sigma": np.array([80.0, 0.5], np.float32), "ctx": np.array([3, 0])}


@pytest.fixture(scope="module")
def amax_inputs():
    """(8, 256) activations whose every row peaks in columns 128-255 (the
    second rank's half of K), and a per-channel W8A8 (N, K) leaf."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    x[np.arange(8), 128 + rng.integers(0, 128, 8)] = 40.0
    w = torch.from_numpy(rng.standard_normal((96, 256)).astype(np.float32) * 0.05)
    from diffusionrenderer_tpu_torch.models.quant import quantize_tensor

    leaf = {k: v.numpy() for k, v in quantize_tensor(w, act_quant=True).items()}
    return {"x": x, "leaf": leaf}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, dit_inputs, quant_inputs, amax_inputs):
    runs = {}
    for mesh in MESHES:
        workdir = tmp_path_factory.mktemp("tp_{}x{}x{}".format(*mesh))
        inputs = {"mesh": mesh, "dit": dit_inputs}
        if mesh == (1, 1, 2):
            inputs["quant"] = quant_inputs["trees"]
            inputs["quant_inputs"] = quant_inputs
            inputs["amax"] = amax_inputs
        runs[mesh] = worker.spawn_ranks("tp_forward", workdir, int(np.prod(mesh)), inputs)
    return runs


def _unsharded(d, cfg=worker.SHARD_CFG, params=None):
    params = dit_params_from_numpy(params if params is not None else d["params"], cfg,
                                   device="cpu")
    with torch.no_grad():
        return dit_forward(params, *(torch.from_numpy(np.asarray(d[n]))
                                     for n in ("x", "sigma", "cond", "ctx")), cfg).numpy()


def _jax_sharded(d, mesh_factors, cfg=worker.SHARD_CFG, params=None):
    data, seq, tensor = mesh_factors
    mesh = j_make_mesh(data * seq * tensor, data=data, seq=seq, tensor=tensor)
    tree = jax.tree.map(jnp.asarray, params if params is not None else d["params"])
    tree = shard_params(tree, dit_param_shardings(tree, mesh))
    bs = batch_sharding(mesh)
    constraint = token_sharding_constraint(mesh)

    @jax.jit
    def fwd(p, x, s, c, ci):
        return j_dit_forward(p, x, s, c, ci, jcfg(cfg), seq_sharding_constraint=constraint)

    with mesh:
        return np.asarray(fwd(tree, jax.device_put(d["x"], bs), d["sigma"],
                              jax.device_put(d["cond"], bs), d["ctx"]))


@pytest.mark.parametrize("mesh", MESHES)
def test_tensor_parallel_forward_matches_jax_and_unsharded(mesh_runs, dit_inputs, mesh):
    want = _unsharded(dit_inputs)
    want_jax = _jax_sharded(dit_inputs, mesh)
    np.testing.assert_allclose(want_jax, want, rtol=1e-4, atol=1e-5)
    for rank, out in enumerate(mesh_runs[mesh]):
        np.testing.assert_allclose(out["global"], want_jax, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["global"], want, rtol=1e-4, atol=1e-5)
        d = out["coords"][0]
        part = want.shape[0] // mesh[0]
        for backend in ("auto", "flash_sp", "ring"):
            np.testing.assert_allclose(out[f"mesh_{backend}"],
                                       want[d * part:(d + 1) * part], rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {rank} {backend}")


@pytest.mark.parametrize("mode", list(QUANT_MODES))
def test_w8a8_tensor_parallel_matches_jax_under_the_mesh(mesh_runs, quant_inputs, mode):
    tree = quant_inputs["trees"][mode]
    leaf = tree["blocks"]["mlp"]["w2"]
    assert {"q", "sa", "hs", "di"} <= set(leaf)
    want = _jax_sharded(quant_inputs, (1, 1, 2), worker.QUANT_CFG, tree)
    for out in mesh_runs[1, 1, 2]:
        got = out[f"quant_{mode}"]
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    # The unsharded port on the same tree, within the same bound.
    solo = _unsharded(quant_inputs, worker.QUANT_CFG, tree)
    assert np.linalg.norm(mesh_runs[1, 1, 2][0][f"quant_{mode}"] - solo) <= \
        1e-3 * np.linalg.norm(solo)


def test_row_parallel_amax_spans_the_whole_k(mesh_runs, amax_inputs):
    a = amax_inputs
    leaf = {k: torch.from_numpy(v) for k, v in a["leaf"].items()}
    want = dense_maybe_quantized(torch.from_numpy(a["x"]), leaf).numpy()
    for out in mesh_runs[1, 1, 2]:
        np.testing.assert_allclose(out["amax_sharded"], want, rtol=2e-5, atol=2e-5)
        # Each rank's own max quantizes the first half with other codes.
        assert np.abs(out["amax_local_only"] - want).max() > 1e-3


def test_generate_on_the_default_mesh(tmp_path):
    runs = worker.spawn_ranks("generate", tmp_path, 4, {})
    from torch_parallel_worker import tiny_pipeline

    video = np.random.default_rng(2).uniform(-1, 1, (2, 1, 32, 48, 3)).astype(np.float32)
    want = tiny_pipeline().generate({"rgb": video, "context_index": np.array([0, 3])}, seed=5)
    for out in runs:
        assert out["shape"] == (1, 2, 2)
        got = out["video"]
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_hybrid_mesh(tmp_path, dit_inputs):
    runs = worker.spawn_ranks("hybrid", tmp_path, 4, {"dit": dit_inputs},
                              env={"LOCAL_WORLD_SIZE": "2"})
    want = _jax_sharded(dit_inputs, (2, 1, 2))
    for rank, out in enumerate(runs):
        assert out["shape"] == (2, 1, 2)
        # The tensor group is the rank's own node.
        assert out["tensor_ranks"] == (rank // 2 * 2, rank // 2 * 2 + 1)
        assert out["coords"] == (rank // 2, 0, rank % 2)
        np.testing.assert_allclose(out["global"], want, rtol=1e-4, atol=1e-5)
        assert "span 4 nodes" in out["refused_nodes"] and "dcn_data=4" in out["refused_nodes"]
        assert "devices" in out["refused_devices"]


def test_param_shardings_refuse_layouts_that_cannot_split():
    from diffusionrenderer_tpu_torch.models.quant import quantize_tensor

    w = torch.randn(64, 256)
    g128 = quantize_tensor(w, act_quant=True, group_size=128)
    # Row-parallel K = 256 over 4 ranks is 64 columns each: half a group.
    with pytest.raises(ValueError, match="whole groups"):
        _leaf_shardings("w2", g128, 4, 0)
    assert _leaf_shardings("w2", g128, 2, 1)["sa"] == Sharding(0, 2, 1)
    assert _leaf_shardings("w1", g128, 2, 1)["sa"] == Sharding(1, 2, 1)
    had = quantize_tensor(w, act_quant=True, hadamard=True)
    with pytest.raises(ValueError, match="128-row"):
        _leaf_shardings("wo", had, 4, 0)
    assert _leaf_shardings("wo", had, 2, 0)["hs"] == Sharding(0, 2, 0)
    assert _leaf_shardings("wq", had, 4, 0)["hs"] == Sharding()
    assert _leaf_shardings("wo", had, 2, 0)["sa"] == Sharding()


def test_mesh_layouts_that_cannot_split_are_refused():
    from diffusionrenderer_tpu_torch.config import DiTConfig
    from diffusionrenderer_tpu_torch.models.dit import init_dit_params
    from diffusionrenderer_tpu_torch.parallel import Mesh, dit_param_shardings

    def mesh(tensor):  # a rank's view; dit_param_shardings reads its size and coordinate
        return Mesh(1, 1, tensor, 0, (0, 0, 0), ((tuple(range(tensor)),),), None, None, None,
                    None)

    params = init_dit_params(worker.SHARD_CFG, device="meta")
    with pytest.raises(ValueError, match="4 heads do not split over tensor=3"):
        dit_param_shardings(params, mesh(3))
    odd = init_dit_params(DiTConfig(model_channels=64, num_blocks=1, num_heads=4,
                                    mlp_ratio=99 / 64, adaln_lora_dim=8,
                                    crossattn_emb_channels=16, additional_concat_ch=16),
                          device="meta")
    with pytest.raises(ValueError, match="MLP hidden width 99 does not split over tensor=2"):
        dit_param_shardings(odd, mesh(2))


def test_every_jax_parallel_name_has_a_counterpart():
    import diffusionrenderer_tpu.parallel as jpar
    import diffusionrenderer_tpu_torch.parallel as tpar

    names = {n for n in dir(jpar) if not n.startswith("_") and not hasattr(
        getattr(jpar, n), "__path__") and n not in ("flash_sp", "pipeline_parallel",
                                                     "ring_attention", "sharding")}
    assert names and not names - set(dir(tpar))
