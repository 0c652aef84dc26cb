"""The port's multi-device path on torch.distributed, against the JAX
package's on its 8-device CPU mesh (tensor = 1) and against the unsharded
port.

Each case starts its gloo ranks (2 to 5) as separate interpreters by the
spawn method, never fork, since this process has JAX loaded; each rank runs
tests/torch_parallel_worker.py, which imports the port only, and each is
joined with its own timeout.  Covered, in fp32:

* ring attention (impl 'xla' and 'flash') and make_sp_attention ('flash':
  all-gather KV; 'ring') at (data, seq) = (1, 4) and (2, 2), against JAX's
  make_ring_attention / make_sp_attention: 1e-5 (exact attention computed
  in differently ordered fp32 sums);
* the q, k and v gradients of sum(out * w), w seeded, through ring
  attention 'xla' (autograd over ShiftFunction hops), 'flash'
  (RingAttentionFunction, kernel 3's plain version here) and
  make_sp_attention('ring'), against jax.grad of JAX's
  make_ring_attention(impl='xla') on the same mesh: 1e-5 of the largest
  element;
* a tiny sharded dit_forward ('ring', 'flash_sp', and 'auto', which on
  CPU tensors is the plain attention on the all-gathered KV) against the
  unsharded port and JAX's sharded forward: rtol 1e-4, atol 1e-5, as
  tests/test_sharding.py holds JAX's sharded forward to its unsharded one;
* generate() at (1, 2) with sp_attn='ring' against the unsharded port:
  within 1 uint8 count (tests/test_sharding.py:151-181);
* the 5-pass inverse_render(batch_passes=True) with its rows on a data=5
  mesh against the unsharded port: within 1.5/255
  (tests/test_sharding.py:183-224).

The tensor axis, GPipe and the sharded train step are held in
test_torch_tensor_parallel.py, test_torch_pipeline_parallel.py and
test_torch_sharded_train.py.

Point-to-point rotation and all-gather at world size > 1 are checked here
only: the card's run has one rank.
"""

import multiprocessing
import os
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models.dit import dit_forward as j_dit_forward
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.parallel import batch_sharding
from diffusionrenderer_tpu.parallel import dit_param_shardings, shard_params
from diffusionrenderer_tpu.parallel import make_mesh as j_make_mesh
from diffusionrenderer_tpu.parallel import make_sp_attention as j_make_sp
from diffusionrenderer_tpu.parallel import token_sharding_constraint
from diffusionrenderer_tpu.parallel.ring_attention import make_ring_attention as j_make_ring
from diffusionrenderer_tpu_torch.api import INVERSE_PASSES, inverse_render
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.models.dit import dit_forward
from diffusionrenderer_tpu_torch.parallel import mesh_shape

RANK_TIMEOUT_S = 120
MESHES = [(1, 4), (2, 2)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(case: str, workdir, data: int, seq: int):
    """Run `case` on data * seq gloo ranks; returns rank 0's results."""
    ctx = multiprocessing.get_context("spawn")
    world, port = data * seq, _free_port()
    procs = [ctx.Process(target=worker.run, args=(r, world, port, case, str(workdir), data, seq))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RANK_TIMEOUT_S)
            assert not p.is_alive(), f"{case}: a rank did not finish in {RANK_TIMEOUT_S} s"
            assert p.exitcode == 0, f"{case}: a rank exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    with open(os.path.join(workdir, f"{case}.out.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def dit_inputs():
    cfg = JDiTConfig(**{f: getattr(worker.SHARD_CFG, f) for f in
                        ("model_channels", "num_blocks", "num_heads", "adaln_lora_dim",
                         "crossattn_emb_channels", "additional_concat_ch")})
    rng = np.random.default_rng(1)
    return {"cfg": cfg,
            "params": jax.device_get(j_init_dit(jax.random.key(0), cfg, dtype=jnp.float32)),
            "x": rng.standard_normal((4, 2, 8, 8, 16)).astype(np.float32),
            "cond": rng.standard_normal((4, 2, 8, 8, 16)).astype(np.float32),
            "sigma": np.full((4,), 7.5, np.float32), "ctx": np.array([0, 1, 2, 3])}


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(5)
    return tuple(rng.standard_normal((2, 64, 4, 16)).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def out_weight(qkv):
    return np.random.default_rng(6).standard_normal(qkv[0].shape).astype(np.float32)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, qkv, out_weight, dit_inputs):
    """Each mesh's rank-0 results: attention, its gradients and the DiT forward."""
    runs = {}
    dit = {k: dit_inputs[k] for k in ("params", "x", "cond", "sigma", "ctx")}
    for data, seq in MESHES:
        workdir = tmp_path_factory.mktemp(f"mesh_{data}x{seq}")
        with open(workdir / "inputs.pkl", "wb") as f:
            pickle.dump({"qkv": qkv, "w": out_weight, "dit": dit}, f)
        runs[data, seq] = run_ranks("mesh", workdir, data, seq)
    return runs


def _jax_mesh(data, seq):
    return j_make_mesh(data * seq, data=data, seq=seq, tensor=1)


@pytest.mark.parametrize("data,seq", MESHES)
@pytest.mark.parametrize("name,impl", [("ring_xla", "ring"), ("ring_flash", "ring"),
                                       ("sp_ring", "ring"), ("sp_flash", "flash")])
def test_sequence_parallel_attention_matches_jax(mesh_runs, qkv, data, seq, name, impl):
    mesh = _jax_mesh(data, seq)
    jq, jk, jv = (jnp.asarray(x) for x in qkv)
    want = np.asarray(j_make_ring(mesh)(jq, jk, jv) if impl == "ring"
                      else j_make_sp(mesh, impl="flash")(jq, jk, jv))
    np.testing.assert_allclose(mesh_runs[data, seq][name], want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_ring_grads(qkv, out_weight):
    """jax.grad of sum(make_ring_attention(mesh, impl='xla')(q, k, v) * w)
    on each mesh: [dq, dk, dv]."""
    grads = {}
    for data, seq in MESHES:
        ring = j_make_ring(_jax_mesh(data, seq), impl="xla")
        w = jnp.asarray(out_weight)
        fn = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) * w), argnums=(0, 1, 2)))
        grads[data, seq] = [np.asarray(g) for g in fn(*(jnp.asarray(x) for x in qkv))]
    return grads


@pytest.mark.parametrize("data,seq", MESHES)
@pytest.mark.parametrize("name", ["ring_xla", "ring_flash", "sp_ring"])
def test_sequence_parallel_attention_grads_match_jax(mesh_runs, jax_ring_grads, data, seq,
                                                     name):
    got = mesh_runs[data, seq][f"grad_{name}"]
    for which, g, w in zip("qkv", got, jax_ring_grads[data, seq]):
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g - w).max() <= 1e-5 * scale, (
            which, np.abs(g - w).max(), scale)


@pytest.mark.parametrize("data,seq", MESHES)
@pytest.mark.parametrize("backend", ["ring", "flash_sp", "auto"])
def test_sharded_dit_forward_matches_unsharded_port(mesh_runs, dit_inputs, data, seq, backend):
    d = dit_inputs
    params = dit_params_from_numpy(d["params"], worker.SHARD_CFG, device="cpu")
    want = dit_forward(params, *(torch.from_numpy(d[n]) for n in ("x", "sigma", "cond", "ctx")),
                       worker.SHARD_CFG).numpy()
    np.testing.assert_allclose(mesh_runs[data, seq][f"dit_{backend}"], want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["ring", "flash_sp"])
def test_sharded_dit_forward_matches_jax_sharded(mesh_runs, dit_inputs, backend):
    d = dit_inputs
    mesh = _jax_mesh(2, 2)
    params = shard_params(jax.tree.map(jnp.asarray, d["params"]),
                          dit_param_shardings(d["params"], mesh))
    bs = batch_sharding(mesh)
    constraint = token_sharding_constraint(mesh)

    @jax.jit
    def fwd(p, x, s, c, ci):
        return j_dit_forward(p, x, s, c, ci, d["cfg"], seq_sharding_constraint=constraint,
                             attn_backend=backend, mesh=mesh)

    with mesh:
        want = np.asarray(fwd(params, jax.device_put(d["x"], bs), d["sigma"],
                              jax.device_put(d["cond"], bs), d["ctx"]))
    np.testing.assert_allclose(mesh_runs[2, 2][f"dit_{backend}"], want, rtol=1e-4, atol=1e-5)


def test_mesh_factor_rule_matches_jax():
    for n in range(1, 9):
        jm = j_make_mesh(n)
        assert mesh_shape(n) == tuple(jm.shape[a] for a in ("data", "seq", "tensor")), n
    assert mesh_shape(4, data=1, seq=4, tensor=1) == (1, 4, 1)
    with pytest.raises(ValueError, match="devices"):
        mesh_shape(4, data=2, seq=4, tensor=1)


def test_sharded_generate_matches_unsharded(tmp_path):
    got = run_ranks("generate", tmp_path, 1, 2)["video"]
    video = np.random.default_rng(2).uniform(-1, 1, (2, 1, 32, 48, 3)).astype(np.float32)
    want = worker.tiny_pipeline().generate({"rgb": video, "context_index": np.array([0, 3])},
                                           seed=5)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batched_5pass_inverse_render_on_data_mesh(tmp_path):
    got = run_ranks("inverse", tmp_path, 5, 1)
    img = np.random.default_rng(9).uniform(size=(1, 32, 48, 3)).astype(np.float32)
    want = inverse_render(worker.tiny_pipeline(), img, batch_passes=True)
    assert set(got) == set(want) == set(INVERSE_PASSES)
    for k in want:
        assert np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)).max() \
            <= 1.5 / 255.0, k
