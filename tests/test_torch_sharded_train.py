"""The port's sharded train step and train loop on gloo ranks, against the
JAX package's sharded make_train_step on its 8-device CPU mesh with the
same factors, and against the unsharded port, in fp32 on the CPU.

One spawn per mesh, (data, seq, tensor) = (1, 2, 2) and (2, 1, 1), shared
by its cases (tests/torch_mesh_worker.py).  Every rank passes the whole
batch with JAX's draws injected (EdmDraws), as tests/test_torch_train.py
does.  Covered, at tests/test_torch_train.py's tolerances:

* one edm_loss's gradient of every leaf, gathered whole from the tensor
  shards: within 1e-5 of the leaf's largest element of jax.grad, and of
  the unsharded port; the loss 1e-5 relative.  The q/k norms (shared by
  the heads a tensor rank splits) and every replicated leaf get a gradient;
  the cross-attention's q / k leaves, which nothing reads, get none;
* a three-step AdamW trajectory: losses 1e-5 relative against JAX's
  sharded step; the parameters to 1e-6 on all but 0.5% of the elements
  and to 2 lr * steps on every one;
* train_loop, 4 steps straight against 2 + resume + 2 on the same mesh,
  bitwise on every rank, each rank with its own shard file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.parallel import batch_sharding, dit_param_shardings
from diffusionrenderer_tpu.parallel import make_mesh as j_make_mesh
from diffusionrenderer_tpu.parallel import shard_params, token_sharding_constraint
from diffusionrenderer_tpu.training import init_train_state as j_init_state
from diffusionrenderer_tpu.training import make_optimizer as j_make_optimizer
from diffusionrenderer_tpu.training import make_train_step as j_make_train_step
from diffusionrenderer_tpu.training.train import edm_loss as j_edm_loss
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.training import EdmDraws, edm_loss
from diffusionrenderer_tpu_torch.utils.tree import flatten

CFG = worker.SHARD_CFG
LR = 1e-3
MESHES = [(1, 2, 2), (2, 1, 1)]
UNUSED = ("ca/wq", "ca/wk", "ca/q_norm", "ca/k_norm")


def jcfg():
    return JDiTConfig(**dataclasses.asdict(CFG))


def jax_draws(key, b, shape):
    """JAX edm_loss's draws for `key`: split in three, normal, normal, uniform."""
    ks, kn, kd = jax.random.split(key, 3)
    return tuple(np.asarray(x) for x in (jax.random.normal(ks, (b,), jnp.float32),
                                         jax.random.normal(kn, shape, jnp.float32),
                                         jax.random.uniform(kd, (b,))))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    b = 2
    batch = {"latents": rng.standard_normal((b, 2, 8, 8, 16)).astype(np.float32),
             "latent_condition": rng.standard_normal((b, 2, 8, 8, 16)).astype(np.float32),
             "context_index": np.array([3, 1], np.int32)}
    keys = [jax.random.key(100 + s) for s in range(3)]
    params = jax.device_get(j_init_dit(jax.random.key(0), jcfg(), dtype=jnp.float32))
    return {"params": params, "batch": batch, "keys": keys, "lr": LR,
            "draws": [jax_draws(k, b, batch["latents"].shape) for k in keys]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, setup):
    train = {k: setup[k] for k in ("params", "batch", "draws", "lr")}
    out = {}
    for mesh in MESHES:
        workdir = tmp_path_factory.mktemp("train_{}x{}x{}".format(*mesh))
        out[mesh] = worker.spawn_ranks("train", workdir, int(np.prod(mesh)),
                                       {"mesh": mesh, "train": train})
    return out


def _port_flat(tree):
    return {k: v.numpy() for k, v in flatten(dit_params_from_numpy(tree, CFG, device="cpu"))
            .items()}


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_gradients_match_jax_leaf_by_leaf(runs, setup, mesh):
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    loss_fn = jax.jit(lambda p, key: j_edm_loss(p, *jb.values(), key, jcfg(),
                                                condition_drop_rate=0.5))
    jloss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, setup["params"]),
                                                setup["keys"][0])
    want = _port_flat(jax.device_get(jgrads))
    # The unsharded port on the same draws.
    tp = dit_params_from_numpy(setup["params"], CFG, device="cpu")
    for p in flatten(tp).values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    loss = edm_loss(tp, *tb.values(), None, CFG, condition_drop_rate=0.5,
                    draws=EdmDraws(*map(torch.from_numpy, setup["draws"][0])))
    loss.backward()
    solo = {k: None if p.grad is None else p.grad.numpy() for k, p in flatten(tp).items()}
    for rank, out in enumerate(runs[mesh]):
        np.testing.assert_allclose(out["loss"], float(jloss), rtol=1e-5)
        got = out["grads"]
        assert set(got) == set(want)
        for key, w in want.items():
            if key.endswith(UNUSED):
                assert got[key] is None and not np.any(w), key
                continue
            assert got[key] is not None, (rank, key)
            scale = np.abs(w).max()
            assert scale > 0, key
            assert np.abs(got[key] - w).max() <= 1e-5 * scale, (rank, key)
            assert np.abs(got[key] - solo[key]).max() <= 1e-5 * scale, (rank, key)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_trajectory_matches_jax_sharded_step(runs, setup, mesh):
    data, seq, tensor = mesh
    jmesh = j_make_mesh(data * seq * tensor, data=data, seq=seq, tensor=tensor)
    params = jax.tree.map(jnp.asarray, setup["params"])
    params = shard_params(params, dit_param_shardings(params, jmesh))
    opt = j_make_optimizer(LR)
    step = j_make_train_step(jcfg(), opt, condition_drop_rate=0.5, donate=False,
                             seq_sharding_constraint=token_sharding_constraint(jmesh))
    bs = batch_sharding(jmesh)
    batch = {"latents": jax.device_put(setup["batch"]["latents"], bs),
             "latent_condition": jax.device_put(setup["batch"]["latent_condition"], bs),
             "context_index": jnp.asarray(setup["batch"]["context_index"])}
    state = j_init_state(params, opt)
    losses = []
    with jmesh:
        for key in setup["keys"]:
            state, loss = step(state, batch, key)
            losses.append(float(loss))
    want = _port_flat(jax.device_get(state.params))
    for rank, out in enumerate(runs[mesh]):
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        got = np.concatenate([out["params"][k].ravel() for k in want])
        ref = np.concatenate([w.ravel() for w in want.values()])
        err = np.abs(got - ref)
        assert err.max() <= 2 * LR * 3, rank
        assert np.mean(err > 1e-6) < 5e-3, rank


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_train_loop_resumes_bitwise(runs, mesh):
    world = int(np.prod(mesh))
    for out in runs[mesh]:
        assert out["resume_bitwise"]
        assert out["resume_files"] == sorted(f"state-{r}-of-{world}.safetensors"
                                             for r in range(world))
