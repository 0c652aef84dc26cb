"""The port's GPipe executor (parallel/pipeline_parallel.py) on gloo ranks,
against the JAX package: the cases of tests/test_pipeline_parallel.py at
meshes of at most 4 ranks, in fp32 on the CPU.

One spawn per (stages, data) mesh (tests/torch_mesh_worker.py), shared by
its runs.  Every rank returns the whole output.  Covered:

* forward, against JAX's plain forward and JAX's own executor on a mesh of
  the same factors: (stages, data) = (2, 2) with M = 4, with remat, and
  M = 3 refused; (4, 1) with M = 8 and data_axis=None; (2, 1) with M = 8,
  more microbatches than stages: rtol 1e-4, atol 1e-5
  (tests/test_pipeline_parallel.py:66-99);
* the gradient of mean(out ** 2) with respect to every parameter at
  (2, 2), M = 4, remat on and off, against jax.grad of the plain forward:
  rtol 2e-3, atol 2e-5 (tests/test_pipeline_parallel.py:101-135).  Each
  block's gradient is read on the stage that holds it, and every rank's
  stem and final-layer gradients are checked;
* two AdamW train steps through the executor at (2, 2) against the
  unsharded port's steps on the same draws: losses 1e-5 relative, the
  parameters to 1e-6 on all but 0.5% of elements and 2 lr * steps on every
  one (tests/test_torch_train.py's rule after AdamW);
* in-process: make_block_apply (the executor's unit, with capture_sites)
  and dit_forward's mlp_token_chunks against JAX's (1e-4 / 1e-5), and the
  executor's refusal of '_mixN' mixed-precision blocks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.models.dit import dit_forward as j_dit_forward
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.parallel.pipeline_parallel import make_pp_executor as j_pp_executor
from diffusionrenderer_tpu.parallel.pipeline_parallel import make_pp_mesh as j_pp_mesh
from diffusionrenderer_tpu.parallel.pipeline_parallel import pp_block_shardings as j_pp_shardings
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.training import (EdmDraws, init_train_state, make_optimizer,
                                                  make_train_step)
from diffusionrenderer_tpu_torch.utils.tree import flatten

CFG = worker.PP_CFG
LR = 1e-3
RUNS = {
    (2, 2): {"m4": {"m": 4}, "remat": {"m": 4, "remat": True}, "m3": {"m": 3},
             "grad": {"m": 4, "grad": True}, "grad_remat": {"m": 4, "remat": True, "grad": True}},
    (4, 1): {"m8_no_data": {"m": 8, "data_axis": None}},
    (2, 1): {"m8": {"m": 8}},
}
JAX_RUNS = {"m4": ((2, 2), 4, {}), "remat": ((2, 2), 4, {"remat": True}),
            "m8_no_data": ((4, 1), 8, {"data_axis": None}), "m8": ((2, 1), 8, {})}


@pytest.fixture(scope="module")
def setup():
    jcfg = JDiTConfig(**dataclasses.asdict(CFG))
    params = j_init_dit(jax.random.key(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    b = 8
    d = {"params": jax.device_get(params),
         "x": rng.standard_normal((b, 2, 8, 8, 16)).astype(np.float32),
         "cond": rng.standard_normal((b, 2, 8, 8, 16)).astype(np.float32),
         "sigma": np.linspace(0.5, 40.0, b).astype(np.float32),
         "ctx": (np.arange(b) % 8).astype(np.int32)}
    args = [jnp.asarray(d[n]) for n in ("x", "sigma", "cond", "ctx")]
    expected = np.asarray(j_dit_forward(params, *args, jcfg, attn_backend="xla"))

    def loss(p):
        return jnp.mean(j_dit_forward(p, *args, jcfg, attn_backend="xla") ** 2)

    grads = jax.device_get(jax.jit(jax.grad(loss))(params))
    return {"dit": d, "jcfg": jcfg, "expected": expected, "grads": grads}


def _train_inputs(d):
    rng = np.random.default_rng(12)
    b = 4
    batch = {"latents": rng.standard_normal((b, 2, 8, 8, 16)).astype(np.float32),
             "latent_condition": rng.standard_normal((b, 2, 8, 8, 16)).astype(np.float32),
             "context_index": np.array([3, 1, 0, 5])}
    draws = [(rng.standard_normal(b).astype(np.float32),
              rng.standard_normal(batch["latents"].shape).astype(np.float32),
              rng.uniform(size=b).astype(np.float32)) for _ in range(2)]
    return {"params": d["params"], "batch": batch, "draws": draws, "lr": LR, "m": 2}


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory, setup):
    out = {}
    for (stages, data), runs in RUNS.items():
        inputs = {"pp_mesh": (stages, data), "dit": setup["dit"], "runs": runs}
        if (stages, data) == (2, 2):
            inputs["train"] = _train_inputs(setup["dit"])
        workdir = tmp_path_factory.mktemp(f"pp_{stages}x{data}")
        out[stages, data] = worker.spawn_ranks("pp", workdir, stages * data, inputs)
    return out


def _jax_pp(setup, factors, m, kw):
    stages, data = factors
    mesh = j_pp_mesh(num_stages=stages, data=data)
    executor = j_pp_executor(mesh, m, **kw)
    params = dict(jax.tree.map(jnp.asarray, setup["dit"]["params"]))
    params["blocks"] = jax.tree.map(lambda t: jax.device_put(t, j_pp_shardings(mesh)),
                                    params["blocks"])
    d = setup["dit"]

    @jax.jit
    def fwd(p, x, s, c, ci):
        return j_dit_forward(p, x, s, c, ci, setup["jcfg"], attn_backend="xla",
                             block_executor=executor)

    with mesh:
        return np.asarray(fwd(params, *(d[n] for n in ("x", "sigma", "cond", "ctx"))))


@pytest.mark.parametrize("run", list(JAX_RUNS))
def test_pp_forward_matches_jax(pp_runs, setup, run):
    factors, m, kw = JAX_RUNS[run]
    want = _jax_pp(setup, factors, m, kw)
    np.testing.assert_allclose(want, setup["expected"], rtol=1e-4, atol=1e-5)
    for rank, out in enumerate(pp_runs[factors]):
        np.testing.assert_allclose(out[run], setup["expected"], rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {rank}")


def test_pp_rejects_indivisible(pp_runs):
    for out in pp_runs[2, 2]:
        assert out["m3"].startswith("ValueError") and "not divisible" in out["m3"]


def _jax_grads_flat(setup):
    """JAX's gradients in the port's flat keys and (out, in) layout."""
    tree = dit_params_from_numpy(setup["grads"], CFG, device="cpu")
    return {k: v.numpy() for k, v in flatten(tree).items()}


@pytest.mark.parametrize("run", ["grad", "grad_remat"])
def test_pp_gradients_match_jax(pp_runs, setup, run):
    want = _jax_grads_flat(setup)
    per_stage = CFG.num_blocks // 2
    for rank, out in enumerate(pp_runs[2, 2]):
        got = out[run]
        stage = out["coords"][1]
        assert set(got) <= set(want) | {f"blocks/{i}" for i in range(CFG.num_blocks)}
        for key, w in want.items():
            if key.startswith("blocks/"):
                block = int(key.split("/")[1])
                if block // per_stage != stage:
                    assert f"blocks/{block}" in got and got[f"blocks/{block}"] is None
                    continue
            if "ca/wq" in key or "ca/wk" in key or "ca/q_norm" in key or "ca/k_norm" in key:
                assert got[key] is None  # never read: no gradient (JAX: zeros)
                assert not np.any(w)
                continue
            np.testing.assert_allclose(got[key], w, rtol=2e-3, atol=2e-5,
                                       err_msg=f"rank {rank} {key}")


def test_pp_train_steps_match_unsharded(pp_runs, setup):
    t = _train_inputs(setup["dit"])
    params = dit_params_from_numpy(t["params"], CFG, device="cpu")
    opt = make_optimizer(LR)
    step = make_train_step(CFG, opt)
    state = init_train_state(params, opt)
    batch = {k: torch.from_numpy(v) for k, v in t["batch"].items()}
    losses = []
    for draws in t["draws"]:
        state, loss = step(state, batch, draws=[EdmDraws(*map(torch.from_numpy, draws))])
        losses.append(float(loss))
    want = {k: v.numpy() for k, v in flatten(state.params).items()}
    for rank, out in enumerate(pp_runs[2, 2]):
        got = out["train"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for key, w in want.items():
            g = got["params"].get(key)
            if g is None:  # another stage's block
                continue
            diff = np.abs(g - w)
            assert diff.max() <= 2 * LR * len(losses) + 1e-6, (rank, key)
            assert np.mean(diff > 1e-6 + 1e-6 * np.abs(w)) <= 5e-3, (rank, key)


def test_block_apply_and_mlp_token_chunks_match_jax(setup):
    """make_block_apply (the executor's unit) and dit_forward's
    mlp_token_chunks against JAX's, in-process: chunking the MLP's tokens
    leaves the forward as it was (1e-5), and capture_sites sees the
    calibration sites of models/quant.LEAF_SITE."""
    from diffusionrenderer_tpu_torch.models.dit import dit_forward, make_block_apply

    d = setup["dit"]
    params = dit_params_from_numpy(d["params"], CFG, device="cpu")
    args = [torch.from_numpy(d[n]) for n in ("x", "sigma", "cond", "ctx")]
    jargs = [jnp.asarray(d[n]) for n in ("x", "sigma", "cond", "ctx")]
    want = np.asarray(j_dit_forward(jax.tree.map(jnp.asarray, d["params"]), *jargs,
                                    setup["jcfg"], attn_backend="xla", mlp_token_chunks=4))
    with torch.no_grad():
        got = dit_forward(params, *args, CFG, attn_backend="xla", mlp_token_chunks=4).numpy()
        plain = dit_forward(params, *args, CFG, attn_backend="xla").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)

    b, l, dim = 2, 16, CFG.model_channels
    rng = np.random.default_rng(3)
    x, emb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((b, l, dim), (b, dim)))
    lora = torch.from_numpy(rng.standard_normal((b, 3 * dim)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((b, 1, 16)).astype(np.float32))
    cos, sin = torch.ones(l, CFG.head_dim), torch.zeros(l, CFG.head_dim)
    with torch.no_grad():
        y, sites = make_block_apply(CFG, "xla", capture_sites=True)(
            params["blocks"][0], x, emb, lora, ctx, cos, sin)
        y1 = make_block_apply(CFG, "xla", mlp_token_chunks=2)(
            params["blocks"][0], x, emb, lora, ctx, cos, sin)
    assert set(sites) == {"fa.qkv", "fa.wo", "ca.wv", "ca.wo", "mlp.w1", "mlp.w2"}
    torch.testing.assert_close(y1, y, rtol=1e-5, atol=1e-6)


def test_block_executor_refuses_mixed_precision_blocks(setup):
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.models.quant import quantize_block

    params = dit_params_from_numpy(setup["dit"]["params"], CFG, device="cpu")
    params["blocks"][0] = quantize_block(params["blocks"][0], act_quant=True)
    args = [torch.from_numpy(setup["dit"][n]) for n in ("x", "sigma", "cond", "ctx")]
    with pytest.raises(ValueError, match="'_mixN'"):
        with torch.no_grad():
            dit_forward(params, *args, CFG, block_executor=lambda *a: None)
