"""Rank body of the port's multi-rank CPU tests (tests/test_torch_tensor_parallel.py,
test_torch_pipeline_parallel.py, test_torch_sharded_train.py): one gloo rank
of a (data, seq, tensor) or (data, pipe) mesh.

Each rank is a fresh interpreter started by the spawn method (never forked
from the test process, which has JAX loaded) and imports torch and the port
only.  It reads its inputs from inputs.pkl in the test's temporary
directory, runs the named case, and writes what it returns to
<case>.out.<rank>.pkl there.  `spawn_ranks` is the test side."""

from __future__ import annotations

import multiprocessing
import os
import pickle
import socket

import numpy as np
import torch
import torch.distributed as dist

from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward
from diffusionrenderer_tpu_torch.models.quant import dense_maybe_quantized
from diffusionrenderer_tpu_torch.parallel import (dit_param_shardings, initialize_distributed,
                                                  make_hybrid_mesh, make_mesh, make_pp_executor,
                                                  make_pp_mesh, pp_block_shardings,
                                                  shard_params, token_sharding_constraint)
from diffusionrenderer_tpu_torch.parallel.collectives import all_reduce_sum
from diffusionrenderer_tpu_torch.training import (EdmDraws, edm_loss, init_train_state,
                                                  make_optimizer, make_train_step, train_loop)
from diffusionrenderer_tpu_torch.utils.tree import leaves, tree_map

RANK_TIMEOUT_S = 150

# The tiny DiT of tests/test_sharding.py (64 wide, 4 heads), and a 256-wide
# one whose row-parallel K / 2 is a whole 128-row Hadamard block.
SHARD_CFG = DiTConfig(model_channels=64, num_blocks=2, num_heads=4, adaln_lora_dim=8,
                      crossattn_emb_channels=16, additional_concat_ch=16)
QUANT_CFG = DiTConfig(model_channels=256, num_blocks=2, num_heads=4, adaln_lora_dim=8,
                      crossattn_emb_channels=16, additional_concat_ch=16)
PP_CFG = DiTConfig(model_channels=64, num_blocks=4, num_heads=4, adaln_lora_dim=8,
                   crossattn_emb_channels=16, additional_concat_ch=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(case: str, workdir, world: int, inputs=None, env=None):
    """Run `case` on `world` gloo ranks; returns every rank's result, in
    rank order.  Each rank is joined with its own timeout."""
    if inputs is not None:
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=run, args=(r, world, port, case, str(workdir), env or {}))
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
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{case}.out.{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(t):
    return t.detach().numpy().copy()


def _params(tree, cfg):
    return dit_params_from_numpy(tree, cfg, device="cpu")


def _inputs(d, *names):
    return tuple(torch.from_numpy(np.asarray(d[n])) for n in names)


def unshard(tree, shardings, mesh):
    """The whole tensors of a tree of tensor-parallel shards, gathered over
    the mesh's tensor group (None leaves stay None)."""
    def whole(t, sh):
        if t is None or sh.dim is None or sh.parts == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(mesh.tensor)]
        dist.all_gather(parts, t.contiguous(), group=mesh.tensor_group)
        return torch.cat(parts, dim=sh.dim)

    if isinstance(tree, dict):
        return {k: unshard(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unshard(v, s, mesh) for v, s in zip(tree, shardings))
    return whole(tree, shardings)


def _flat_np(tree):
    from diffusionrenderer_tpu_torch.utils.tree import flatten

    return {k: None if v is None else _np(v) for k, v in flatten(tree).items()}


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def case_tp_forward(inputs):
    """The sharded DiT forward on make_mesh(data, seq, tensor): the whole
    batch in and out (seq_sharding_constraint), and the pipeline's form
    (mesh=, this rank's rows) with each sequence-parallel attention; plus,
    at tensor = 2 alone, the W8A8 forwards and the row-parallel amax."""
    data, seq, tensor = inputs["mesh"]
    mesh = make_mesh(data * seq * tensor, data=data, seq=seq, tensor=tensor)
    d = inputs["dit"]
    params = _params(d["params"], SHARD_CFG)
    params = shard_params(params, dit_param_shardings(params, mesh))
    x, sigma, cond, ctx = _inputs(d, "x", "sigma", "cond", "ctx")
    out = {"coords": mesh.coords}
    with torch.no_grad():
        out["global"] = _np(dit_forward(params, x, sigma, cond, ctx, SHARD_CFG,
                                        seq_sharding_constraint=token_sharding_constraint(mesh)))
        # A multi-token context: the general cross-attention, its q / k / v
        # column-parallel and its out row-parallel, the context's rows
        # sliced over data beside x's.
        out["global_crossattn"] = _np(dit_forward(
            params, x, sigma, cond, ctx, SHARD_CFG, crossattn_emb=torch.from_numpy(d["emb"]),
            seq_sharding_constraint=token_sharding_constraint(mesh)))
        part = x.shape[0] // data
        rows = slice(mesh.coords[0] * part, (mesh.coords[0] + 1) * part)
        for backend in ("auto", "flash_sp", "ring"):
            y = dit_forward(params, x[rows], sigma[rows], cond[rows], ctx[rows], SHARD_CFG,
                            attn_backend=backend, mesh=mesh)
            out[f"mesh_{backend}"] = _np(y)
        for name, tree in inputs.get("quant", {}).items():
            qp = _params(tree, QUANT_CFG)
            qp = shard_params(qp, dit_param_shardings(qp, mesh))
            qx, qs, qc, qi = _inputs(inputs["quant_inputs"], "x", "sigma", "cond", "ctx")
            out[f"quant_{name}"] = _np(dit_forward(
                qp, qx, qs, qc, qi, QUANT_CFG,
                seq_sharding_constraint=token_sharding_constraint(mesh)))
        if "amax" in inputs:
            a = inputs["amax"]
            k = a["x"].shape[-1] // tensor
            t = mesh.coords[2]
            xa = torch.from_numpy(a["x"][:, t * k:(t + 1) * k])
            # A per-channel row-parallel leaf: this rank's input columns.
            leaf = {"q": torch.from_numpy(a["leaf"]["q"][:, t * k:(t + 1) * k].copy()),
                    "sa": torch.from_numpy(a["leaf"]["sa"])}
            out["amax_sharded"] = _np(dense_maybe_quantized(xa, leaf,
                                                            row_group=mesh.tensor_group))
            out["amax_local_only"] = _np(all_reduce_sum(dense_maybe_quantized(xa, leaf),
                                                        mesh.tensor_group))
    return out


def case_generate(inputs):
    """generate() of the tiny pipeline on make_mesh() with no factors; the
    same through a pipeline given the mesh in its constructor, and with
    defer_fetch (the whole uint8 tensor, still a tensor)."""
    from torch_parallel_worker import NET, TINY, tiny_pipeline

    from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline

    mesh = make_mesh()
    whole = tiny_pipeline()
    pipe = DiffusionRendererPipeline(whole.dit_params, whole.vae_params, num_steps=2,
                                     net_config=NET, vae_config=TINY).shard(mesh)
    by_ctor = DiffusionRendererPipeline(whole.dit_params, whole.vae_params, num_steps=2,
                                        net_config=NET, vae_config=TINY, mesh=mesh)
    video = np.random.default_rng(2).uniform(-1, 1, (2, 1, 32, 48, 3)).astype(np.float32)
    batch = {"rgb": video, "context_index": np.array([0, 3])}
    deferred = pipe.generate(batch, seed=5, defer_fetch=True)
    return {"shape": tuple(mesh.shape.values()), "video": pipe.generate(batch, seed=5),
            "video_ctor_mesh": by_ctor.generate(batch, seed=5),
            "ctor_mesh_is_sharded": by_ctor.mesh is mesh,
            "deferred_is_tensor": isinstance(deferred, torch.Tensor),
            "deferred": _np(deferred)}


def case_hybrid(inputs):
    """make_hybrid_mesh over two nodes modeled by LOCAL_WORLD_SIZE=2, its
    forward, and the refusals of a node count and a device count that do
    not match."""
    out = {}
    mesh = make_hybrid_mesh(dcn_data=2, data=1, seq=1, tensor=2)
    out["shape"] = tuple(mesh.shape.values())
    out["tensor_ranks"] = mesh.tensor_ranks
    out["coords"] = mesh.coords
    inputs = dict(inputs, mesh=(2, 1, 2))
    d = inputs["dit"]
    params = _params(d["params"], SHARD_CFG)
    params = shard_params(params, dit_param_shardings(params, mesh))
    x, sigma, cond, ctx = _inputs(d, "x", "sigma", "cond", "ctx")
    with torch.no_grad():
        out["global"] = _np(dit_forward(params, x, sigma, cond, ctx, SHARD_CFG,
                                        seq_sharding_constraint=token_sharding_constraint(mesh)))
    for name, lws, kw in (("nodes", "1", {"dcn_data": 2, "data": 1, "seq": 1, "tensor": 2}),
                          ("devices", "2", {"dcn_data": 3, "data": 1, "seq": 2, "tensor": 2})):
        os.environ["LOCAL_WORLD_SIZE"] = lws
        try:
            make_hybrid_mesh(**kw)
        except ValueError as e:
            out[f"refused_{name}"] = str(e)
    return out


def _pp_run(inputs, mesh, m, remat=False, data_axis="data", grad=False, crossattn=False):
    d = inputs["dit"]
    params = _params(d["params"], PP_CFG)
    params["blocks"] = pp_block_shardings(mesh)(params["blocks"])
    x, sigma, cond, ctx = _inputs(d, "x", "sigma", "cond", "ctx")
    executor = make_pp_executor(mesh, m, remat=remat, data_axis=data_axis)
    if not grad:
        emb = torch.from_numpy(d["emb"]) if crossattn else None
        with torch.no_grad():
            return _np(dit_forward(params, x, sigma, cond, ctx, PP_CFG, attn_backend="xla",
                                   block_executor=executor, crossattn_emb=emb))
    for t in leaves(params):
        if t is not None:
            t.requires_grad_(True)
    out = dit_forward(params, x, sigma, cond, ctx, PP_CFG, attn_backend="xla",
                      block_executor=executor)
    torch.mean(out ** 2).backward()
    return _flat_np(tree_map(lambda t: t.grad, params))


def case_pp(inputs):
    """GPipe on make_pp_mesh(stages, data): each listed run's output (or
    gradients), every rank's."""
    stages, data = inputs["pp_mesh"]
    mesh = make_pp_mesh(stages, data=data)
    out = {"coords": mesh.coords}
    for name, kw in inputs["runs"].items():
        try:
            out[name] = _pp_run(inputs, mesh, **kw)
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    if "train" in inputs:
        out["train"] = _pp_train(inputs["train"], mesh)
    return out


def _pp_train(t, mesh):
    """Two AdamW steps through the GPipe executor on injected draws."""
    params = _params(t["params"], PP_CFG)
    params["blocks"] = pp_block_shardings(mesh)(params["blocks"])
    opt = make_optimizer(t["lr"])
    step = make_train_step(PP_CFG, opt, block_executor=make_pp_executor(mesh, t["m"]))
    state = init_train_state(params, opt)
    batch = {k: torch.from_numpy(v) for k, v in t["batch"].items()}
    losses = []
    for draws in t["draws"]:
        state, loss = step(state, batch, draws=[EdmDraws(*map(torch.from_numpy, draws))])
        losses.append(float(loss))
    return {"losses": losses, "params": _flat_np(state.params)}


def _train_mesh(inputs):
    data, seq, tensor = inputs["mesh"]
    return make_mesh(data * seq * tensor, data=data, seq=seq, tensor=tensor)


def case_train(inputs):
    """On make_mesh(data, seq, tensor): every leaf's gradient of one edm_loss
    (gathered whole), with the default attention and with ring attention, a 3-step AdamW trajectory on injected draws (losses
    and whole parameters), and train_loop run straight and resumed."""
    mesh = _train_mesh(inputs)
    t = inputs["train"]
    constraint = token_sharding_constraint(mesh)
    full = _params(t["params"], SHARD_CFG)
    shardings = dit_param_shardings(full, mesh)
    batch = {k: torch.from_numpy(v) for k, v in t["batch"].items()}
    out = {}

    params = shard_params(_params(t["params"], SHARD_CFG), shardings)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = edm_loss(params, batch["latents"], batch["latent_condition"], batch["context_index"],
                    None, SHARD_CFG, condition_drop_rate=0.5, seq_sharding_constraint=constraint,
                    draws=EdmDraws(*map(torch.from_numpy, t["draws"][0])))
    loss.backward()
    out["loss"] = float(loss)
    out["grads"] = _flat_np(unshard(tree_map(lambda p: p.grad, params), shardings, mesh))

    # The same loss through ring attention over seq (exact attention, so
    # JAX's sharded gradient is its reference too).
    params = shard_params(_params(t["params"], SHARD_CFG), shardings)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = edm_loss(params, batch["latents"], batch["latent_condition"], batch["context_index"],
                    None, SHARD_CFG, condition_drop_rate=0.5, seq_sharding_constraint=constraint,
                    draws=EdmDraws(*map(torch.from_numpy, t["draws"][0])), attn_backend="ring")
    loss.backward()
    out["loss_ring"] = float(loss)
    out["grads_ring"] = _flat_np(unshard(tree_map(lambda p: p.grad, params), shardings, mesh))

    opt = make_optimizer(t["lr"])
    step = make_train_step(SHARD_CFG, opt, condition_drop_rate=0.5,
                           seq_sharding_constraint=constraint)
    state = init_train_state(shard_params(_params(t["params"], SHARD_CFG), shardings), opt)
    losses = []
    for draws in t["draws"]:
        state, loss = step(state, batch, draws=[EdmDraws(*map(torch.from_numpy, draws))])
        losses.append(float(loss))
    out["losses"] = losses
    out["params"] = _flat_np(unshard(state.params, shardings, mesh))

    def make_state():
        # Contiguous leaves, as a restored state has: a transposed view of
        # the numpy weights would take other matmul paths, and round
        # otherwise, than its restored copy.
        params = tree_map(lambda p: p.contiguous(), _params(t["params"], SHARD_CFG))
        return init_train_state(shard_params(params, shardings), make_optimizer(t["lr"]))

    def batch_fn(s):
        rng = np.random.default_rng(1000 + s)
        return {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
                if v.dtype == np.float32 else torch.from_numpy(v) for k, v in t["batch"].items()}

    loop_step = make_train_step(SHARD_CFG, make_optimizer(t["lr"]), condition_drop_rate=0.5,
                                seq_sharding_constraint=constraint)
    kw = dict(num_steps=4, seed=7, log_every=0, device="cpu", mesh=mesh, save_every=2)
    ckpt = os.path.join(inputs["workdir"], "ckpt")
    straight, l_straight = train_loop(make_state, loop_step, batch_fn, **kw)
    first, l_first = train_loop(make_state, loop_step, batch_fn, ckpt_dir=ckpt,
                                **dict(kw, num_steps=2))
    resumed, l_resumed = train_loop(make_state, loop_step, batch_fn, ckpt_dir=ckpt, **kw)
    pairs = list(zip(leaves(straight.params) + leaves(straight.opt_state.mu)
                     + leaves(straight.opt_state.nu),
                     leaves(resumed.params) + leaves(resumed.opt_state.mu)
                     + leaves(resumed.opt_state.nu)))
    out["resume_bitwise"] = (all(torch.equal(a, b) for a, b in pairs)
                             and straight.step == resumed.step == 4
                             and l_first + l_resumed == l_straight)
    out["resume_files"] = sorted(os.listdir(os.path.join(ckpt, "4")))
    return out


CASES = {"tp_forward": case_tp_forward, "generate": case_generate, "hybrid": case_hybrid,
         "pp": case_pp, "train": case_train}


def run(rank: int, world: int, port: int, case: str, workdir: str, env) -> None:
    os.environ.update(env)
    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"tcp://localhost:{port}", world_size=world,
                           rank=rank)
    try:
        path = os.path.join(workdir, "inputs.pkl")
        inputs = {}
        if os.path.exists(path):
            with open(path, "rb") as f:
                inputs = pickle.load(f)
        inputs["workdir"] = workdir
        out = CASES[case](inputs)
        with open(os.path.join(workdir, f"{case}.out.{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
