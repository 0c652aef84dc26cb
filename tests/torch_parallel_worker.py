"""Rank body of tests/test_torch_parallel.py: one gloo rank of the port's
(data, seq) mesh.  Each rank is a fresh interpreter started by the spawn
method (never forked from the test process, which has JAX loaded), and this
module imports torch and the port only.  Inputs come from, and rank 0's
results go to, pickles of numpy arrays in the test's own temporary
directory."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from diffusionrenderer_tpu_torch.api import inverse_render, load_pipeline
from diffusionrenderer_tpu_torch.checkpoint import dit_params_from_numpy
from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward
from diffusionrenderer_tpu_torch.parallel import (
    batch_slice,
    gather_batch,
    gather_tokens,
    initialize_distributed,
    make_mesh,
    make_ring_attention,
    make_sp_attention,
    token_slice,
)

# The tiny DiT of tests/test_sharding.py and the pipeline's of
# tests/test_torch_pipeline.py, with the TINY VAE.
SHARD_CFG = DiTConfig(model_channels=64, num_blocks=2, num_heads=4, adaln_lora_dim=8,
                      crossattn_emb_channels=16, additional_concat_ch=16)
NET = DiTConfig(model_channels=96, num_blocks=2, num_heads=2, in_channels=16, out_channels=16,
                additional_concat_ch=16, adaln_lora_dim=8, crossattn_emb_channels=16,
                use_context_embedding=True)
TINY = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                 decode_block_out_channels=(12, 16, 16, 16), num_layers=1)


def tiny_pipeline():
    return load_pipeline(net_config=NET, vae_config=TINY, num_steps=2, dtype=torch.float32,
                         device="cpu")


def _mesh_case(mesh, inputs):
    """Attention and DiT forward on this rank's rows and tokens; returns the
    gathered global results."""
    def local(x):
        return token_slice(batch_slice(torch.from_numpy(x), mesh), mesh)

    def whole(x, rows):
        return gather_batch(gather_tokens(x, mesh), mesh, rows).numpy()

    q, k, v = (local(x) for x in inputs["qkv"])
    rows = inputs["qkv"][0].shape[0]
    routes = {"ring_xla": make_ring_attention(mesh, impl="xla"),
              "ring_flash": make_ring_attention(mesh, impl="flash"),
              "sp_flash": make_sp_attention(mesh, impl="flash"),
              "sp_ring": make_sp_attention(mesh, impl="ring")}
    with torch.no_grad():
        out = {name: whole(fn(q, k, v), rows) for name, fn in routes.items()}
    # The gradients of sum(out * w) with respect to this rank's q, k, v
    # shards, gathered whole.
    w = local(inputs["w"])
    for name in ("ring_xla", "ring_flash", "sp_ring"):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (routes[name](*ts) * w).sum().backward()
        out[f"grad_{name}"] = [whole(t.grad, rows) for t in ts]
    d = inputs["dit"]
    params = dit_params_from_numpy(d["params"], SHARD_CFG, device="cpu")
    x, cond, sigma, ctx = (batch_slice(torch.from_numpy(d[n]), mesh)
                           for n in ("x", "cond", "sigma", "ctx"))
    for backend in ("ring", "flash_sp", "auto"):
        y = dit_forward(params, x, sigma, cond, ctx, SHARD_CFG, attn_backend=backend, mesh=mesh)
        out[f"dit_{backend}"] = gather_batch(y, mesh, d["x"].shape[0]).numpy()
    return out


def run(rank: int, world: int, port: int, case: str, workdir: str, data: int, seq: int) -> None:
    initialize_distributed("cpu", init_method=f"tcp://localhost:{port}", world_size=world,
                           rank=rank)
    try:
        mesh = make_mesh(world, data=data, seq=seq, tensor=1)
        if case == "mesh":
            with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
                out = _mesh_case(mesh, pickle.load(f))
        elif case == "generate":
            pipe = tiny_pipeline().shard(mesh, sp_attn="ring")
            video = np.random.default_rng(2).uniform(-1, 1, (2, 1, 32, 48, 3)).astype(np.float32)
            out = {"video": pipe.generate({"rgb": video, "context_index": np.array([0, 3])},
                                          seed=5)}
        elif case == "inverse":
            pipe = tiny_pipeline().shard(mesh)
            img = np.random.default_rng(9).uniform(size=(1, 32, 48, 3)).astype(np.float32)
            out = inverse_render(pipe, img, batch_passes=True)
        else:
            raise ValueError(case)
        if rank == 0:
            with open(os.path.join(workdir, f"{case}.out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
