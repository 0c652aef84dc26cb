"""Durable training loop: periodic atomic checkpoints and bit-exact
auto-resume (counterpart of diffusionrenderer_tpu/training/loop.py).

* **Periodic atomic saves.**  Every `save_every` steps (and at the final
  step) the whole TrainState - parameters, both AdamW moments, the update
  count and the step - is written as one safetensors file in checkpoint's
  flat format ('/'-joined keys params/..., mu/..., nu/...; the count, the
  step and the key order go in its metadata) into a temporary directory,
  fsynced, and `os.replace`d to `ckpt_dir/<step>`.  A kill mid-save leaves the latest
  complete step as it was.  Only the newest `max_to_keep` steps are kept.
  (JAX writes orbax directories, which do not exist for PyTorch.)  Under a
  mesh each rank writes its own shard as its own file in the step's
  directory, renamed into place once complete; a step counts once every
  rank's file is there, and each rank restores its own.
* **Auto-resume.**  On start, if `ckpt_dir` holds a step, the loop restores
  the latest one onto `device` from the file alone, and `make_state` is not
  called.
* **History-independent randomness.**  Step s draws from a torch.Generator
  on `device` seeded from (seed, s) alone (`step_generator`), and its batch
  is `batch_fn(s)`: a resumed run replays the exact tail an uninterrupted
  one would have run, bit for bit on one machine.

Losses stay on the device: the host waits only at log and save steps, and
once at the end.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import _unflatten
from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import logger
from ..utils.safetensors import SafetensorsFile, write_safetensors
from ..utils.tree import flatten
from .train import AdamState, TrainState

STATE_FILE = "state.safetensors"


def step_generator(seed: int, step: int, device: DeviceLike = None) -> torch.Generator:
    """The generator of step `step`: seeded from (seed, step) alone."""
    words = np.random.SeedSequence([seed & (2 ** 64 - 1), step]).generate_state(2, np.uint32)
    return torch.Generator(device=resolve_device(device)).manual_seed(
        (int(words[0]) << 31) ^ int(words[1]))


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def state_file(shard: Optional[Tuple[int, int]] = None) -> str:
    """The file name of a state, or of rank r's shard of it (shard=(r, world))."""
    return STATE_FILE if shard is None else f"state-{shard[0]}-of-{shard[1]}.safetensors"


def _write_state(path: str, state: TrainState) -> None:
    opt: AdamState = state.opt_state
    flat = flatten({"params": state.params, "mu": opt.mu, "nu": opt.nu})
    # The file sorts its entries: the key list keeps the leaves' order.  A
    # None leaf is a block another pipeline stage holds.
    meta = {"step": str(int(state.step)), "count": str(int(opt.count)),
            "keys": json.dumps(list(flat)),
            "none": json.dumps([k for k, v in flat.items() if v is None])}
    write_safetensors(path, {k: v for k, v in flat.items() if v is not None}, metadata=meta)
    _fsync(path)


def save_train_state(ckpt_dir: str, state: TrainState,
                     shard: Optional[Tuple[int, int]] = None) -> str:
    """Write `state` atomically to ckpt_dir/<step> and return that path.
    shard=(rank, world): this rank's shard, as its own file in the step's
    directory, renamed into place once complete (the step is complete when
    every rank's file is there)."""
    step = int(state.step)
    final = os.path.join(ckpt_dir, str(step))
    if shard is not None:
        os.makedirs(final, exist_ok=True)
        tmp = os.path.join(final, f".{state_file(shard)}.tmp")
        _write_state(tmp, state)
        os.replace(tmp, os.path.join(final, state_file(shard)))
        _fsync(final)
        _fsync(ckpt_dir)
        return final
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    _write_state(os.path.join(tmp, STATE_FILE), state)
    _fsync(tmp)
    if os.path.exists(final):  # an older save of this step: the new one is complete
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync(ckpt_dir)
    return final


def restore_train_state(path: str, device: DeviceLike = None,
                        shard: Optional[Tuple[int, int]] = None) -> TrainState:
    """The TrainState (or this rank's shard of it) saved in the step
    directory `path`, on `device`."""
    with SafetensorsFile(os.path.join(path, state_file(shard)), resolve_device(device)) as f:
        meta = f.metadata
        none = set(json.loads(meta.get("none", "[]")))
        tree = _unflatten({k: None if k in none else f[k] for k in json.loads(meta["keys"])})
    return TrainState(tree["params"], AdamState(int(meta["count"]), tree["mu"], tree["nu"]),
                      int(meta["step"]))


def saved_steps(ckpt_dir: str, world: Optional[int] = None) -> List[int]:
    """The complete steps under ckpt_dir, oldest first (with world, those
    holding all `world` ranks' shards)."""
    if not os.path.isdir(ckpt_dir):
        return []
    files = [STATE_FILE] if world is None else [state_file((r, world)) for r in range(world)]
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and all(os.path.isfile(os.path.join(ckpt_dir, n, f))
                                         for f in files))


def train_loop(
    make_state: Callable[[], TrainState],
    train_step: Callable[..., Tuple[TrainState, torch.Tensor]],
    batch_fn: Callable[[int], Dict[str, Any]],
    *,
    num_steps: int,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    save_every: int = 100,
    max_to_keep: int = 3,
    log_every: int = 50,
    device: DeviceLike = None,
    mesh=None,
) -> Tuple[TrainState, List[float]]:
    """Run (or resume) `train_step` for steps [resume_step, num_steps).

    make_state: fresh-init factory, called on a cold start only.
    train_step: (state, batch, generator) -> (state, loss), e.g.
        make_train_step's step (donation is fine: the loop saves at step
        boundaries).
    batch_fn: step -> batch dict; it MUST be a pure function of the step
        number for resume to be exact.
    device: where the step generators live and a resumed state is loaded
        (CUDA unless the caller asks for the CPU).
    mesh: a parallel mesh (make_mesh, make_pp_mesh) whose ranks all run the
        loop: each saves and restores its own shard of the state (every
        rank's state, also where data replicates it), and a step is
        complete once every rank's shard is written.
    Returns the final state and the losses of the steps THIS call ran."""
    device = resolve_device(device)
    shard = None if mesh is None else (dist.get_rank(), dist.get_world_size())
    world = None if shard is None else shard[1]
    start_step, state = 0, None
    if ckpt_dir is not None:
        if shard is None or shard[0] == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
        if shard is not None:
            dist.barrier()
        steps = saved_steps(ckpt_dir, world)
        if shard is not None:  # every rank has listed before any rank saves
            dist.barrier()
        if steps:
            state = restore_train_state(os.path.join(ckpt_dir, str(steps[-1])), device, shard)
            start_step = steps[-1]
            logger.info("train_loop: resumed step %d from %s", start_step, ckpt_dir)
    if state is None:
        state = make_state()

    losses: List[torch.Tensor] = []
    for step in range(start_step, num_steps):
        state, loss = train_step(state, batch_fn(step), step_generator(seed, step, device))
        losses.append(loss)
        done = step + 1
        if log_every and done % log_every == 0:
            logger.info("train_loop: step %d loss %.6f", done, float(loss))
        if ckpt_dir is not None and (done % save_every == 0 or done == num_steps):
            save_train_state(ckpt_dir, state, shard)
            if shard is not None:  # every shard of this step is written
                dist.barrier()
            if shard is None or shard[0] == 0:
                for old in saved_steps(ckpt_dir, world)[:-max_to_keep]:
                    shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return state, (torch.stack(losses).tolist() if losses else [])
