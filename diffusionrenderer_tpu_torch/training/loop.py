"""Durable training loop: periodic atomic checkpoints and bit-exact
auto-resume (counterpart of diffusionrenderer_tpu/training/loop.py).

* **Periodic atomic saves.**  Every `save_every` steps (and at the final
  step) the whole TrainState - parameters, both AdamW moments, the update
  count and the step - is written as one safetensors file in checkpoint's
  flat format ('/'-joined keys params/..., mu/..., nu/...; the count, the
  step and the key order go in its metadata) into a temporary directory,
  fsynced, and `os.replace`d to `ckpt_dir/<step>`.  A kill mid-save leaves the latest
  complete step as it was.  Only the newest `max_to_keep` steps are kept.
  (JAX writes orbax directories, which do not exist for PyTorch.)
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


def save_train_state(ckpt_dir: str, state: TrainState) -> str:
    """Write `state` atomically to ckpt_dir/<step> and return that path."""
    step = int(state.step)
    opt: AdamState = state.opt_state
    tensors = flatten({"params": state.params, "mu": opt.mu, "nu": opt.nu})
    # The file sorts its entries: the key list keeps the leaves' order.
    meta = {"step": str(step), "count": str(int(opt.count)), "keys": json.dumps(list(tensors))}
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    path = os.path.join(tmp, STATE_FILE)
    write_safetensors(path, tensors, metadata=meta)
    _fsync(path)
    _fsync(tmp)
    final = os.path.join(ckpt_dir, str(step))
    if os.path.exists(final):  # an older save of this step: the new one is complete
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync(ckpt_dir)
    return final


def restore_train_state(path: str, device: DeviceLike = None) -> TrainState:
    """The TrainState saved in the step directory `path`, on `device`."""
    with SafetensorsFile(os.path.join(path, STATE_FILE), resolve_device(device)) as f:
        meta = f.metadata
        tree = _unflatten({k: f[k] for k in json.loads(meta["keys"])})
    return TrainState(tree["params"], AdamState(int(meta["count"]), tree["mu"], tree["nu"]),
                      int(meta["step"]))


def saved_steps(ckpt_dir: str) -> List[int]:
    """The complete steps under ckpt_dir, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isfile(os.path.join(ckpt_dir, n, STATE_FILE)))


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
    Returns the final state and the losses of the steps THIS call ran."""
    device = resolve_device(device)
    start_step, state = 0, None
    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
        steps = saved_steps(ckpt_dir)
        if steps:
            state = restore_train_state(os.path.join(ckpt_dir, str(steps[-1])), device)
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
            save_train_state(ckpt_dir, state)
            for old in saved_steps(ckpt_dir)[:-max_to_keep]:
                shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return state, (torch.stack(losses).tolist() if losses else [])
