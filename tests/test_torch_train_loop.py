"""The port's durable train loop (training/loop.py) on the CPU, at the tiny
config of tests/test_train_loop.py, the same cases: a preempted and resumed
run equals the uninterrupted one bit for bit (parameters, both moments, the
count, the losses), a finished run re-run is a no-op, a run without a
checkpoint directory; plus max_to_keep, a save cut off before its rename,
and the step generators."""

import os

import numpy as np
import pytest
import torch

from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import init_dit_params
from diffusionrenderer_tpu_torch.training import (init_train_state, make_optimizer,
                                                  make_train_step, train_loop)
from diffusionrenderer_tpu_torch.training.loop import (restore_train_state, save_train_state,
                                                       saved_steps, step_generator)
from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

CFG = DiTConfig(model_channels=64, num_blocks=2, num_heads=4, adaln_lora_dim=8,
                crossattn_emb_channels=16, additional_concat_ch=16)


def make_state():
    params = init_dit_params(CFG, device="cpu", dtype=torch.float32, seed=0)
    return init_train_state(params, make_optimizer(1e-3))


def batch_fn(step: int, context_index=(0, 3)):
    # A pure function of the step number: resume must re-derive the batch.
    rng = np.random.default_rng(1000 + step)
    b, t, h, w = len(context_index), 2, 8, 8
    return {"latents": torch.from_numpy(rng.standard_normal((b, t, h, w, 16), np.float32)),
            "latent_condition": torch.from_numpy(
                rng.standard_normal((b, t, h, w, 16), np.float32)),
            "context_index": torch.tensor(context_index)}


@pytest.fixture(scope="module")
def train_step():
    return make_train_step(CFG, make_optimizer(1e-3), condition_drop_rate=0.5, donate=True)


def state_leaves(state):
    return tree_leaves(state.params) + tree_leaves(state.opt_state.mu) + tree_leaves(
        state.opt_state.nu)


def assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in zip(state_leaves(a), state_leaves(b), strict=True):
        assert torch.equal(x, y)


def run(train_step, path, num_steps, seed=7, batches=batch_fn, **kw):
    return train_loop(make_state, train_step, batches, num_steps=num_steps, seed=seed,
                      ckpt_dir=None if path is None else str(path), log_every=0,
                      device="cpu", **kw)


# The second case: two microbatches, each repeating its context index.
@pytest.mark.parametrize("grad_accum,context_index", [(1, (0, 3)), (2, (3, 3, 1, 1))],
                         ids=["b2_accum1", "b4_accum2_repeated_index"])
def test_resume_is_bit_exact(tmp_path, train_step, grad_accum, context_index):
    if grad_accum > 1:
        train_step = make_train_step(CFG, make_optimizer(1e-3), condition_drop_rate=0.5,
                                     grad_accum=grad_accum)

    def batches(step):
        return batch_fn(step, context_index)

    s_full, losses_full = run(train_step, tmp_path / "full", 6, save_every=2, batches=batches)
    # Preempted run: killed after step 3 (checkpoints at 2 and 3).
    s_head, losses_head = run(train_step, tmp_path / "pre", 3, save_every=2, batches=batches)
    assert saved_steps(str(tmp_path / "pre")) == [2, 3]
    # Restart the same command: resumes from step 3, runs only 3..6.
    s_resumed, losses_tail = run(train_step, tmp_path / "pre", 6, save_every=2,
                                 batches=batches)
    assert len(losses_head) == 3 and len(losses_tail) == 3
    assert losses_head + losses_tail == losses_full
    assert s_resumed.step == s_full.step == 6
    assert_states_equal(s_resumed, s_full)


def test_resume_skips_completed_work(tmp_path, train_step):
    run(train_step, tmp_path, 4, seed=0, save_every=100)  # only the final step is saved
    assert saved_steps(str(tmp_path)) == [4]
    state, losses = run(train_step, tmp_path, 4, seed=0, save_every=100)
    assert losses == [] and state.step == 4


def test_max_to_keep_and_a_save_cut_off(tmp_path, train_step):
    run(train_step, tmp_path, 5, save_every=1, max_to_keep=2)
    assert saved_steps(str(tmp_path)) == [4, 5]
    # A save killed before its rename leaves a temporary directory: ignored,
    # the latest complete step is restored.
    os.makedirs(tmp_path / ".tmp-6")
    with open(tmp_path / ".tmp-6" / "state.safetensors", "wb") as f:
        f.write(b"\x00" * 10)
    want = restore_train_state(str(tmp_path / "5"), "cpu")
    state, losses = run(train_step, tmp_path, 5, save_every=1, max_to_keep=2)
    assert losses == []
    assert_states_equal(state, want)


def test_save_restore_round_trip(tmp_path, train_step):
    state, _ = run(train_step, None, 2, seed=1)
    path = save_train_state(str(tmp_path), state)
    assert os.path.basename(path) == "2"
    back = restore_train_state(path, "cpu")
    assert_states_equal(back, state)
    assert isinstance(back.params["blocks"], list) and len(back.params["blocks"]) == 2


def test_no_ckpt_dir_runs_plain(train_step):
    state, losses = run(train_step, None, 2, seed=3)
    assert len(losses) == 2 and state.step == 2
    assert all(np.isfinite(x) for x in losses)


def test_step_generators_depend_on_seed_and_step_alone():
    def draw(seed, step):
        return torch.randn(4, generator=step_generator(seed, step, "cpu"))

    assert torch.equal(draw(7, 3), draw(7, 3))
    assert not torch.equal(draw(7, 3), draw(7, 4))
    assert not torch.equal(draw(7, 3), draw(8, 3))
