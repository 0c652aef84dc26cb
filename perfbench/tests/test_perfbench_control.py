"""On the card: each cell's control, run through `run.measure` in the
program's place at the cell's own size, comes out not `correct` on three
seeds.  The renders' control is the program's own W8A8 path (int8 weights
and per-token int8 activations, the step below the configuration's bf16);
the train step's is the plain reference with fp8 (e4m3) matmul operands,
whose run also reads the sound program, which has to stay under every
limit.  About three minutes for the inverse cell, two for the forward
one, four for the train step.  Run:

    python3 -m pytest --noconftest -p no:cacheprovider perfbench/tests/test_perfbench_control.py
"""

import json

import pytest
from tiny import ROOT

SEEDS = (7000000001, 7000000002, 7000000003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", (("inverse_512_5pass", "w8a8"),
                                          ("forward_512_relight", "w8a8"),
                                          ("train_512_b1", "fp8")))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, cell, control, seed):
    from perfbench import calibrate

    limits = json.loads((ROOT / "perfbench" / "limits" / f"{cell}.json").read_text())
    ok, readings = calibrate.run_once(cell, seed, 8.0, control)
    assert ok is False, readings[control]
    assert any(readings[control][name] > limit for name, limit in limits.items())
    if "sound" in readings:
        for name, limit in limits.items():
            assert readings["sound"][name] <= limit, (name, readings["sound"])
