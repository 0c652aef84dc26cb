"""A whole run on the CPU at a tiny size, past the harness's look for a
card: the sound program is correct, and `correct` comes out false with the
timed path broken underneath, once for each fault a render cell can have.
The float32 program matches the reference's uint8 outputs exactly here, so
the cells' own limits apply."""

import pytest
import torch
from tiny import run_cell

CELLS = ("inverse_512_5pass", "forward_512_relight")
TRAIN = "train_512_b1"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS + (TRAIN,))
def test_sound_run_is_correct(cell):
    code, res = run_cell(cell)
    assert code == 0 and res["correct"], res
    assert res["attempted"] == 3 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"setup_s", "train_step_s" if cell == TRAIN else "frames_per_s"} <= set(res["metrics"])


@pytest.mark.parametrize("cell", CELLS + (TRAIN,))
def test_traced_run_reads_its_layers(cell):
    code, res = run_cell(cell, trace=1)
    assert code == 0 and res["correct"], res
    names = (("mfu.train",) if cell == TRAIN else
             ("api_host_ms", "vae_encode_ms", "vae_decode_ms", "dit_step_ms", "mfu.render"))
    for name in names:
        assert name in res["metrics"], name
    assert res["device"]["window_s"] > 0


def test_a_listed_metric_that_reads_nothing_fails_the_run(capsys):
    """On the CPU the device trace holds no kernel: the metrics read from it
    find nothing, and the run exits non-zero with no result."""
    code, res = run_cell("inverse_512_5pass", trace=1, allow_missing=("peak_reserved_gib",))
    assert code != 0 and res is None
    assert "attention_roofline" in capsys.readouterr().err


def _state_unchanged(monkeypatch):
    from diffusionrenderer_tpu_torch.sampling import edm

    monkeypatch.setattr(edm, "edm_step", lambda out, s, s_next, sample, sd=0.5: sample)


def _half_batch(monkeypatch):
    """The denoiser computes the first half of the rows; the rest get their
    mean."""
    from diffusionrenderer_tpu_torch import pipeline

    real = pipeline.dit_forward

    def half(params, x, sigma, cond, ctx, cfg, **kw):
        k = max(1, x.shape[0] // 2)
        out = real(params, x[:k], sigma[:k], cond[:k], None if ctx is None else ctx[:k], cfg,
                   **kw)
        rest = out.mean(dim=0, keepdim=True).expand(x.shape[0] - k, *out.shape[1:])
        return torch.cat([out, rest], dim=0)

    monkeypatch.setattr(pipeline, "dit_forward", half)


def _answer_altered(monkeypatch):
    """Where the job's uint8 video becomes floats, its first frame comes out
    mirrored."""
    from diffusionrenderer_tpu_torch import api

    real = api.u8_to_unit_float

    def altered(u8):
        out = real(u8).copy()
        out[0] = out[0][..., ::-1, :]
        return out

    monkeypatch.setattr(api, "u8_to_unit_float", altered)


def _train_state_unchanged(monkeypatch):
    """The optimizer's update returns the parameters and moments as they
    were."""
    from diffusionrenderer_tpu_torch.training import train

    monkeypatch.setattr(train.AdamW, "update",
                        lambda self, grads, state, params, steps=None: (
                            params, train.AdamState(state.count + 1, state.mu, state.nu)))


def _fp8_after_the_first_step(monkeypatch):
    """From the train step's second call on, the calls that on the card
    replay its captured graph, every matmul takes operands rounded to fp8
    (e5m2, per-tensor scale); the first call, the eager one, is sound."""
    import torch.nn.functional as F
    from diffusionrenderer_tpu_torch.training import train

    def fp8(t):
        scale = 57344.0 / t.detach().abs().amax().clamp_min(1e-30)
        return t + ((t.detach() * scale).to(torch.float8_e5m2).float() / scale
                    - t).detach().to(t.dtype)

    real_accumulate, real_linear = train._TrainStep._accumulate, F.linear
    calls = []

    def accumulate(self, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            return real_accumulate(self, *a, **k)
        with monkeypatch.context() as m:
            m.setattr(F, "linear", lambda x, w, b=None: real_linear(fp8(x), fp8(w), b))
            return real_accumulate(self, *a, **k)

    monkeypatch.setattr(train._TrainStep, "_accumulate", accumulate)


FAULTS = [("inverse_512_5pass", _state_unchanged), ("forward_512_relight", _state_unchanged),
          (TRAIN, _train_state_unchanged),
          ("inverse_512_5pass", _half_batch),
          ("inverse_512_5pass", _answer_altered), ("forward_512_relight", _answer_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    code, res = run_cell(cell)
    assert code == 0
    assert res["correct"] is False, res["checks"]


def test_a_fault_of_the_replayed_steps_alone_is_seen_by_their_gradient(monkeypatch):
    """Lower precision in the steps after the first (on the card, the
    replayed graph's) leaves step 1's gradient as it was, and step 2's
    gradient, read from the moments, catches it."""
    _fp8_after_the_first_step(monkeypatch)
    code, res = run_cell(TRAIN)
    assert code == 0 and res["correct"] is False
    checks = res["checks"]
    assert checks["grad_norm_gap"]["value"] <= checks["grad_norm_gap"]["limit"]
    assert checks["grad2_norm_gap"]["value"] > checks["grad2_norm_gap"]["limit"], checks


def test_the_train_control_in_the_programs_place_is_not_correct():
    """The fp8 reference, put in the program's place as calibrate.py and
    the card's control test put it, fails the cell's limits."""
    code, res = run_cell(TRAIN, control="fp8")
    assert code == 0 and res["correct"] is False, res["checks"]
