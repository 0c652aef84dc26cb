"""The DiT's fused norm chains (ops/dit_fused.py) on the CPU: the rule that
routes a call to the kernels or to the plain chain, the plain chains
against the op-by-op code they replace, and the launches a DiT forward
makes, with the kernels' wrappers standing in as their plain versions
(kernel against plain on the card: tests/test_torch_cuda.py)."""

import pytest
import torch

from diffusionrenderer_tpu_torch import pipeline as tpipe
from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
from diffusionrenderer_tpu_torch.ops import dit_fused as tdf
from diffusionrenderer_tpu_torch.ops.norms import layer_norm_no_affine, modulate, rms_norm
from diffusionrenderer_tpu_torch.ops.rope import apply_rope, rope_3d_angles

NET = DiTConfig(model_channels=256, num_blocks=2, num_heads=2, adaln_lora_dim=8,
                crossattn_emb_channels=16)


@pytest.fixture
def stand_in(monkeypatch):
    """The rule pointed at the CPU, each kernel wrapper replaced by its plain
    version counted as a launch: the calls each kernel would get."""
    monkeypatch.setattr(tdf, "KERNEL_DEVICE", "cpu")

    def counted(name, plain):
        def launch(*args):
            tdf.LAUNCHES[name] += 1
            return plain(*args)
        return launch

    monkeypatch.setattr(tdf, "residual_ln_modulate_kernel",
                        counted("residual_ln_modulate", tdf.residual_ln_modulate_plain))
    monkeypatch.setattr(tdf, "qk_rmsnorm_rope_kernel",
                        counted("qk_rmsnorm_rope", tdf.qk_rmsnorm_rope_plain))
    tdf.reset_counts()
    yield tdf.LAUNCHES
    tdf.reset_counts()


def chain_inputs(b=2, l=5, d=64, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    return r(b, l, d), [(r(b, l, d), r(b, d)), (r(b, 1, d), r(b, d))], r(b, d), r(b, d)


def qk_inputs(b=2, l=6, h=3, dh=128, dtype=torch.bfloat16, seed=1):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    angles = rope_3d_angles(1, 2, l // 2, dh)
    return r(b, l, h, dh), r(b, l, h, dh), r(dh), r(dh), torch.cos(angles), torch.sin(angles)


def test_the_launch_counter_is_a_pipeline_counter():
    assert any(c is tdf.LAUNCHES for c in tpipe._LAUNCH_COUNTERS)
    assert set(tdf.LAUNCHES) == {"residual_ln_modulate", "qk_rmsnorm_rope"}


def test_plain_chains_are_the_op_by_op_chains():
    """The plain versions apply the pending residuals in order, a (B, 1, D)
    one broadcast over L, then LayerNorm and modulate; q and k each through
    rms_norm and apply_rope: bitwise the code the DiT ran before."""
    x, pending, shift, scale = chain_inputs()
    want = x
    for o, gate in pending:
        want = want + gate[:, None, :] * o
    got_x, got_xm = tdf.residual_ln_modulate_plain(x, pending, shift, scale)
    assert torch.equal(got_x, want)
    assert torch.equal(got_xm, modulate(layer_norm_no_affine(want), shift, scale))
    assert tdf.residual_ln_modulate_plain(x, pending[:1], None, None)[1] is None
    q, k, wq, wk, cos, sin = qk_inputs()
    got_q, got_k = tdf.qk_rmsnorm_rope_plain(q, k, wq, wk, cos, sin)
    assert torch.equal(got_q, apply_rope(rms_norm(q, wq), cos, sin))
    assert torch.equal(got_k, apply_rope(rms_norm(k, wk), cos, sin))


def _route_chain(case):
    """residual_ln_modulate's route on one case: the launches it made."""
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    x, pending, shift, scale = chain_inputs(d=60 if case == "d_not_multiple_of_8" else 64,
                                            dtype=dtype)
    if case == "autograd":
        pending[0][1].requires_grad_()
    with torch.enable_grad():
        got = tdf.residual_ln_modulate(x, pending, shift, scale)
    want = tdf.residual_ln_modulate_plain(x, pending, shift, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return tdf.LAUNCHES["residual_ln_modulate"]


def _route_qk(case):
    """Whether kernel 2 takes the case (models/dit.py asks before it launches)."""
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, wq, wk, _, _ = qk_inputs(dh=64 if case == "head_dim_64" else 128, dtype=dtype)
    if case == "autograd":
        wq.requires_grad_()
    with torch.enable_grad():
        return int(tdf.takes_qk_kernel(q, k, wq, wk))


@pytest.mark.parametrize("case", ["autograd", "fp32", "d_not_multiple_of_8", "head_dim_64"])
def test_route_takes_the_plain_chain(stand_in, case):
    """Under autograd (an input requiring grad, grad enabled), in fp32, at a
    width the kernel does not take: the plain chain, no launch."""
    if case != "head_dim_64":
        assert _route_chain(case) == 0
    if case != "d_not_multiple_of_8":
        assert _route_qk(case) == 0


def test_route_takes_the_plain_chain_on_the_cpu():
    """The rule as it stands: a CPU tensor never reaches a kernel wrapper."""
    tdf.reset_counts()
    assert _route_chain("bf16") == 0 and _route_qk("bf16") == 0


def test_route_takes_the_kernels_where_they_apply(stand_in):
    """bf16 on the kernels' device with nothing recorded: the kernels, also
    with an input that requires grad while grad is off."""
    assert _route_chain("bf16") == 1 and _route_qk("bf16") == 1
    x, pending, shift, scale = chain_inputs()
    pending[0][1].requires_grad_()
    q, k, wq, wk, _, _ = qk_inputs()
    wq.requires_grad_()
    with torch.no_grad():
        tdf.residual_ln_modulate(x, pending, shift, scale)
        assert tdf.takes_qk_kernel(q, k, wq, wk)
    assert tdf.LAUNCHES["residual_ln_modulate"] == 2
    assert not tdf.takes_qk_kernel(q, k, wq, wk.float())  # the weights of two dtypes


def _forward(params, crossattn_emb=None, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 1, 8, 8, NET.in_channels, generator=g).bfloat16()
    cond = torch.randn(2, 1, 8, 8, NET.additional_concat_ch, generator=g).bfloat16()
    return dit_forward(params, x, torch.tensor([3.0, 0.5]), cond, torch.tensor([0, 1]), NET,
                       crossattn_emb=crossattn_emb)


@pytest.mark.parametrize("m", [1, 3], ids=["one_token_context", "crossattn_emb_3"])
def test_dit_forward_launches(stand_in, m):
    """Per forward: the FA norm, the FA (and one-token CA) residuals with the
    MLP norm, the MLP residual, one more per block for the general
    cross-attention's norm, and the final layer's norm; one q / k launch a
    block.  The result is the plain forward's, bit for bit."""
    params = init_dit_params(NET, device="cpu", dtype=torch.bfloat16, seed=0)
    emb = None if m == 1 else torch.randn(2, m, NET.crossattn_emb_channels,
                                          generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = _forward(params, emb)
    assert tdf.LAUNCHES == {"residual_ln_modulate": (3 if m == 1 else 4) * NET.num_blocks + 1,
                            "qk_rmsnorm_rope": NET.num_blocks}
    stand_in_counts = dict(tdf.LAUNCHES)
    tdf.KERNEL_DEVICE = "cuda"
    with torch.no_grad():
        want = _forward(params, emb)
    assert tdf.LAUNCHES == stand_in_counts
    assert torch.equal(got, want)


def test_dit_forward_under_autograd_launches_nothing(stand_in):
    """The trainer's forward: parameters that require grad keep every chain
    plain."""
    params = init_dit_params(NET, device="cpu", dtype=torch.bfloat16, seed=0)
    for p in [p for bp in params["blocks"] for sp in bp.values() for p in sp.values()]:
        p.requires_grad_()
    with torch.enable_grad():
        out = _forward(params)
    assert out.requires_grad
    assert tdf.LAUNCHES == {"residual_ln_modulate": 0, "qk_rmsnorm_rope": 0}
