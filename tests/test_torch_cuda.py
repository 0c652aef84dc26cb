"""The port on the card: the CUDA kernels against their plain version.

Imports neither JAX nor the JAX package, so that it runs on a machine with
a card and no JAX (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test is marked `cuda` and skips without a CUDA device.  Tolerances:
the kernels compute in bf16 with fp32 softmax state and round where the
plain version rounds, so outputs differ by about one bf16 ulp on a few
elements: max |err| within 2e-2 of max |plain| (no floor) and a relative L2
error within 1e-2."""

import math

import pytest
import torch

from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda

CASES = [(5, 1024, 1024, 32, 128), (1, 300, 300, 2, 128), (2, 1000, 777, 4, 128),
         (1, 4096, 4096, 1, 512), (2, 300, 200, 1, 512), (1, 256, 256, 2, 64),
         (1, 256, 320, 2, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def qkv(device, b, lq, lk, h, d, q_scale=1.0, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    mk = lambda l: torch.randn(b, l, h, d, generator=g, device=device)  # noqa: E731
    return (mk(lq) * q_scale).bfloat16(), mk(lk).bfloat16(), mk(lk).bfloat16()


def assert_close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    assert math.isfinite(err) and err <= 2e-2 * want.abs().max().item(), err
    assert math.isfinite(rel) and rel <= 1e-2, rel


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
@pytest.mark.parametrize("q_scale,branch", [(1.0, "noshift"), (100.0, "online")])
def test_kernel_matches_plain(cuda, b, lq, lk, h, d, q_scale, branch):
    q, k, v = qkv(cuda, b, lq, lk, h, d, q_scale)
    tfa.reset_counts()
    got = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_headroom": 1}
    assert tfa.branch_counts(cuda)[branch] == 1
    assert_close(got, want)


def test_onlinemax_forced(cuda):
    q, k, v = qkv(cuda, 1, 512, 512, 2, 128)
    tfa.reset_counts()
    got = tfa.flash_attention(q, k, v, bounded=False)
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_headroom": 0}
    assert tfa.branch_counts(cuda) == {"noshift": 0, "online": 1}
    assert_close(got, tfa.flash_attention_plain(q, k, v, bounded=False))


def test_headroom_stats_match_plain(cuda):
    q, k, v = qkv(cuda, 2, 700, 500, 3, 128, q_scale=3.0)
    stats = tfa.flash_headroom(q, k, v)
    torch.testing.assert_close(stats, tfa.headroom_stats_plain(q, k, v), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = qkv(cuda, 1, 64, 64, 2, 128)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                            v[..., :96].contiguous())
    with pytest.raises(ValueError):
        tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def test_dit_forward_kernel_vs_plain_attention(cuda):
    """A 2-block DiT at full head width, bf16: flash kernel vs plain path."""
    cfg = DiTConfig(model_channels=1024, num_blocks=2, num_heads=8)
    params = init_dit_params(cfg, device=cuda, dtype=torch.bfloat16, seed=0)
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(2, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
    cond = torch.randn(2, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
    sig = torch.tensor([3.0, 0.5], device=cuda)
    ctx = torch.tensor([0, 3], device=cuda)
    tfa.reset_counts()
    got = dit_forward(params, x, sig, cond, ctx, cfg, attn_backend="auto")
    assert tfa.LAUNCHES["flash_attention"] == cfg.num_blocks
    want = dit_forward(params, x, sig, cond, ctx, cfg, attn_backend="xla")
    assert_close(got, want)
