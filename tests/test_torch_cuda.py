"""The port on the card: the CUDA kernels against their plain versions.

Imports neither JAX nor the JAX package, so that it runs on a machine with
a card and no JAX (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test is marked `cuda` and skips without a CUDA device.  Tolerances:
the attention kernels compute in bf16 with fp32 softmax state and round
where the plain version rounds (kernels 1, 2, 3, 6 and 7 at every head dim
on wgmma), so outputs differ by about one bf16 ulp on a few elements:
max |err| within 2e-2 of max |plain| (no floor) and a relative L2 error
within 1e-2; the
int8 attention kernel is held to its plain version at the kernel's own key
tile; the partial-stats kernel's m and l and the bounded kernels' outputs
to the same limits, and the partial-stats kernel's output, its keys not
split, bitwise to the unbounded call's at every head dim (one online
body); split at D = 256 and 512 (the halves merged with the online
rescale), out, m and l to the same limits.  Kernel 6 is held
bitwise to kernel 7 at every head dim: at D = 64 and 128 both are the
wgmma body, which sums l per thread in key order and issues PV in k16
order whatever the key tile (kernel 7 takes 128 keys a tile at D = 128,
kernel 6 64), and at 256 and 512 both are the one schedule of the wide
wgmma body, with the same key split for the same sizes.  A bounded bf16
call is one headroom launch and one
attention launch (kernels 1 and 2 in one grid) at every head dim, and every
public route takes a strided view.  The W8A8 matmul kernel is
bitwise equal to its plain version per channel (exact int32 core, the same
fp32 epilogue); grouped, within one bf16 ulp of max |plain| and a relative
L2 error of 1e-3.  The DiT's fused norm chains (csrc/dit_fused.cu) round
where their plain chains round: the residual stream bitwise, and every
output one of those its plain chain gives with the LayerNorm or RMSNorm
output rounded to nearest or to the neighbour toward the exact value (one
bf16 ulp there: the fp32 sums' order)."""

import math

import pytest
import torch

from diffusionrenderer_tpu_torch.config import DiTConfig
from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
from diffusionrenderer_tpu_torch.models.quant import quantize_dit_params, quantize_tensor
from diffusionrenderer_tpu_torch.ops import dit_fused as tdf
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.ops import quant_matmul as tqm
from diffusionrenderer_tpu_torch.ops.attention import attention, attention_xla

pytestmark = pytest.mark.cuda

CASES = [(5, 1024, 1024, 32, 128), (1, 300, 300, 2, 128), (2, 1000, 777, 4, 128),
         (1, 4096, 4096, 1, 512), (2, 300, 200, 1, 512), (1, 1000, 1200, 1, 512),
         (1, 256, 256, 2, 64), (1, 256, 320, 2, 256)]


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
    got = tfa.flash_attention(q, k, v, bounded=True)
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    # One attention launch holds both branches at every head dim.
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_headroom": 1,
                            "flash_attention_int8": 0}
    assert tfa.branch_counts(cuda) == {"noshift": int(branch == "noshift"),
                                       "online": int(branch == "online")}
    assert_close(got, want)


def test_onlinemax_forced(cuda):
    q, k, v = qkv(cuda, 1, 512, 512, 2, 128)
    tfa.reset_counts()
    got = tfa.flash_attention(q, k, v, bounded=False)
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_headroom": 0,
                            "flash_attention_int8": 0}
    assert tfa.branch_counts(cuda) == {"noshift": 0, "online": 1}
    assert_close(got, tfa.flash_attention_plain(q, k, v, bounded=False))


# The wgmma bodies of kernels 1, 2, 6 and 7: ragged lengths (Lk not a multiple of the key tile,
# Lq not of the 64-row block), keys fewer than one tile, and enough blocks for
# several waves of two blocks per SM on 132 SMs; at the wide heads (64- and
# 32-key tiles at D = 256, 512) ragged lengths whose few blocks split the keys
# of kernels 6 and 7 over 2-block clusters, and keys fewer than one tile,
# which do not.
WGMMA_CASES = [(2, 1000, 777, 4, 128), (2, 1000, 777, 4, 64), (1, 100, 40, 2, 128),
               (1, 70, 100, 2, 64), (4, 1024, 1024, 32, 128), (3, 777, 1000, 16, 64),
               (2, 1000, 777, 2, 256), (1, 100, 40, 2, 256), (1, 1000, 1200, 1, 512),
               (1, 70, 20, 1, 512)]


@pytest.mark.parametrize("b,lq,lk,h,d", WGMMA_CASES)
@pytest.mark.parametrize("q_scale", [1.0, 30.0])
def test_wgmma_online_kernel_matches_plain(cuda, b, lq, lk, h, d, q_scale):
    q, k, v = qkv(cuda, b, lq, lk, h, d, q_scale, seed=lq + lk + d)
    tfa.reset_counts()
    got = tfa.flash_attention(q, k, v, bounded=False)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_headroom": 0,
                            "flash_attention_int8": 0}
    assert tfa.branch_counts(cuda) == {"noshift": 0, "online": 1}
    assert_close(got, tfa.flash_attention_plain(q, k, v, bounded=False))


@pytest.mark.parametrize("b,lq,lk,h,d", WGMMA_CASES)
@pytest.mark.parametrize("q_scale,branch", [(1.0, "noshift"), (100.0, "online")])
def test_wgmma_bounded_call_is_one_launch(cuda, b, lq, lk, h, d, q_scale, branch):
    """Kernel 1 (unit-scale logits) or kernel 2 (the rule's online branch)
    from one attention launch after the headroom launch."""
    q, k, v = qkv(cuda, b, lq, lk, h, d, q_scale, seed=lq + lk + d + 1)
    tfa.reset_counts()
    got = tfa.flash_attention(q, k, v, bounded=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_headroom": 1,
                            "flash_attention_int8": 0}
    assert tfa.branch_counts(cuda) == {"noshift": int(branch == "noshift"),
                                       "online": int(branch == "online")}
    assert_close(got, tfa.flash_attention_plain(q, k, v, bounded=True))


@pytest.mark.parametrize("b,lq,lk,h,d", [(2, 1000, 777, 4, 64), (2, 1000, 777, 4, 128),
                                         (2, 1000, 777, 2, 256), (1, 1000, 1200, 1, 512)])
def test_bounded_call_takes_each_branch_through_its_kernel(cuda, b, lq, lk, h, d):
    """A bounded call is one attention launch at every head dim (the wide
    heads' body at D = 256, 512): with large logits its blocks take the
    online branch (kernel 2), with unit-RMS inputs the no-shift one (kernel
    1); the tally counts one branch a call."""
    for q_scale, branch in ((100.0, "online"), (1.0, "noshift")):
        q, k, v = qkv(cuda, b, lq, lk, h, d, q_scale, seed=d)
        tfa.reset_counts()
        got = tfa.flash_attention(q, k, v, bounded=True)
        torch.cuda.synchronize()
        assert tfa.LAUNCHES["flash_attention"] == 1
        assert tfa.branch_counts(cuda) == {"noshift": int(branch == "noshift"),
                                           "online": int(branch == "online")}
        assert_close(got, tfa.flash_attention_plain(q, k, v, bounded=True))
        if branch == "online":  # bitwise what the unbounded call computes
            assert torch.equal(got, tfa.flash_attention(q, k, v, bounded=False))


def test_kernel_occupancy(cuda):
    """No spills, and at least 8 warps per SM resident, for the wgmma kernels:
    the launch of kernels 1 and 2 and kernels 3, 6 and 7 at every head dim,
    kernel 5 (two warpgroups at D = 512), and kernel 4 per channel and
    grouped."""
    occs = {(kernel, d, pv8): tfa.kernel_occupancy(kernel, d, pv8)
            for kernel, d, pv8 in (("attention", 64, False), ("attention", 128, False),
                                   ("attention", 256, False), ("attention", 512, False),
                                   ("partial", 64, False), ("partial", 128, False),
                                   ("partial", 256, False), ("partial", 512, False),
                                   ("int8", 512, False), ("int8", 512, True),
                                   ("bounded_pipe", 64, False), ("bounded_pipe", 128, False),
                                   ("bounded", 64, False), ("bounded", 128, False),
                                   ("bounded_pipe", 256, False), ("bounded_pipe", 512, False),
                                   ("bounded", 256, False), ("bounded", 512, False),
                                   ("int8", 64, False), ("int8", 128, False),
                                   ("int8", 128, True), ("int8", 256, False),
                                   ("int8", 256, True))}
    for grouped in (False, True):
        occs[("w8a8", grouped)] = tqm.kernel_occupancy(grouped)
    for key, occ in occs.items():
        warps = occ["blocks_per_sm"] * occ["threads_per_block"] // 32
        assert occ["spill_bytes"] == 0 and warps >= 8, (key, occ)


def test_headroom_stats_match_plain(cuda):
    q, k, v = qkv(cuda, 2, 700, 500, 3, 128, q_scale=3.0)
    stats = tfa.flash_headroom(q, k, v)
    torch.testing.assert_close(stats, tfa.headroom_stats_plain(q, k, v), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """The public routes copy a strided view; the launch wrappers refuse one."""
    q, k, v = qkv(cuda, 1, 64, 64, 2, 128)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                            v[..., :96].contiguous())
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_kernel(*views, None)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_partial_kernel(*views)


# Each public route, on CUDA: (name, call).  Views are copied once to a
# contiguous, 16-byte-aligned tensor before the launch.
VIEW_ROUTES = {
    "bounded": lambda q, k, v: tfa.flash_attention(q, k, v, bounded=True),
    "online": lambda q, k, v: tfa.flash_attention(q, k, v),
    "bounded_pipelined": lambda q, k, v: tfa.flash_attention(q, k, v, bounded=True, pipelined=True),
    "bounded_shift": tfa.flash_attention_bounded_shift,
    "qk_int8": lambda q, k, v: tfa.flash_attention(q, k, v, qk_int8=True),
    "pv_int8": lambda q, k, v: tfa.flash_attention(q, k, v, pv_int8=True),
    "partial": tfa.flash_attention_partial,
    "int8_operands": lambda q, k, v: tfa.flash_attention_int8_launch(tfa.int8_operands(q, k, v)),
    "attention_pallas": lambda q, k, v: attention(q, k, v, backend="pallas"),
    "attention_auto": lambda q, k, v: attention(q, k, v),
}


@pytest.mark.parametrize("d", [64, 128, 512])
@pytest.mark.parametrize("route", sorted(VIEW_ROUTES))
def test_transposed_view_through_each_route(cuda, route, d):
    q, k, v = qkv(cuda, 2, 300, 260, 2, d, seed=d)
    # Stored (B, H, L, D), read as (B, L, H, D); and one at an odd offset.
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not any(x.is_contiguous() for x in views)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 != 0
    call = VIEW_ROUTES[route]
    want = call(q, k, v)
    for got in (call(*views), call(shifted, k, v)):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)


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


# The DiT's block matmuls (M = 5,120) per channel and g128, and the new
# design's edges: a k32 step that straddles K (K = 48), partial tiles (M = 77,
# N = 100, M = 1000), one warpgroup's rows (M = 64), group 32 (a fold after
# every k32 step, and k32 steps past K at K = 96), 256 and 512 (a group
# spanning two and four stages); and the cross-attention's k / v of a
# 512-token, 1024-channel crossattn_emb at 5 rows (K = 1024, 8 groups of 128).
QMM_CASES = [(5120, 4096, 4096, None), (5120, 4096, 4096, 128), (5120, 4096, 16384, None),
             (5120, 4096, 16384, 128), (5120, 16384, 4096, None), (5120, 16384, 4096, 128),
             (1000, 4096, 4096, None), (5120, 4096, 4096, 32), (5120, 4096, 4096, 512),
             (77, 48, 100, None), (64, 4096, 4096, None), (64, 4096, 4096, 128),
             (77, 512, 100, 256), (1000, 4096, 4096, 256), (77, 96, 100, 32),
             (2560, 1024, 4096, None), (2560, 1024, 4096, 128)]


def w8a8_operands(device, m, k, n, group):
    g = torch.Generator(device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=device).bfloat16()
    leaf = quantize_tensor((torch.randn(n, k, generator=g, device=device) * 0.02).bfloat16(),
                           act_quant=True, group_size=group)
    xq, dq = tqm.quantize_activation_fp32(x)
    return xq, dq, leaf["q"], leaf["sa"]


def assert_w8a8_close(got, want, group):
    """Per channel bitwise; grouped within one bf16 ulp of max |plain| and a
    relative L2 error of 1e-3."""
    if group is None:
        assert torch.equal(got, want)
    else:
        wmax = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 2.0 ** (
            math.floor(math.log2(wmax)) - 7)
        assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 1e-3


@pytest.mark.parametrize("m,k,n,group", QMM_CASES)
def test_w8a8_kernel_matches_plain(cuda, m, k, n, group):
    xq, dq, wq, sa = w8a8_operands(cuda, m, k, n, group)
    tqm.reset_counts()
    got = tqm.quant_matmul_w8a8_kernel(xq, dq, wq, sa, torch.bfloat16)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES["quant_matmul_w8a8"] == 1
    assert_w8a8_close(got, tqm.quant_matmul_w8a8_plain(xq, dq, wq, sa, torch.bfloat16), group)


@pytest.mark.parametrize("m,k,n,group", [(77, 48, 100, None), (1000, 4096, 4096, None),
                                         (77, 512, 100, 256), (1000, 4096, 4096, 128)])
def test_w8a8_kernel_fp32_output(cuda, m, k, n, group):
    """The fp32-output kernels: bitwise per channel (the same fp32 epilogue,
    no bf16 rounding), within the grouped limits otherwise."""
    xq, dq, wq, sa = w8a8_operands(cuda, m, k, n, group)
    got = tqm.quant_matmul_w8a8_kernel(xq, dq, wq, sa, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert_w8a8_close(got, tqm.quant_matmul_w8a8_plain(xq, dq, wq, sa, torch.float32), group)


def test_w8a8_kernel_refuses_illegal_shapes(cuda):
    xq = torch.zeros(64, 40, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        tqm.quant_matmul_w8a8_kernel(xq, torch.ones(64, device=cuda),
                                     torch.zeros(32, 40, dtype=torch.int8, device=cuda),
                                     torch.ones(32, device=cuda), torch.bfloat16)


@pytest.mark.parametrize("b,lq,lk,h,d", [(5, 1024, 1024, 32, 128), (2, 1000, 777, 4, 128),
                                         (1, 300, 200, 2, 64), (1, 4096, 4096, 1, 512),
                                         (2, 1000, 777, 1, 512), (2, 1024, 1024, 8, 256),
                                         (1, 300, 200, 2, 256), (2, 1000, 777, 4, 64),
                                         (2, 777, 1000, 4, 256), (1, 100, 40, 2, 128),
                                         (5, 4096, 4096, 1, 512), (1, 300, 200, 3, 512)])
@pytest.mark.parametrize("pv8", [False, True], ids=["qk8", "qk8pv8"])
def test_int8_attention_kernel_matches_plain(cuda, b, lq, lk, h, d, pv8):
    q, k, v = qkv(cuda, b, lq, lk, h, d)
    tfa.reset_counts()
    got = tfa.flash_attention(q, k, v, qk_int8=True, pv_int8=pv8)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_headroom": 0,
                            "flash_attention_int8": 1}
    assert_close(got, tfa.flash_attention_int8_plain(q, k, v, pv_int8=pv8,
                                                     block_k=tfa.INT8_BLOCK_K[d]))
    # Within the JAX package's int8 bounds of exact attention, or of what the
    # same algorithm at the JAX kernel's own tiling reaches on these inputs.
    exact = attention_xla(q, k, v).float()
    alg = (tfa.flash_attention_int8_plain(q, k, v, pv_int8=pv8).float() - exact).abs().max()
    assert (got.float() - exact).abs().max() <= max(0.025 if pv8 else 0.012, 1.1 * alg.item())


def test_int8_attention_refuses_other_head_dims(cuda):
    q, k, v = qkv(cuda, 1, 64, 64, 1, 96)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k, v, pv_int8=True)
    q, k, v = qkv(cuda, 1, 64, 64, 1, 512)
    with pytest.raises(ValueError, match="tiles of 64"):
        tfa.flash_attention(q, k, v, pv_int8=True, block_k=32)


def test_pv_int8_backend_launches_the_int8_kernel_at_d512(cuda):
    """attention(backend='pallas_pv_int8') at the VAE's single-head D = 512."""
    from diffusionrenderer_tpu_torch.ops.attention import attention

    q, k, v = qkv(cuda, 1, 4096, 4096, 1, 512, seed=3)
    tfa.reset_counts()
    got = attention(q, k, v, backend="pallas_pv_int8")
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_int8"] == 1 and tfa.LAUNCHES["flash_attention"] == 0
    assert_close(got, tfa.flash_attention_int8_plain(q, k, v, pv_int8=True,
                                                     block_k=tfa.INT8_BLOCK_K[512]))


def test_w8a8_dit_forward_kernels_vs_plain(cuda):
    """A 2-block DiT at full head width, W8A8 (per channel): every block
    matmul launches the W8A8 kernel and pallas_pv_int8 the int8 attention."""
    cfg = DiTConfig(model_channels=1024, num_blocks=2, num_heads=8)
    params = quantize_dit_params(init_dit_params(cfg, device=cuda, dtype=torch.bfloat16),
                                 act_quant=True)
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(2, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
    cond = torch.randn(2, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
    sig, ctx = torch.tensor([3.0, 0.5], device=cuda), torch.tensor([0, 3], device=cuda)
    tqm.reset_counts()
    tfa.reset_counts()
    out = dit_forward(params, x, sig, cond, ctx, cfg, attn_backend="pallas_pv_int8")
    assert tqm.LAUNCHES["quant_matmul_w8a8"] == 6 * cfg.num_blocks
    assert tfa.LAUNCHES["flash_attention_int8"] == cfg.num_blocks
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("group", [None, 128])
def test_w8a8_dit_forward_with_crossattn_emb(cuda, group):
    """A 2-block DiT at full head width, W8A8, with a (2, 512, 1024)
    crossattn_emb: ca.wq / wk / wv / wo join the six matmuls that launch the
    W8A8 kernel (ca.wk / wv at K = 1024), against the same forward through
    the W8A8 plain version (per channel bitwise matmul by matmul, so within
    bf16 noise at the end)."""
    from diffusionrenderer_tpu_torch.models import quant

    cfg = DiTConfig(model_channels=1024, num_blocks=2, num_heads=8)
    params = quantize_dit_params(init_dit_params(cfg, device=cuda, dtype=torch.bfloat16),
                                 act_quant=True, group_size=group)
    g = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(2, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
    cond = torch.randn(2, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
    emb = torch.randn(2, 512, cfg.crossattn_emb_channels, generator=g, device=cuda).bfloat16()
    sig = torch.tensor([3.0, 0.5], device=cuda)
    tqm.reset_counts()
    got = dit_forward(params, x, sig, cond, None, cfg, crossattn_emb=emb)
    assert tqm.LAUNCHES["quant_matmul_w8a8"] == 10 * cfg.num_blocks

    def plain(xx, wq, scale):
        *lead, k = xx.shape
        xq, dq = tqm.quantize_activation_fp32(xx.reshape(-1, k))
        return tqm.quant_matmul_w8a8_plain(xq, dq, wq, scale, xx.dtype).reshape(*lead, -1)

    kernel_call, quant.quant_matmul_w8a8 = quant.quant_matmul_w8a8, plain
    try:
        want = dit_forward(params, x, sig, cond, None, cfg, crossattn_emb=emb)
    finally:
        quant.quant_matmul_w8a8 = kernel_call
    assert torch.isfinite(got).all()
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 2e-2


def aligned_qkv(device, b, lq, lk, h, d, q_scale, seed=0):
    """RMS-normed keys and queries that are q_scale times a key plus noise:
    scores of q_scale * 0.13 * d log2 units, so at q_scale 10 and d = 128 the
    unshifted exp2 overflows, while the row bound stays within a few units of
    each row's true max and the bounded softmax stays exact."""
    g = torch.Generator(device).manual_seed(seed)
    k = torch.randn(b, lk, h, d, generator=g, device=device)
    k = k * torch.rsqrt(k.square().mean(-1, keepdim=True))
    idx = torch.randint(0, lk, (lq,), generator=g, device=device)
    q = q_scale * (k[:, idx] + 0.05 * torch.randn(b, lq, h, d, generator=g, device=device))
    v = torch.randn(b, lk, h, d, generator=g, device=device)
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


# Kernel 3's edges on the wgmma body (128 query rows and 128 keys a block):
# Lq not a multiple of 128, fewer keys than one tile, Lk not a multiple of
# 128, several (b, h).
PARTIAL_CASES = CASES + [(2, 100, 40, 3, 128), (3, 333, 250, 2, 64), (1, 130, 77, 8, 64),
                         (4, 1024, 1024, 32, 128)]


@pytest.mark.parametrize("b,lq,lk,h,d", PARTIAL_CASES)
@pytest.mark.parametrize("q_scale", [1.0, 100.0])
def test_partial_kernel_matches_plain(cuda, b, lq, lk, h, d, q_scale):
    q, k, v = qkv(cuda, b, lq, lk, h, d, q_scale)
    tfa.reset_counts()
    out, m, l = tfa.flash_attention_partial(q, k, v)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES["flash_attention_partial"] == 1
    assert sum(tfa.LAUNCHES.values()) == 0
    assert tfa.branch_counts(cuda) == {"noshift": 0, "online": 0}
    want = tfa.flash_attention_partial_plain(q, k, v)
    for got_x, want_x in zip((out, m, l), want):
        assert_close(got_x, want_x)


@pytest.mark.parametrize("b,lq,lk,h,d", PARTIAL_CASES)
@pytest.mark.parametrize("q_scale", [1.0, 30.0])
def test_partial_kernel_out_is_the_unbounded_call(cuda, b, lq, lk, h, d, q_scale):
    """Kernel 3 is kernel 2's online body plus the stores of m and l (at D =
    256, 512 on attend_wide): with its keys not split, its output is bit for
    bit the unbounded flash_attention's at every head dim."""
    q, k, v = qkv(cuda, b, lq, lk, h, d, q_scale, seed=lq + lk + d + 3)
    out, _, _ = tfa.flash_attention_partial_kernel(q, k, v, key_split=False)
    assert torch.equal(out, tfa.flash_attention(q, k, v, bounded=False))


def split_edge_qkv(device, b, lq, lk, h, d, low_rank: int, seed=0):
    """Inputs whose keys in one half of the split (low_rank 0: the first
    ceil(nk / 2) key tiles, 1: the rest) score far below the other half's:
    RMS-normed keys and queries 10 times a key of the high half plus noise,
    so a row's running max is about 10 * d / sqrt(d) * log2 e in the high
    half (326 log2 units at D = 512) and some 50 in the low one.  Returns
    q, k, v and the low half's key slice."""
    bk = tfa.WIDE_BLOCK_K[d]
    nk = -(-lk // bk)
    cut = -(-nk // 2) * bk  # rank 1's first key
    g = torch.Generator(device).manual_seed(seed)
    k = torch.randn(b, lk, h, d, generator=g, device=device)
    k = k * torch.rsqrt(k.square().mean(-1, keepdim=True))
    high = (cut, lk) if low_rank == 0 else (0, cut)
    idx = torch.randint(high[0], high[1], (lq,), generator=g, device=device)
    q = 10.0 * (k[:, idx] + 0.05 * torch.randn(b, lq, h, d, generator=g, device=device))
    v = torch.randn(b, lk, h, d, generator=g, device=device)
    low = slice(0, cut) if low_rank == 0 else slice(cut, lk)
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), low


# Kernel 3's key split at the wide heads (32-key tiles at D = 512, 64 at D =
# 256): the VAE's encode shape, ragged lengths, and Lk = k * BK + 1, where
# rank 1's last tile holds one real key.
PARTIAL_SPLIT_CASES = [(1, 4096, 4096, 1, 512), (1, 1000, 1200, 1, 512), (1, 1000, 777, 2, 256),
                       (2, 300, 97, 1, 512), (1, 200, 193, 2, 256)]


@pytest.mark.parametrize("b,lq,lk,h,d", PARTIAL_SPLIT_CASES)
@pytest.mark.parametrize("q_scale", [1.0, 100.0])
def test_wide_partial_key_split_matches_plain(cuda, b, lq, lk, h, d, q_scale):
    """Kernel 3 at D = 256, 512 with the keys split over 2-block clusters
    (the halves merged with the online rescale) and without: out, m and l
    each within the bf16 tolerance of the plain version, the split the
    default at these shapes, and the same bits run after run."""
    q, k, v = qkv(cuda, b, lq, lk, h, d, q_scale, seed=lq + lk + d + 5)
    want = tfa.flash_attention_partial_plain(q, k, v)
    assert tfa.partial_key_split(q, k)
    split = tfa.flash_attention_partial_kernel(q, k, v, key_split=True)
    whole = tfa.flash_attention_partial_kernel(q, k, v, key_split=False)
    for got in (split, whole):
        for got_x, want_x in zip(got, want):
            assert_close(got_x, want_x)
    again = tfa.flash_attention_partial_kernel(q, k, v)
    for x, y in zip(split, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,lq,lk,h,d", [(1, 1000, 1200, 1, 512), (2, 300, 97, 1, 512),
                                         (1, 200, 193, 2, 256)])
@pytest.mark.parametrize("low_rank", [0, 1])
def test_wide_partial_key_split_when_one_half_underflows(cuda, b, lq, lk, h, d, low_rank):
    """One half's running max far below the other's: its merge factor is 0,
    and the split call gives the other half's result, as the plain version
    does over all keys."""
    q, k, v, low = split_edge_qkv(cuda, b, lq, lk, h, d, low_rank, seed=lq + lk + d)
    want = tfa.flash_attention_partial_plain(q, k, v)
    m_low = tfa.flash_attention_partial_plain(q, k[:, low], v[:, low])[1]
    assert (want[1] - m_low).min().item() > 150  # exp2f of the gap underflows to 0
    got = tfa.flash_attention_partial_kernel(q, k, v, key_split=True)
    for got_x, want_x in zip(got, want):
        assert torch.isfinite(got_x).all()
        assert_close(got_x, want_x)


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
@pytest.mark.parametrize("aligned", [False, True], ids=["random", "aligned_x10"])
def test_bounded_kernels_match_plain(cuda, b, lq, lk, h, d, aligned):
    q, k, v = (aligned_qkv(cuda, b, lq, lk, h, d, 10.0) if aligned
               else qkv(cuda, b, lq, lk, h, d))
    tfa.reset_counts()
    pipe = tfa.flash_attention(q, k, v, bounded=True, pipelined=True)
    shift = tfa.flash_attention_bounded_shift(q, k, v)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES == {"flash_attention_partial": 0,
                                    "flash_attention_bounded_pipe": 1,
                                    "flash_attention_bounded": 1}
    assert sum(tfa.LAUNCHES.values()) == 0
    assert tfa.branch_counts(cuda) == {"noshift": 0, "online": 0}
    # One wgmma body at each head dim: at 64 and 128 l summed in key order
    # and PV issued in k16 order whatever the tile, at 256 and 512 one
    # schedule with the same key split.
    assert torch.equal(pipe, shift)
    assert_close(shift, tfa.flash_attention_bounded_plain(q, k, v))
    if aligned:  # the shift keeps the bounded softmax exact where exp2(s) overflows
        assert_close(shift, tfa.flash_attention_plain(q, k, v, bounded=False))


@pytest.mark.parametrize("b,lq,lk,h,d", WGMMA_CASES)
@pytest.mark.parametrize("aligned", [False, True], ids=["random", "aligned_x10"])
def test_wgmma_kernel6_matches_plain_and_kernel7(cuda, b, lq, lk, h, d, aligned):
    q, k, v = (aligned_qkv(cuda, b, lq, lk, h, d, 10.0, seed=lq + d) if aligned
               else qkv(cuda, b, lq, lk, h, d, seed=lq + lk + d + 2))
    mb = tfa.row_bound(q, k)
    tfa.reset_counts()
    got = tfa.flash_attention_bounded_kernel(q, k, v, mb, pipelined=True)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES["flash_attention_bounded_pipe"] == 1
    assert_close(got, tfa.flash_attention_bounded_plain(q, k, v, mb))
    shift = tfa.flash_attention_bounded_kernel(q, k, v, mb, pipelined=False)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES["flash_attention_bounded"] == 1
    assert_close(shift, tfa.flash_attention_bounded_plain(q, k, v, mb))
    assert torch.equal(got, shift)


@pytest.mark.parametrize("b,lq,lk,h,d", [(1, 4096, 4096, 1, 512), (1, 1000, 1200, 1, 512),
                                         (1, 1000, 777, 2, 256)])
def test_wide_bounded_key_split_matches_plain(cuda, b, lq, lk, h, d):
    """Kernels 6 and 7 at the wide heads with the keys split over 2-block
    clusters and without: each within the bf16 tolerance of the plain
    version, the split the default at these shapes, and each
    mode the same bits run after run (the merge adds in one fixed order)."""
    q, k, v = qkv(cuda, b, lq, lk, h, d, seed=lq + lk + d + 4)
    mb = tfa.row_bound(q, k)
    want = tfa.flash_attention_bounded_plain(q, k, v, mb)
    assert tfa.bounded_key_split(q, k, pipelined=True)
    assert tfa.bounded_key_split(q, k, pipelined=False)
    for pipelined in (True, False):
        split = tfa.flash_attention_bounded_kernel(q, k, v, mb, pipelined=pipelined,
                                                   key_split=True)
        whole = tfa.flash_attention_bounded_kernel(q, k, v, mb, pipelined=pipelined,
                                                   key_split=False)
        assert_close(split, want)
        assert_close(whole, want)
        assert torch.equal(split, tfa.flash_attention_bounded_kernel(q, k, v, mb,
                                                                     pipelined=pipelined))
        assert torch.equal(split, tfa.flash_attention_bounded_kernel(q, k, v, mb,
                                                                     pipelined=pipelined,
                                                                     key_split=True))


def test_key_split_only_where_it_can_run(cuda):
    """The split by default where pairs of half-length blocks take fewer
    waves (5 blocks at (1, 300, 300, 1, 512); 320, 2.4 waves of whole
    blocks on 132 SMs, at (5, 4096, 1, 512)), not where the waves come out
    even (256 blocks at (2, 1024, 8, 256)) or the keys fill one tile; a
    forced split is refused there and below D = 256."""
    for shape, default in (((2, 1024, 1024, 8, 256), False), ((1, 300, 20, 1, 512), False),
                           ((1, 300, 40, 2, 128), False), ((1, 300, 300, 1, 512), True),
                           ((5, 4096, 4096, 1, 512), True)):
        q, k, v = qkv(cuda, *shape)
        assert tfa.bounded_key_split(q, k) == default, shape
    for shape in ((1, 300, 20, 1, 512), (1, 300, 300, 2, 128)):
        q, k, v = qkv(cuda, *shape)
        with pytest.raises(RuntimeError, match="key split"):
            tfa.flash_attention_bounded_kernel(q, k, v, tfa.row_bound(q, k), pipelined=True,
                                               key_split=True)


def band_qkv(device):
    """fp32's underflow band in bf16: numpy default_rng(0) standard normals,
    (1, 256, 2, 64), q x 14 (rows whose row bound overshoots their true max
    by 104 to 187 log2 units: most flush to zero)."""
    import numpy as np

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, 2, 64)).astype(np.float32))
               for _ in range(3))
    return (q * 14).to(device).bfloat16(), k.to(device).bfloat16(), v.to(device).bfloat16()


def noshift_band_qkv(device):
    """No-shift inputs with rows whose every weight is below 2^-126: keys
    of norm 9.9 to 10 along one direction, queries against it with scores
    near -80 (even rows) or below -126 (odd rows), max |v| = 2^-18."""
    g = torch.Generator(device).manual_seed(1)
    u = torch.randn(64, generator=g, device=device)
    u = u / u.norm()
    a = 9.9 + 0.1 * torch.rand(1, 256, 2, 1, generator=g, device=device)
    k = a * u + 0.01 * torch.randn(1, 256, 2, 64, generator=g, device=device)
    qn = torch.where(torch.arange(128, device=device) % 2 == 0, 8.0, 12.9)[None, :, None, None]
    q = (-qn * u / (64 ** -0.5 * math.log2(math.e))).expand(1, 128, 2, 64)
    v = torch.randn(1, 256, 2, 64, generator=g, device=device)
    v = v * (2.0 ** -18 / v.abs().max())
    return q.bfloat16().contiguous(), k.bfloat16(), v.bfloat16()


def test_underflow_band_kernels_1_and_6(cuda):
    """Weights below 2^-126 flush to zero in the kernels (ex2.approx.ftz) as
    in the plain versions: kernels 6 and 7 on the q x 14 case, kernel 1 on
    rows whose every weight is below 2^-126."""
    q, k, v = band_qkv(cuda)
    want = tfa.flash_attention_bounded_plain(q, k, v)
    assert (want.float().abs().amax(-1) == 0).float().mean() > 0.5
    assert_close(tfa.flash_attention(q, k, v, bounded=True, pipelined=True), want)
    assert_close(tfa.flash_attention_bounded_shift(q, k, v), want)
    q, k, v = noshift_band_qkv(cuda)
    tfa.reset_counts()
    got = tfa.flash_attention(q, k, v, bounded=True)
    torch.cuda.synchronize()
    assert tfa.branch_counts(cuda) == {"noshift": 1, "online": 0}
    want = tfa.flash_attention_plain(q, k, v, bounded=True)
    assert bool((want[:, 1::2] == 0).all()) and bool((got[:, 1::2] == 0).all())
    assert_close(got, want)


@pytest.mark.parametrize("mode", ["cubemap", "direct", "ball"])
def test_envmap_on_card_matches_cpu(cuda, mode):
    """The envmap path on CUDA tensors against the same functions on the
    CPU, in [0, 1]: within one bf16 ulp at 1.0 (the rounding the env
    conditions take when they enter the bf16 VAE)."""
    import numpy as np

    from diffusionrenderer_tpu_torch import envmap

    rng = np.random.default_rng(0)
    pano = (np.abs(rng.standard_normal((64, 128, 3))) * 20.0).astype(np.float32)
    pano[1, 2] = [np.nan, np.inf, -np.inf]

    def run(dev):
        if mode == "ball":
            return envmap.tonemap_image_direct(pano, (48, 48), use_cache=False, device=dev)
        return envmap.render_projection_from_panorama(pano, (48, 64), env_rot=90.0,
                                                      use_cache=False, mode=mode, device=dev)

    got, want = run(cuda), run("cpu")
    for key in ("env_ldr", "env_log"):
        assert got[key].is_cuda
        assert (got[key].cpu() - want[key]).abs().max().item() <= 2.0 ** -8


def test_forward_render_tiny_on_card(cuda):
    """forward_render through the public API on the card: a 2-block forward
    DiT with 128-wide heads at 256 x 256 (256 tokens, so its attention takes
    the flash kernel), 1 and 9 frames."""
    import numpy as np

    from diffusionrenderer_tpu_torch import forward_render, load_pipeline
    from diffusionrenderer_tpu_torch.config import VAEConfig

    net = DiTConfig(model_channels=256, num_blocks=2, num_heads=2, additional_concat_ch=136,
                    adaln_lora_dim=8, crossattn_emb_channels=16, use_context_embedding=False)
    vae = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                    decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
    pipe = load_pipeline(model_type="forward", net_config=net, vae_config=vae, num_steps=3)
    rng = np.random.default_rng(1)
    env = (np.abs(rng.standard_normal((64, 128, 3))) * 20.0).astype(np.float32)
    for frames in (1, 9):
        shape = (1, frames, 256, 256, 3) if frames > 1 else (1, 256, 256, 3)
        g = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(5)]
        tfa.reset_counts()
        out = forward_render(pipe, *g, env)
        assert tfa.LAUNCHES["flash_attention"] == 3 * net.num_blocks
        assert out.shape == (frames, 256, 256, 3)
        assert np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0


def test_safetensors_reader_straight_to_the_card(cuda, tmp_path):
    """SafetensorsFile(device='cuda') copies each tensor from the mapped
    file onto the card; the writer takes card tensors."""
    from diffusionrenderer_tpu_torch.utils.safetensors import SafetensorsFile, write_safetensors

    g = torch.Generator(cuda).manual_seed(0)
    want = {"w": torch.randn(64, 32, generator=g, device=cuda).bfloat16(),
            "s": torch.rand(32, generator=g, device=cuda),
            "q": torch.randint(-127, 128, (16, 8), generator=g, device=cuda).to(torch.int8)}
    path = str(tmp_path / "t.safetensors")
    write_safetensors(path, want)
    with SafetensorsFile(path, cuda) as f:
        for k, v in want.items():
            assert f[k].is_cuda and f[k].dtype == v.dtype and torch.equal(f[k], v), k


def test_tiny_checkpoint_loads_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """A reference-format DiT file and a native VAE file through
    load_pipeline(device='cuda') give the CPU load's parameters bit for
    bit; quantized on load (W8A8, g64), the card's quantize_dit_params of
    the loaded weights (the quantizer's division runs on the device that
    holds the weights, so the card's and the CPU's codes may differ by one
    step at a tie)."""
    import json

    from diffusionrenderer_tpu_torch import load_pipeline
    from diffusionrenderer_tpu_torch.checkpoint import _flatten, export_dit_state_dict
    from diffusionrenderer_tpu_torch.checkpoint_vae import save_vae_native
    from diffusionrenderer_tpu_torch.config import VAEConfig
    from diffusionrenderer_tpu_torch.models.vae import init_vae_params
    from diffusionrenderer_tpu_torch.utils.safetensors import write_safetensors

    net = DiTConfig(model_channels=256, num_blocks=2, num_heads=2, additional_concat_ch=16,
                    adaln_lora_dim=8, crossattn_emb_channels=16, use_context_embedding=True)
    vae = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                    decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
    dit = str(tmp_path / "dit.safetensors")
    write_safetensors(dit, export_dit_state_dict(
        init_dit_params(net, device="cpu", dtype=torch.bfloat16, seed=3), net))
    vae_file = str(tmp_path / "vae.safetensors")
    save_vae_native(vae_file, init_vae_params(vae, device="cpu", dtype=torch.float32, seed=4))
    stats = str(tmp_path / "config.json")
    with open(stats, "w") as f:
        json.dump({"latents_mean": [0.1] * 256, "latents_std": [0.9] * 256}, f)
    kw = dict(dit_checkpoint=dit, vae_checkpoint=vae_file, vae_config_json=stats,
              net_config=net, vae_config=vae)

    def assert_same(got, want, device):
        a, b = _flatten(got), _flatten(want)
        assert sorted(a) == sorted(b)
        for k, v in a.items():
            assert v.device.type == device and v.dtype == b[k].dtype, k
            assert torch.equal(v.cpu(), b[k].cpu()), k

    on_card = load_pipeline(**kw, device=cuda)
    on_cpu = load_pipeline(**kw, device="cpu")
    for tree in ("dit_params", "vae_params"):
        assert_same(getattr(on_card, tree), getattr(on_cpu, tree), "cuda")
    quant = dict(act_quant=True, group_size=64)
    q_card = load_pipeline(**kw, device=cuda, quantize_int8=True, act_quant=True,
                           quant_group_size=64)
    assert_same(q_card.dit_params, quantize_dit_params(on_card.dit_params, **quant), "cuda")


# ---------------------------------------------------------------------------
# The user surfaces on the card
# ---------------------------------------------------------------------------

SURFACE_NET = dict(model_channels=256, num_blocks=2, num_heads=2, adaln_lora_dim=8,
                   crossattn_emb_channels=16)
# A batched row against the same request alone, in bf16 on the card: cuBLAS
# may pick another algorithm for 5 rows than for 1, so the rows are held to
# a PSNR floor at uint8, not bit for bit.
BATCH_PSNR_DB = 30.0


def test_tiny_cli_in_a_subprocess_on_the_card(cuda, tmp_path):
    """`python -m diffusionrenderer_tpu_torch.cli` without --cpu runs on the
    card: info names it, inverse and envmap write their PNGs."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np

    from diffusionrenderer_tpu_torch import io as tio

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(0)
    png, hdr = str(tmp_path / "rgb.png"), str(tmp_path / "sky.hdr")
    tio.write_png(png, rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    tio.save_hdr(hdr, (np.abs(rng.standard_normal((16, 32, 3))) * 4).astype(np.float32))

    def cli(*args):
        res = subprocess.run([sys.executable, "-m", "diffusionrenderer_tpu_torch.cli", *args],
                             cwd=root, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-4000:]
        return res.stdout

    info = json.loads(cli("info"))
    assert info["backend"] == "cuda" and info["devices"] == torch.cuda.device_count()
    cli("inverse", "--tiny", "--steps", "2", "--passes", "depth,normal", "--input", png,
        "--output-dir", str(tmp_path / "inv"))
    cli("envmap", "--input", hdr, "--height", "32", "--width", "32", "--output-prefix",
        str(tmp_path / "env"))
    for path in (tmp_path / "inv" / "depth.png", tmp_path / "inv" / "normal.png",
                 tmp_path / "env_env_ldr.png", tmp_path / "env_env_log.png"):
        img = tio.read_png(str(path))
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8


def test_tiny_server_on_the_card(cuda):
    """Five requests from five threads go out as one dispatch of 5 rows; each
    row is within BATCH_PSNR_DB of the same request generated alone, and
    every attention call of the dispatch launched the kernel."""
    import threading

    import numpy as np

    from diffusionrenderer_tpu_torch import load_pipeline
    from diffusionrenderer_tpu_torch.config import VAEConfig
    from diffusionrenderer_tpu_torch.serving import ServingExecutor
    from diffusionrenderer_tpu_torch.utils.metrics import psnr
    from diffusionrenderer_tpu_torch.utils.profiling import metrics

    net = DiTConfig(**SURFACE_NET, additional_concat_ch=16, use_context_embedding=True)
    vae = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                    decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
    pipe = load_pipeline(net_config=net, vae_config=vae, num_steps=3)
    rng = np.random.default_rng(2)
    reqs = [{"rgb": rng.integers(0, 256, (1, 1, 256, 256, 3), dtype=np.uint8),
             "context_index": np.asarray([i])} for i in range(5)]
    solo = [pipe.generate(r, seed=i) for i, r in enumerate(reqs)]
    ex = ServingExecutor(pipe, max_batch=5, max_wait_ms=5000)
    metrics.reset()
    tfa.reset_counts()
    results = [None] * 5
    start = threading.Barrier(5)

    def client(i):
        start.wait(timeout=60)
        results[i] = ex.submit(reqs[i], seed=i).result(timeout=600)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
    finally:
        ex.shutdown(join_timeout=600)
    assert metrics.summary()["serving/dispatch"]["count"] == 1
    assert tfa.LAUNCHES["flash_attention"] == 3 * net.num_blocks
    for got, want in zip(results, solo):
        assert got.shape == want.shape and got.dtype == np.uint8
        assert psnr(got, want) >= BATCH_PSNR_DB


def test_trace_names_the_flash_attention_kernel(cuda, tmp_path):
    import json
    import os

    from diffusionrenderer_tpu_torch.utils.profiling import annotate, trace

    q, k, v = qkv(cuda, 1, 1024, 1024, 4, 128)
    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("drt_attention"):
            tfa.flash_attention(q, k, v)
    with open(os.path.join(d, "trace.json")) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert any("attention_kernel" in n for n in names), sorted(set(names))[:40]
    assert "drt_attention" in names


# ---------------------------------------------------------------------------
# The trainer on the card: FlashAttentionFunction (kernel 3 forward, plain
# backward), the refusals, a train step and a resumed loop.
# ---------------------------------------------------------------------------

def grads_of(fn, q, k, v, do):
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*ts)
    out.backward(do)
    return out.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("b,lq,lk,h,d", [(1, 1024, 1024, 8, 128), (2, 300, 500, 2, 64),
                                         (1, 777, 256, 3, 128)])
def test_flash_function_grads_match_fp32_autograd(cuda, b, lq, lk, h, d):
    """bf16 kernel 3 + the plain backward vs autograd through the plain
    attention in fp32 on the same inputs: rel L2 <= 1e-2 for dq, dk, dv."""
    q, k, v = qkv(cuda, b, lq, lk, h, d, seed=lq + lk)
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(5),
                     device=cuda).bfloat16()
    tfa.reset_counts()
    out, got = grads_of(lambda *t: attention(*t, backend="pallas"), q, k, v, do)
    assert tfa.VARIANT_LAUNCHES["flash_attention_partial"] == 1
    assert tfa.LAUNCHES["flash_attention"] == 0
    want_out, want = grads_of(attention_xla, q.float(), k.float(), v.float(), do.float())
    assert_close(out, want_out)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        rel = ((g.float() - w).norm() / w.norm()).item()
        assert math.isfinite(rel) and rel <= 1e-2, rel


@pytest.fixture
def one_rank_mesh(cuda):
    """A one-rank gloo group on the card (no collective runs at one rank)."""
    import socket

    import torch.distributed as dist
    from diffusionrenderer_tpu_torch.parallel import initialize_distributed, make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(cuda, backend="gloo", init_method=f"tcp://localhost:{port}",
                           world_size=1, rank=0)
    try:
        yield make_mesh(1, data=1, seq=1, tensor=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("b,l,h,d", [(1, 1024, 8, 128), (2, 300, 2, 64)])
def test_ring_function_grads_match_plain(cuda, one_rank_mesh, b, l, h, d):
    """Ring attention's gradient on the card (RingAttentionFunction: one
    kernel-3 launch a forward, the plain backward ring) vs its plain
    version, the ring's impl='xla' under autograd in fp32 on the same
    inputs: rel L2 <= 1e-2 for dq, dk, dv; and vs FlashAttentionFunction."""
    from diffusionrenderer_tpu_torch.parallel import ring_attention_local

    q, k, v = qkv(cuda, b, l, l, h, d, seed=l + d)
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(6),
                     device=cuda).bfloat16()
    tfa.reset_counts()
    out, got = grads_of(lambda *t: ring_attention_local(*t, one_rank_mesh), q, k, v, do)
    assert tfa.VARIANT_LAUNCHES["flash_attention_partial"] == 1
    assert tfa.LAUNCHES["flash_attention"] == 0
    want_out, want = grads_of(lambda *t: ring_attention_local(*t, one_rank_mesh, impl="xla"),
                              q.float(), k.float(), v.float(), do.float())
    _, function = grads_of(tfa.FlashAttentionFunction.apply, q, k, v, do)
    assert_close(out, want_out)
    for g, w, f in zip(got, want, function):
        assert g.dtype == torch.bfloat16
        for ref in (w, f.float()):
            rel = ((g.float() - ref).norm() / ref.norm()).item()
            assert math.isfinite(rel) and rel <= 1e-2, rel


def test_inference_route_unchanged_under_no_grad(cuda):
    q, k, v = qkv(cuda, 1, 1024, 1024, 4, 128)
    want = tfa.flash_attention(q, k, v, bounded=True)
    tfa.reset_counts()
    with torch.no_grad():
        got = tfa.flash_attention(q.requires_grad_(True), k, v, bounded=True)
    assert tfa.LAUNCHES["flash_attention"] == 1 and tfa.LAUNCHES["flash_attention_headroom"] == 1
    assert tfa.VARIANT_LAUNCHES["flash_attention_partial"] == 0
    assert torch.equal(got, want)


def test_routes_without_a_gradient_refuse_on_the_card(cuda):
    q, k, v = qkv(cuda, 1, 256, 256, 2, 128)
    k.requires_grad_(True)
    for route in (lambda: tfa.flash_attention(q, k, v, qk_int8=True),
                  lambda: tfa.flash_attention(q, k, v, pv_int8=True),
                  lambda: tfa.flash_attention(q, k, v, bounded=True, pipelined=True),
                  lambda: tfa.flash_attention_bounded_shift(q, k, v),
                  lambda: tfa.flash_attention_partial(q, k, v),
                  lambda: tfa.flash_attention_kernel(q, k, v, None),
                  lambda: attention(q, k, v, backend="pallas_pv_int8")):
        with pytest.raises(RuntimeError, match="has no gradient"):
            route()


def tiny_train_setup(cuda, grad_accum=1, context_index=(1, 4)):
    from diffusionrenderer_tpu_torch.training import (init_train_state, make_optimizer,
                                                      make_train_step)

    cfg = DiTConfig(model_channels=256, num_blocks=2, num_heads=2, adaln_lora_dim=16,
                    crossattn_emb_channels=64)
    opt = make_optimizer(3e-3)
    state = init_train_state(init_dit_params(cfg, device=cuda, dtype=torch.bfloat16, seed=0), opt)
    step = make_train_step(cfg, opt, condition_drop_rate=0.1, grad_accum=grad_accum)

    def batch_fn(i):
        g = torch.Generator(cuda).manual_seed(100 + i)
        b = len(context_index)
        return {"latents": torch.randn(b, 1, 32, 32, 16, generator=g, device=cuda).bfloat16(),
                "latent_condition": torch.randn(b, 1, 32, 32, 16, generator=g,
                                                device=cuda).bfloat16(),
                "context_index": torch.tensor(context_index, device=cuda)}
    return cfg, state, step, batch_fn


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_launches_kernel3_per_microbatch(cuda, grad_accum):
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    cfg, state, step, batch_fn = tiny_train_setup(cuda, grad_accum)
    before = [p.clone() for p in tree_leaves(state.params)]
    tfa.reset_counts()
    state, loss = step(state, batch_fn(0), torch.Generator(cuda).manual_seed(0))
    assert tfa.VARIANT_LAUNCHES["flash_attention_partial"] == cfg.num_blocks * grad_accum
    assert math.isfinite(float(loss)) and state.step == 1
    still = sum(torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))
    assert still == 4 * cfg.num_blocks  # the cross-attention's q / k leaves: no gradient


# The second case repeats each context index within a microbatch: the
# backward of the context table's gather sums rows that share an index.
@pytest.mark.parametrize("grad_accum,context_index", [(1, (1, 4)), (2, (2, 2, 4, 4))],
                         ids=["b2_accum1", "b4_accum2_repeated_index"])
def test_train_loop_resume_is_bitwise_on_the_card(cuda, tmp_path, grad_accum, context_index):
    from diffusionrenderer_tpu_torch.training import train_loop
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    cfg, _, step, batch_fn = tiny_train_setup(cuda, grad_accum, context_index)

    def make_state():
        return tiny_train_setup(cuda)[1]

    def run(path, n):
        return train_loop(make_state, step, batch_fn, num_steps=n, seed=3,
                          ckpt_dir=str(path), save_every=2, log_every=0)

    full, losses_full = run(tmp_path / "full", 4)
    _, head = run(tmp_path / "cut", 2)
    resumed, tail = run(tmp_path / "cut", 4)
    assert head + tail == losses_full
    for a, b in zip(tree_leaves([full.params, full.opt_state.mu, full.opt_state.nu]),
                    tree_leaves([resumed.params, resumed.opt_state.mu, resumed.opt_state.nu])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The compiled denoise step: one Euler step as a replayed CUDA graph
# ---------------------------------------------------------------------------

# 256 x 256 renders: 256 tokens a row, so the DiT's attention takes the flash
# kernel, and 5 pass rows (1,280 tokens) reach the W8A8 kernel's 512 rows.
STEP_GRAPH_QUANT = {"bf16": {}, "w8a8": dict(quantize_int8=True, act_quant=True),
                    "w8a8_g128": dict(quantize_int8=True, act_quant=True, quant_group_size=128)}


def step_graph_pipe(mode, num_steps=3):
    from diffusionrenderer_tpu_torch import load_pipeline
    from diffusionrenderer_tpu_torch.config import VAEConfig

    net = DiTConfig(**SURFACE_NET, additional_concat_ch=16, use_context_embedding=True)
    vae = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                    decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
    return load_pipeline(net_config=net, vae_config=vae, num_steps=num_steps,
                         **STEP_GRAPH_QUANT[mode])


def render_counted(pipe, image, guidance, *, eager: bool):
    """inverse_render with the denoise replayed (eager=False) or eager, and
    the launches and branch tally it counted."""
    from diffusionrenderer_tpu_torch import inverse_render

    pipe._eager_denoise = eager
    tfa.reset_counts()
    tqm.reset_counts()
    try:
        out = inverse_render(pipe, image, guidance=guidance)
    finally:
        pipe._eager_denoise = False
    torch.cuda.synchronize()
    return out, {**tfa.LAUNCHES, **tfa.VARIANT_LAUNCHES, **tqm.LAUNCHES}, tfa.branch_counts()


@pytest.mark.parametrize("mode", ["bf16", "w8a8", "w8a8_g128"])
def test_step_graph_render_is_the_eager_loop_bitwise(cuda, mode):
    """inverse_render's first (capturing) and warm (replaying) calls equal
    the eager loop's output bit for bit with the same launches and branch
    tally; a second image and a guidance change are refilled, not baked."""
    import numpy as np

    pipe = step_graph_pipe(mode)
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8) for _ in range(2)]
    for i, (image, guidance) in enumerate([(images[0], 0.0), (images[0], 0.0),
                                           (images[1], 0.0), (images[1], 1.5),
                                           (images[0], 2.5)]):
        got, launches, branches = render_counted(pipe, image, guidance, eager=False)
        want, want_launches, want_branches = render_counted(pipe, image, guidance, eager=True)
        for name in want:
            assert np.array_equal(got[name], want[name]), (i, name)
        assert launches == want_launches and branches == want_branches, i
        # One launch per block per step; the tiny VAE's 16-channel attention
        # takes the plain path.
        forwards = pipe.num_steps * 2
        assert launches["flash_attention"] == forwards
        if mode != "bf16":
            assert launches["quant_matmul_w8a8"] == 6 * forwards
    assert len(pipe._step_graphs._graphs) == 2  # guidance 0 and guidance > 0


def test_step_graph_latents_bitwise_and_refilled(cuda):
    """_StepGraphs.sample against the eager sample on card tensors: the
    final latents bitwise, for two conditions, contexts and guidance values
    through one captured graph."""
    from diffusionrenderer_tpu_torch import pipeline as tp
    from diffusionrenderer_tpu_torch.sampling.edm import edm_sigmas

    pipe = step_graph_pipe("bf16")
    cfg = pipe._config_for((5, 1, 256, 256, 3))
    g = torch.Generator(cuda).manual_seed(9)
    runner = tp._StepGraphs()
    for guidance in (1.0, 3.0):
        cond = torch.randn(5, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
        x = (torch.randn(5, 1, 32, 32, 16, generator=g, device=cuda) * 80).bfloat16()
        ctx = torch.randint(0, 5, (5,), generator=g, device=cuda)
        kw = dict(cfg=cfg, use_cfg=True)
        with torch.inference_mode():
            got = runner.sample(pipe.dit_params, cond, ctx, x, guidance, edm_sigmas(3), **kw)
            want = tp.sample(pipe.dit_params, cond, ctx, x, guidance, edm_sigmas(3), **kw)
        assert torch.equal(got, want), guidance
    assert len(runner._graphs) == 1


def test_a_failed_step_capture_raises(cuda, monkeypatch):
    """A host sync inside the step breaks its capture: generate raises and
    caches no graph; nothing carries on eagerly."""
    import numpy as np

    from diffusionrenderer_tpu_torch import pipeline as tp

    pipe = step_graph_pipe("bf16", num_steps=2)
    forward = tp.dit_forward

    def syncing_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        if torch.cuda.is_current_stream_capturing():
            out.sum().item()
        return out

    monkeypatch.setattr(tp, "dit_forward", syncing_forward)
    image = np.zeros((1, 1, 256, 256, 3), np.uint8)
    with pytest.raises(RuntimeError):
        pipe.generate({"rgb": image})
    assert not pipe._step_graphs._graphs
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The compiled VAE and train step: the condition encode, the decode and the
# train step as replayed CUDA graphs
# ---------------------------------------------------------------------------

def vae_graph_pipe(num_steps=2):
    """step_graph_pipe's DiT with a VAE whose mid-blocks are 512 wide, so that
    their spatial attention at 256 x 256 (1,024 tokens, D = 512) launches
    kernels 1 / 2 and the headroom kernel inside the encode and decode
    graphs."""
    from diffusionrenderer_tpu_torch import load_pipeline
    from diffusionrenderer_tpu_torch.config import VAEConfig

    net = DiTConfig(**SURFACE_NET, additional_concat_ch=16, use_context_embedding=True)
    vae = VAEConfig(encoder_block_out_channels=(8, 12, 16, 512),
                    decode_block_out_channels=(12, 16, 16, 512), num_layers=1)
    return load_pipeline(net_config=net, vae_config=vae, num_steps=num_steps)


def test_vae_graph_render_is_the_eager_vae_bitwise(cuda):
    """inverse_render with the encode and decode replayed (the default) and
    eager (_eager_vae), the denoise replayed in both: outputs bitwise, the
    same launches and branch tally, over new images and a capture per key."""
    import numpy as np

    from diffusionrenderer_tpu_torch import inverse_render

    pipe = vae_graph_pipe()
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8) for _ in range(3)]
    for i, image in enumerate(images + images[:1]):
        runs = []
        for eager in (False, True):
            pipe._eager_vae = eager
            tfa.reset_counts()
            try:
                out = inverse_render(pipe, image)
            finally:
                pipe._eager_vae = False
            torch.cuda.synchronize()
            runs.append((out, {**tfa.LAUNCHES, **tfa.VARIANT_LAUNCHES}, tfa.branch_counts()))
        (got, launches, branches), (want, want_launches, want_branches) = runs
        for name in want:
            assert np.array_equal(got[name], want[name]), (i, name)
        assert launches == want_launches and branches == want_branches, i
        # The DiT's 2 blocks a step, and the encode's and decode's attention.
        assert launches["flash_attention"] == pipe.num_steps * 2 + 2
        assert launches["flash_attention_headroom"] == launches["flash_attention"]
    assert len(pipe._vae_graphs._graphs) == 2  # one encode, one decode


def test_vae_graph_latents_and_decode_bitwise(cuda):
    """_VaeGraphs on card tensors: eight uint8 conditions through one encode
    graph, each latent kept past the later replays, and the decode with and
    without the normal mask, bitwise the eager functions."""
    from diffusionrenderer_tpu_torch import pipeline as tp

    pipe = vae_graph_pipe()
    cfg = pipe._config_for((1, 1, 256, 256, 3))
    g = torch.Generator(cuda).manual_seed(11)
    runner = tp._VaeGraphs()
    with torch.inference_mode():
        conds = [torch.randint(0, 256, (1, 1, 256, 256, 3), generator=g, device=cuda,
                               dtype=torch.uint8).permute(0, 4, 1, 2, 3) for _ in range(8)]
        got = [runner.encode(pipe.vae_params, x, cfg=cfg) for x in conds]
        for x, lat in zip(conds, got):
            assert torch.equal(lat, tp.encode_condition(pipe.vae_params, x, cfg=cfg))
        for mask in ([0.0, 0.0], [1.0, 0.0], [1.0, 1.0]):
            sample = torch.randn(2, 1, 32, 32, 16, generator=g, device=cuda).bfloat16()
            mask = torch.tensor(mask, device=cuda)
            assert torch.equal(runner.decode(pipe.vae_params, sample, mask, cfg=cfg),
                               tp.decode(pipe.vae_params, sample, mask, cfg=cfg))
    assert len(runner._graphs) == 2


def test_vae_graph_capture_that_uploads_raises(cuda, monkeypatch):
    """The uint8 range map as it was before its constants became device
    fills (a host copy of each): the encode's capture raises through
    generate and caches nothing; nothing carries on eagerly."""
    import numpy as np

    from diffusionrenderer_tpu_torch import pipeline as tp

    def uploading(z, cfg):
        dt = tp.compute_dtype_of(cfg)
        z = (z.to(dt) * torch.tensor(2.0 / 255.0, dtype=dt, device=z.device)
             - torch.tensor(1.0, dtype=dt, device=z.device))
        return z

    pipe = vae_graph_pipe(num_steps=1)
    monkeypatch.setattr(tp, "_cond_to_ncdhw", uploading)
    with pytest.raises(RuntimeError):
        pipe.generate({"rgb": np.zeros((1, 1, 256, 256, 3), np.uint8)})
    assert not pipe._vae_graphs._graphs
    torch.cuda.synchronize()


def test_vae_graph_and_train_graph_hazards_keep_their_bits(cuda):
    """The two repaired uploads compute what they computed: q_prescale with
    its scale a CPU scalar, and the uint8 range map with device fills."""
    from diffusionrenderer_tpu_torch import pipeline as tp
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config

    g = torch.Generator(cuda).manual_seed(12)
    for dtype, d in ((torch.bfloat16, 128), (torch.bfloat16, 512), (torch.float32, 64)):
        q = torch.randn(2, 300, 4, d, generator=g, device=cuda).to(dtype)
        old = (q * tfa._q_scale(d, dtype).to(q.device)).to(dtype)
        assert torch.equal(tfa.q_prescale(q), old), (dtype, d)
    z = torch.arange(256, device=cuda, dtype=torch.uint8).reshape(1, 1, 1, 16, 16)
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        cfg = get_inverse_renderer_config(16, 16, 1, compute_dtype=name)
        old = (z.to(dtype) * torch.tensor(2.0 / 255.0, dtype=dtype, device=cuda)
               - torch.tensor(1.0, dtype=dtype, device=cuda))
        assert torch.equal(tp._cond_to_ncdhw(z, cfg), old), name


# (grad_accum, context_index) of each step: 3 at batch 2, 2 at batch 4 with
# grad_accum=2, then one at batch 1 (a microbatch shape no step has run).
TRAIN_GRAPH_RUN = ((1, (1, 4)), (1, (2, 0)), (1, (3, 3)), (2, (2, 2, 4, 4)), (2, (0, 1, 2, 3)),
                   (1, (2,)))


def train_graph_run(cuda, eager: bool):
    """tiny_train_setup's state through TRAIN_GRAPH_RUN (graph or eager),
    the two steps on one optimizer: the losses, kernel-3 launches, the
    final parameters and moments, and the graphs captured."""
    from diffusionrenderer_tpu_torch.training import make_train_step
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    cfg, state, step1, _ = tiny_train_setup(cuda)
    steps = {1: step1, 2: make_train_step(cfg, step1.optimizer, condition_drop_rate=0.1,
                                          grad_accum=2)}
    losses, launches = [], []
    for i, (accum, ctx) in enumerate(TRAIN_GRAPH_RUN):
        steps[accum]._eager = eager
        g = torch.Generator(cuda).manual_seed(100 + i)
        b = len(ctx)
        batch = {"latents": torch.randn(b, 1, 32, 32, 16, generator=g, device=cuda).bfloat16(),
                 "latent_condition": torch.randn(b, 1, 32, 32, 16, generator=g,
                                                 device=cuda).bfloat16(),
                 "context_index": torch.tensor(ctx, device=cuda)}
        tfa.reset_counts()
        state, loss = steps[accum](state, batch, torch.Generator(cuda).manual_seed(50 + i))
        torch.cuda.synchronize()
        losses.append(loss)
        launches.append(tfa.VARIANT_LAUNCHES["flash_attention_partial"])
    graphs = len(step1._graphs._graphs)
    return (cfg, losses, launches, tree_leaves([state.params, state.opt_state.mu,
                                                state.opt_state.nu]), graphs)


def test_train_graph_steps_are_the_eager_steps_bitwise(cuda):
    """Six steps on three graphs (the first after an eager warm-up step, the
    others captured at once, one of them at a microbatch shape no eager step
    ran) against six eager ones from the same start: losses, every
    parameter and both moments bitwise (a count frozen at capture would part
    them at step 2), kernel 3 launched once per block per microbatch."""
    cfg, got, got_launches, got_leaves, graphs = train_graph_run(cuda, eager=False)
    _, want, want_launches, want_leaves, none = train_graph_run(cuda, eager=True)
    assert graphs == 3 and none == 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert got_launches == want_launches == [cfg.num_blocks * a for a, _ in TRAIN_GRAPH_RUN]
    for n, (a, b) in enumerate(zip(got_leaves, want_leaves)):
        assert torch.equal(a, b), n


def test_train_graph_capture_that_uploads_raises(cuda, monkeypatch):
    """q_prescale as it was before its scale became a CPU scalar (a host
    copy, in the plain attention backward): the capture after the first
    (eager) step raises, caches nothing and leaves no leaf requiring grad."""
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    def uploading(q):
        return (q * tfa._q_scale(q.shape[-1], q.dtype).to(q.device)).to(q.dtype)

    cfg, state, step, batch_fn = tiny_train_setup(cuda)
    monkeypatch.setattr(tfa, "q_prescale", uploading)
    with pytest.raises(RuntimeError):
        step(state, batch_fn(0), torch.Generator(cuda).manual_seed(0))
    assert not step._graphs._graphs
    assert not any(p.requires_grad or p.grad is not None for p in tree_leaves(state.params))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The DiT's fused norm chains against their plain chains
# ---------------------------------------------------------------------------

# The inverse render's (5, 1024, 4096), the forward's batch 1 and a ragged
# length; the pending residuals of each call site (the FA norm: none; the
# general cross-attention's norm: the FA residual; the MLP norm after a
# one-token cross-attention: the FA residual and a (B, 1, D) row; a row
# alone; the MLP residual: one, no norm).
FUSED_SHAPES = [(5, 1024, 4096), (1, 1024, 4096), (2, 37, 4096)]
FUSED_CASES = {"norm": ((), True), "residual_norm": (("full",), True),
               "two_residuals_norm": (("full", "row"), True), "row_residual_norm": (("row",), True),
               "residual": (("full",), False)}


def bf16_toward(t, z):
    """The bf16 neighbour of t (bf16) on the side of z (float64), t itself
    where z is t: what z rounds to when a sum in another order carries it
    across the midpoint."""
    td = t.double()
    mag = td.abs().clamp_min(2.0 ** -126)
    e = torch.floor(torch.log2(mag))
    ulp = torch.exp2(e - 7)
    up = z > td
    toward_zero = up == (td < 0)
    step = torch.where(toward_zero & (mag == torch.exp2(e)), ulp / 2, ulp)
    n = torch.where(up, td + step, td - step)
    return torch.where(z == td, td, n).to(torch.bfloat16)


def rounded_both_ways(z):
    t = z.to(torch.bfloat16)
    return t, bf16_toward(t, z)


def equal_bits_share(got, want) -> float:
    return (got.view(torch.int16) == want.view(torch.int16)).double().mean().item()


def fused_chain_inputs(device, shape, case, seed=0):
    b, l, d = shape
    g = torch.Generator(device).manual_seed(seed + l)

    def r(*size, scale=1.0):
        return (torch.randn(*size, generator=g, device=device) * scale).bfloat16()

    residuals, norm = FUSED_CASES[case]
    x = r(b, l, d, scale=2.0)
    pending = [(r(b, l if kind == "full" else 1, d), r(b, d, scale=0.3)) for kind in residuals]
    shift, scale = (r(b, d, scale=0.3), r(b, d, scale=0.3)) if norm else (None, None)
    return x, pending, shift, scale


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_residual_ln_modulate_kernel_matches_plain(cuda, shape, case):
    """x' bitwise; xm one of modulate's outputs for the LayerNorm output
    rounded either way (exact statistics in float64), at most one bf16 ulp
    of it, the same bits as the plain chain on all but a few elements."""
    from diffusionrenderer_tpu_torch.ops.norms import modulate

    x, pending, shift, scale = fused_chain_inputs(cuda, shape, case)
    tdf.reset_counts()
    got_x, got_xm = tdf.residual_ln_modulate_kernel(x, pending, shift, scale)
    torch.cuda.synchronize()
    assert tdf.LAUNCHES == {"residual_ln_modulate": 1, "qk_rmsnorm_rope": 0}
    want_x, want_xm = tdf.residual_ln_modulate_plain(x, pending, shift, scale)
    assert torch.equal(got_x, want_x)
    if shift is None:
        assert got_xm is None
        return
    xf = want_x.double()
    centred = xf - xf.mean(-1, keepdim=True)
    z = centred / torch.sqrt(centred.square().mean(-1, keepdim=True) + tdf.EPS)
    allowed = [modulate(y, shift, scale) for y in rounded_both_ways(z)]
    for out in (got_xm, want_xm):
        assert ((out == allowed[0]) | (out == allowed[1])).all()
    share = equal_bits_share(got_xm, want_xm)
    print(f"residual_ln_modulate {shape} {case}: equal bits {share:.7f}")
    assert share >= 0.999


def rotate_half(y):
    half = y.shape[-1] // 2
    return torch.cat([-y[..., half:], y[..., :half]], dim=-1)


@pytest.mark.parametrize("b,l,h", [(5, 1024, 32), (1, 1024, 32), (2, 37, 32), (5, 1024, 16),
                                   (2, 37, 16)])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32], ids=["w_bf16", "w_fp32"])
def test_qk_rmsnorm_rope_kernel_matches_plain(cuda, b, l, h, w_dtype):
    """q and k in one launch: each output one of the plain RoPE's for the
    RMSNorm outputs (its own and its rotate-half partner's) rounded either
    way, the same bits as the plain chain on all but a few elements; fp32
    norm weights are the tensor-parallel form."""
    from diffusionrenderer_tpu_torch.ops.rope import rope_3d_angles

    g = torch.Generator(cuda).manual_seed(l + h)
    q, k = (torch.randn(b, l, h, 128, generator=g, device=cuda).mul(3).bfloat16()
            for _ in range(2))
    wq, wk = ((1 + 0.1 * torch.randn(128, generator=g, device=cuda)).bfloat16().to(w_dtype)
              for _ in range(2))
    grid = (1, 32, 32) if l == 1024 else (1, 1, l)
    angles = rope_3d_angles(*grid, 128, device=cuda)
    cos, sin = torch.cos(angles), torch.sin(angles)
    tdf.reset_counts()
    got = tdf.qk_rmsnorm_rope_kernel(q, k, wq, wk, cos, sin)
    torch.cuda.synchronize()
    assert tdf.LAUNCHES == {"residual_ln_modulate": 0, "qk_rmsnorm_rope": 1}
    want = tdf.qk_rmsnorm_rope_plain(q, k, wq, wk, cos, sin)
    cb = cos.bfloat16()[None, :, None, :]
    sb = sin.bfloat16()[None, :, None, :]
    for x, w, got_t, want_t in zip((q, k), (wq, wk), got, want):
        xf = x.double()
        z = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + tdf.EPS) * w.double()
        ys = rounded_both_ways(z)
        allowed = [y * cb + rotate_half(p) * sb for y in ys for p in ys]
        for out in (got_t, want_t):
            assert torch.stack([out == a for a in allowed]).any(0).all()
        share = equal_bits_share(got_t, want_t)
        print(f"qk_rmsnorm_rope {(b, l, h)} {w_dtype}: equal bits {share:.7f}")
        assert share >= 0.999


def test_fused_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(2, 8, 4096, device=cuda, dtype=torch.bfloat16)
    row = torch.zeros(2, 4096, device=cuda, dtype=torch.bfloat16)
    tdf.reset_counts()
    with pytest.raises(ValueError):  # nothing to do
        tdf.residual_ln_modulate_kernel(x, [], None, None)
    narrow = x[..., :4092].contiguous()
    with pytest.raises(ValueError):  # D % 8
        tdf.residual_ln_modulate_kernel(narrow, [], row[:, :4092].contiguous(),
                                        row[:, :4092].contiguous())
    with pytest.raises(ValueError):  # a residual of another length
        tdf.residual_ln_modulate_kernel(x, [(x[:, :3].contiguous(), row)], row, row)
    with pytest.raises(TypeError):
        tdf.residual_ln_modulate_kernel(x.float(), [], row, row)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    table = torch.zeros(8, 64, device=cuda)
    with pytest.raises(ValueError):  # head dim 64
        tdf.qk_rmsnorm_rope_kernel(q, q, q[0, 0, 0], q[0, 0, 0], table, table)
    assert sum(tdf.LAUNCHES.values()) == 0


@pytest.mark.parametrize("m", [1, 8], ids=["one_token_context", "crossattn_emb_8"])
def test_dit_forward_fused_vs_plain_chains(cuda, monkeypatch, m):
    """Two full-width blocks on the card: the fused chains against the plain
    ones (the rule pointed away from the card), to the DiT's kernel
    tolerance; 3 (4 with a general cross-attention) residual_ln_modulate
    launches a block and the final layer's, one qk_rmsnorm_rope a block."""
    cfg = DiTConfig(num_blocks=2)
    params = init_dit_params(cfg, device=cuda, dtype=torch.bfloat16, seed=0)
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(5, 1, 64, 64, 16, generator=g, device=cuda).bfloat16()
    cond = torch.randn(5, 1, 64, 64, 16, generator=g, device=cuda).bfloat16()
    sig = torch.tensor([3.0, 0.5, 80.0, 1.0, 0.1], device=cuda)
    ctx = torch.tensor([0, 1, 2, 3, 4], device=cuda)
    emb = None if m == 1 else torch.randn(5, m, cfg.crossattn_emb_channels, generator=g,
                                          device=cuda).bfloat16()

    def run():
        with torch.inference_mode():
            return dit_forward(params, x, sig, cond, ctx, cfg, crossattn_emb=emb)

    tdf.reset_counts()
    got = run()
    assert tdf.LAUNCHES == {"residual_ln_modulate": (3 if m == 1 else 4) * cfg.num_blocks + 1,
                            "qk_rmsnorm_rope": cfg.num_blocks}
    monkeypatch.setattr(tdf, "KERNEL_DEVICE", "plain chains only")
    tdf.reset_counts()
    want = run()
    assert sum(tdf.LAUNCHES.values()) == 0
    assert_close(got, want)


def test_step_graph_counts_fused_launches_per_replay(cuda):
    """inverse_render through the captured and the replayed step graph and
    eagerly: 3 x blocks + 1 residual_ln_modulate and blocks qk_rmsnorm_rope
    launches per DiT forward each time, and the same bits."""
    import numpy as np

    pipe = step_graph_pipe("bf16")
    image = np.random.default_rng(4).integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    blocks = SURFACE_NET["num_blocks"]
    outs = []
    for eager in (False, False, True):  # capture, replay, eager
        tdf.reset_counts()
        out, _, _ = render_counted(pipe, image, 0.0, eager=eager)
        assert tdf.LAUNCHES == {"residual_ln_modulate": pipe.num_steps * (3 * blocks + 1),
                                "qk_rmsnorm_rope": pipe.num_steps * blocks}, eager
        outs.append(out)
    for name in outs[0]:
        assert np.array_equal(outs[0][name], outs[1][name])
        assert np.array_equal(outs[0][name], outs[2][name])


def test_train_step_launches_no_fused_kernel(cuda):
    """The train step runs under autograd: its first (eager) step and its
    replayed ones take the plain chains, no fused launch."""
    cfg, state, step, batch_fn = tiny_train_setup(cuda)
    for i in range(3):
        tdf.reset_counts()
        state, loss = step(state, batch_fn(i), torch.Generator(cuda).manual_seed(i))
        torch.cuda.synchronize()
        assert tdf.LAUNCHES == {"residual_ln_modulate": 0, "qk_rmsnorm_rope": 0}, i
    assert len(step._graphs._graphs) == 1
