"""The port's flash attention against the JAX package's.

On the CPU the port runs the kernels' plain version; it is held against
JAX's `flash_attention(bounded=True)` in Pallas interpret mode and against
`attention_xla`, for both branches, at the DiT's D=128 (even and ragged
lengths) and the VAE's D=512.  The branch the port picks must be the one
JAX's headroom rule picks (tests/test_torch_cuda.py holds the CUDA kernels
against this plain version on the card).  Tolerances: 2e-5 in the no-shift
branch and at unit-scale logits (fp32, differently ordered sums),
1e-4 * sqrt(d/128) with logits of a few thousand log2 units (1e-4 at d=128
as in tests/test_flash_attention.py); in bf16, see
test_bf16_rounding_points_match_jax."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.ops import flash_attention as jfa
from diffusionrenderer_tpu.ops.attention import attention_xla as j_attention_xla
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.ops.attention import attention, attention_xla

CASES = [(1, 256, 256, 2, 128), (1, 300, 300, 2, 128), (1, 256, 256, 1, 512),
         (2, 200, 328, 1, 128)]


def make_qkv(b, lq, lk, h, d, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32) * q_scale
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    return q, k, v


def port_noshift(q, k, v):
    b, _, h, d = q.shape
    stats = tfa.headroom_stats_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    return bool(tfa.use_noshift(stats, b * h, k.shape[1], d))


def jax_noshift(q, k, v, monkeypatch):
    """The branch JAX's _bounded_cond_call takes, read off its lax.cond."""
    seen = []

    def cond(pred, true_fn, false_fn):
        seen.append(bool(pred))
        return true_fn() if pred else false_fn()

    monkeypatch.setattr(jax.lax, "cond", cond)
    jfa._flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, True,
                    False, bounded=True)
    monkeypatch.undo()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
def test_noshift_branch_matches_jax(b, lq, lk, h, d):
    q, k, v = make_qkv(b, lq, lk, h, d, seed=lq + d)
    assert port_noshift(q, k, v)
    got = tfa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True, bounded=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(j_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
def test_online_branch_large_logits_matches_jax(b, lq, lk, h, d):
    # Logits of a few thousand log2 units whatever d (they grow as sqrt(d)).
    q, k, v = make_qkv(b, lq, lk, h, d, seed=lq + d + 1, q_scale=100.0 * math.sqrt(128 / d))
    assert not port_noshift(q, k, v)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk, tv).numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True, bounded=True))
    # 1e-4 at d=128 as in tests/test_flash_attention.py; a d=512 logit sums
    # four times the terms, so its fp32 rounding (and exp2's) is twice as large.
    tol = 1e-4 * math.sqrt(d / 128)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # 'pallas_onlinemax' forces the online branch whatever the headroom.
    np.testing.assert_allclose(
        attention(tq, tk, tv, backend="pallas_onlinemax").numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [128, 512])
def test_branch_choice_follows_jax_headroom_rule(d, monkeypatch):
    seen = set()
    for i, scale in enumerate([1.0, 3.0, 4.0, 4.5, 5.0, 6.0, 100.0]):
        q, k, v = make_qkv(1, 256, 256, 1, d, seed=i, q_scale=scale)
        ours = port_noshift(q, k, v)
        assert ours == jax_noshift(q, k, v, monkeypatch), f"scale {scale}"
        seen.add(ours)
    assert seen == {True, False}


@pytest.mark.parametrize("lk,d", [(256, 128), (300, 128), (1000, 512), (5000, 128)])
def test_reference_lk_pad_matches_jax_tiling(lk, d):
    block_k = min(jfa.DEFAULT_BLOCK_K, jfa._round_up(lk, 128))
    if d > 128:
        block_k = min(block_k, 512)
    block_k = min(block_k, jfa._round_up(-(-lk // -(-lk // block_k)), 128))
    assert tfa.reference_lk_pad(lk, d) == jfa._round_up(lk, block_k)


def test_bf16_rounding_points_match_jax():
    """With the same rounding points (q' rounded to bf16, P cast to bf16
    before PV) the bf16 outputs are bit-equal but for a few elements one ulp
    apart (differently ordered fp32 sums).  Moving either rounding point
    makes about half the elements differ by an ulp (relative L2 ~3e-3), so
    the limits are: at most 1% of elements differ, by at most 2^-8 of the
    output's max, with a relative L2 error below 5e-4."""
    q, k, v = make_qkv(1, 256, 256, 2, 128, seed=11)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk, tv).float().numpy()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jfa.flash_attention(jq, jk, jv, interpret=True, bounded=True),
                      np.float32)
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 1e-2
    assert diff.max() <= 2.0 ** -8 * np.abs(want).max()
    assert np.linalg.norm(got - want) <= 5e-4 * np.linalg.norm(want)


def test_dispatcher_routing_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 300, 300, 2, 128, seed=3))
    xla = attention_xla(q, k, v)
    torch.testing.assert_close(attention(q, k, v), xla)  # 'auto' on the CPU
    torch.testing.assert_close(attention(q, k, v, backend="pallas"), xla,
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(NotImplementedError, match="queue 2, item 5"):
        attention(q, k, v, backend="pallas_pv_int8")
    with pytest.raises(ValueError):
        attention(q, k, v, backend="triton")


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 64, 64, 1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_kernel(q, k, v, None)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_headroom(q, k, v)
