"""The port's bounded-shift flash attention against the JAX package's
`flash_attention(bounded=True, pipelined=True)`.

The bounded softmax shifts each row by the Cauchy-Schwarz bound mb_i =
||q'_i|| * max_j ||k_j|| instead of a running max.  On the CPU the port runs
its plain version (`flash_attention_bounded_plain`, reached through
`flash_attention(bounded=True, pipelined=True)` and
`flash_attention_bounded_shift`); it is held against JAX in Pallas interpret
mode in fp32 at 2e-5:

* inside the envelope (unit-scale inputs), where every shift gives the same
  softmax;
* outside it, where the shift matters: queries aligned with a key at 15x
  scale (scores of 170 to 490 log2 units: the unshifted exp2 would
  overflow, the bounded one stays exact and equals attention_xla), and
  random queries at 100x scale, where the bound overshoots the true max by
  more than fp32's range and both packages return the clamped zeros.

tests/test_torch_cuda.py holds kernels 6 and 7 to this plain version on the
card, and kernel 6 bitwise to kernel 7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.ops import flash_attention as jfa
from diffusionrenderer_tpu.ops.attention import attention_xla as j_attention_xla
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.ops.attention import attention

CASES = [(1, 256, 256, 2, 128), (2, 200, 328, 1, 128), (1, 256, 300, 2, 64),
         (1, 256, 256, 1, 512)]


def random_qkv(b, lq, lk, h, d, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32) * q_scale
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    return q, k, v


def aligned_qkv(b, lq, lk, h, d, seed=0, q_scale=15.0):
    """RMS-normed keys; each query q_scale times a key plus 5% noise."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, lk, h, d))
    k /= np.sqrt((k * k).mean(-1, keepdims=True))
    q = q_scale * (k[:, rng.integers(0, lk, lq)] + 0.05 * rng.standard_normal((b, lq, h, d)))
    v = rng.standard_normal((b, lk, h, d))
    return tuple(x.astype(np.float32) for x in (q, k, v))


def jax_pipelined(q, k, v):
    return np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True, bounded=True, pipelined=True))


def port_both(q, k, v):
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    pipe = tfa.flash_attention(tq, tk, tv, bounded=True, pipelined=True).numpy()
    shift = tfa.flash_attention_bounded_shift(tq, tk, tv).numpy()
    np.testing.assert_array_equal(pipe, shift)  # one function, two kernels on the card
    return pipe


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
def test_bounded_inside_envelope_matches_jax(b, lq, lk, h, d):
    q, k, v = random_qkv(b, lq, lk, h, d, seed=lq + lk + d)
    got = port_both(q, k, v)
    np.testing.assert_allclose(got, jax_pipelined(q, k, v), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
def test_bounded_shift_matters_outside_envelope(b, lq, lk, h, d):
    q, k, v = aligned_qkv(b, lq, lk, h, d, seed=lq + d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    mb = tfa.row_bound(tq, tk)
    # Far outside the no-shift envelope: unshifted, exp2 of the scores
    # overflows fp32, so the headroom rule would take the online kernel.
    assert float(mb.max()) > 128
    assert not bool(tfa.use_noshift(tfa.headroom_stats_plain(tq, tk, tv), b * h, lk, d))
    got = port_both(q, k, v)
    np.testing.assert_allclose(got, jax_pipelined(q, k, v), rtol=2e-5, atol=2e-5)
    exact = np.asarray(j_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, exact, rtol=2e-5, atol=2e-5)


def test_bound_overshoot_past_fp32_gives_zeros_as_in_jax():
    q, k, v = random_qkv(1, 256, 256, 2, 128, seed=7, q_scale=100.0)
    got = port_both(q, k, v)
    want = jax_pipelined(q, k, v)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.all(np.isfinite(got)) and (np.abs(got).max(axis=-1) == 0).mean() > 0.5


def test_row_bound_bounds_every_score():
    q, k, _ = (torch.from_numpy(x) for x in random_qkv(2, 100, 130, 3, 64, seed=2, q_scale=3.0))
    mb = tfa.row_bound(q, k)
    s = torch.einsum("bqhd,bkhd->bhqk", tfa.q_prescale(q), k)
    assert mb.shape == (2, 3, 100) and mb.dtype == torch.float32
    assert bool((s.amax(-1) <= mb * (1 + 1e-6)).all())


def test_routes_stay_as_in_jax():
    """pipelined alone is ignored; attention()'s routes never reach the
    bounded-shift kernels (backend='pallas' is the headroom-checked pair)."""
    q, k, v = (torch.from_numpy(x) for x in random_qkv(1, 128, 128, 2, 64, seed=4))
    torch.testing.assert_close(tfa.flash_attention(q, k, v, pipelined=True),
                               tfa.flash_attention(q, k, v))
    torch.testing.assert_close(attention(q, k, v, backend="pallas"),
                               tfa.flash_attention_plain(q, k, v))
    with pytest.raises(ValueError, match="int8"):
        tfa.flash_attention(q, k, v, bounded=True, pipelined=True, pv_int8=True)


def test_bounded_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in random_qkv(1, 64, 64, 1, 128))
    for pipelined in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_bounded_kernel(q, k, v, tfa.row_bound(q, k), pipelined=pipelined)
