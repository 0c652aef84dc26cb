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
  more than fp32's range and both packages return the clamped zeros;
* in fp32's underflow band (random queries at 14x scale, overshoots of 104
  to 187 log2 units), where XLA's CPU backend flushes exp2 below 2^-126 to
  zero, as the kernels' ex2.approx.ftz does: the port flushes the same
  weights, and its plain no-shift and bounded versions equal an fp64
  evaluation with that flush.  What is left against JAX there (XLA also
  flushes subnormal products and partial sums) is an open divergence
  (ROADMAP.md section 3); rows whose overshoot is under 105 agree.

tests/test_torch_cuda.py holds kernels 6 and 7 to this plain version on the
card within the bf16 tolerance, and kernel 6 bitwise to kernel 7 at every
head dim (wgmma bodies: at 256 and 512 one schedule, with or without the
key split)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.ops import flash_attention as jfa
from diffusionrenderer_tpu.ops.attention import attention_xla as j_attention_xla
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.ops.attention import attention

CASES = [(1, 256, 256, 2, 128), (2, 200, 328, 1, 128), (1, 256, 300, 2, 64),
         (1, 256, 256, 1, 512), (1, 256, 320, 2, 256)]


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


# The underflow-band case: numpy default_rng(0) standard normals, q x 14.
BAND_SHAPE, BAND_SEED, BAND_Q_SCALE = (1, 256, 256, 2, 64), 0, 14.0


def flushed_fp64(q, k, v, shift=None):
    """The no-shift (shift None) or bounded (shift = the row bound) function
    from the port's fp32 scores on: exp2, its sum and P V in fp64, with
    weights below 2^-126 flushed to zero and l clamped at 1e-37."""
    s = tfa._scores(*(torch.from_numpy(x) for x in (q, k)))
    if shift is not None:
        s = s - shift[..., None]
    p = torch.exp2(s.double())
    p = torch.where(p < 2.0 ** -126, 0.0, p)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, torch.from_numpy(v).double())
    return (acc / p.sum(-1).clamp_min(1e-37).permute(0, 2, 1)[..., None]).numpy()


def band_qkv():
    return random_qkv(*BAND_SHAPE, seed=BAND_SEED, q_scale=BAND_Q_SCALE)


def overshoot(q, k):
    """mb_i - max_j s_ij per (b, query row, head), in log2 units."""
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    return (tfa.row_bound(tq, tk) - tfa._scores(tq, tk).amax(-1)).permute(0, 2, 1).numpy()


def noshift_band_qkv(seed=1):
    """No-shift inputs (the headroom rule holds) with rows whose every score
    lies below -126 log2 units: keys of norm 9.9 to 10 along one direction,
    queries against it with scores near -80 ("live" rows) or of -127 to -129
    ("flushed" rows), and max |v| = 2^-18, within what the rule allows at
    this bound.  Unflushed, a flushed row's weights are subnormal, its P V
    products too but not zero: it would be a weighted mean of v."""
    rng = np.random.default_rng(seed)
    b, lq, lk, h, d = 1, 128, 256, 2, 64
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    a = rng.uniform(9.9, 10.0, (b, lk, h, 1))
    k = a * u + 0.01 * rng.standard_normal((b, lk, h, d))
    # q' = q * scale * log2 e; row norms of q' 8 (live) or 12.9 (flushed).
    qn = np.where(np.arange(lq)[None, :, None, None] % 2 == 0, 8.0, 12.9)
    q = np.broadcast_to(-qn * u / (d ** -0.5 * np.log2(np.e)), (b, lq, h, d))
    v = rng.standard_normal((b, lk, h, d))
    v *= 2.0 ** -18 / np.abs(v).max()
    return tuple(x.astype(np.float32) for x in (q, k, v))


def test_band_bounded_plain_equals_flushed_fp64():
    q, k, v = band_qkv()
    over = overshoot(q, k)
    assert ((over >= 105) & (over < 135)).sum() > 100  # the case lies in the band
    got = port_both(q, k, v)
    shift = tfa.row_bound(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(got, flushed_fp64(q, k, v, shift), rtol=2e-5, atol=2e-5)


def test_band_noshift_plain_equals_flushed_fp64():
    q, k, v = noshift_band_qkv()
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    b, _, h, d = q.shape
    assert bool(tfa.use_noshift(tfa.headroom_stats_plain(tq, tk, tv), b * h, k.shape[1], d))
    s_max = tfa._scores(tq, tk).amax(-1)
    assert bool((s_max[:, :, 1::2] < -126).all()) and bool((s_max[:, :, ::2] > -81).all())
    got = tfa.flash_attention_plain(tq, tk, tv, bounded=True).numpy()
    want = flushed_fp64(q, k, v)
    assert np.all(got[:, 1::2] == 0) and np.abs(want[:, ::2]).min(axis=-1).max() > 0
    # Outputs are of the size of v (2^-18): compared relative to max |v|.
    scale = np.abs(v).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-5, atol=2e-5)


def test_band_rows_under_105_match_jax():
    """The q x 14 case against JAX: every row whose bound overshoots its
    true max by less than 105 log2 units agrees at 2e-5.  Past that, XLA's
    flushed products and partial sums move JAX's rows (ROADMAP.md section 3)."""
    q, k, v = band_qkv()
    over = overshoot(q, k)
    rows = over < 105
    assert rows.any()
    np.testing.assert_allclose(port_both(q, k, v)[rows], jax_pipelined(q, k, v)[rows],
                               rtol=2e-5, atol=2e-5)
