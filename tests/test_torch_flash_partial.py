"""The port's partial-stats flash attention (the ring's inner block) against
the JAX package's.

On the CPU `flash_attention_partial` runs its plain version; its out, m and
l are held against JAX's `flash_attention_partial` in Pallas interpret mode
at D in {64, 128, 256, 512}, even and ragged lengths, fewer keys than one
tile, in fp32 at 2e-5 (relative for l and m, whose size grows with Lk and
the logits): exact softmax statistics, summed in another order.  Merging
the partial states of n key shards with the ring's `_merge` must give
`attention_xla` of the whole key set, at the same tolerance, at every head
dim; so must the two shards of the card's key split at D = 256 and 512
(cut after ceil(nk / 2) key tiles of 64 or 32 keys), whose merge is the
same combine, each shard also held to JAX's kernel.  tests/test_torch_cuda.py
holds kernel 3 to this plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.ops import flash_attention as jfa
from diffusionrenderer_tpu.ops.attention import attention_xla as j_attention_xla
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.parallel.ring_attention import _merge, _partial_attn_flash

# Even and ragged lengths; then the edges of the card's kernel 3 (128 query
# rows and 128 keys a block at D <= 128; 64 rows and 64 or 32 keys a block at
# D = 256, 512): Lq not a multiple of 128, fewer keys than one tile, Lk not
# a multiple of 128 with B * H > 1, D = 256 even and ragged, and D = 512
# ragged with more than two 32-key tiles.
CASES = [(1, 256, 256, 2, 128), (2, 200, 328, 1, 128), (1, 256, 300, 2, 64),
         (2, 130, 97, 3, 64), (1, 100, 40, 2, 128), (3, 77, 129, 2, 64),
         (1, 64, 100, 1, 512), (1, 128, 128, 2, 256), (2, 100, 200, 1, 256),
         (1, 70, 97, 1, 512)]


def make_qkv(b, lq, lk, h, d, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32) * q_scale
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
@pytest.mark.parametrize("q_scale", [1.0, 4.0])
def test_partial_matches_jax(b, lq, lk, h, d, q_scale):
    q, k, v = make_qkv(b, lq, lk, h, d, seed=lq + lk + d, q_scale=q_scale)
    out, m, l = (x.numpy() for x in tfa.flash_attention_partial(
        *(torch.from_numpy(x) for x in (q, k, v))))
    j_out, j_m, j_l = (np.asarray(x) for x in jfa.flash_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    assert out.shape == (b, lq, h, d) and m.shape == l.shape == (b, h, lq)
    assert m.dtype == l.dtype == np.float32
    np.testing.assert_allclose(out, j_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m, j_m, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l, j_l, rtol=2e-5, atol=2e-5)


def test_partial_stats_are_the_online_softmax_state():
    """m is the row max of the log2-domain scores and l the sum of
    exp2(s - m), not clamped: a row of one key has l == 1 exactly."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 40, 1, 2, 64, seed=3))
    out, m, l = tfa.flash_attention_partial(q, k, v)
    torch.testing.assert_close(l, torch.ones_like(l), rtol=0, atol=0)
    s = torch.einsum("bqhd,bkhd->bhqk", tfa.q_prescale(q), k)[..., 0]
    torch.testing.assert_close(m, s, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out, v.expand(1, 40, 2, 64), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_merge_of_key_shards_equals_exact_attention(shards, d):
    q, k, v = make_qkv(2, 96, 250, 2, d, seed=shards + d, q_scale=3.0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    bounds = np.linspace(0, 250, shards + 1).astype(int)  # ragged shards
    state = None
    for a, z in zip(bounds[:-1], bounds[1:]):
        part = _partial_attn_flash(tq, tk[:, a:z], tv[:, a:z])
        state = part if state is None else _merge(state, part)
    _, l, o = state
    got = (o / l.permute(0, 2, 1)[..., None]).numpy()
    want = np.asarray(j_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d,lk", [(256, 193), (512, 97), (256, 129), (512, 65)])
def test_merge_at_the_key_split_point_equals_exact_attention(d, lk):
    """The two shards of the card's split: the first ceil(nk / 2) key tiles
    and the rest; Lk = k * BK + 1, so the second shard's last tile holds one
    key (at Lk = 129 and 65 the second shard is that one key, shorter than a
    tile).  Each shard's out, m and l against JAX's kernel, their merge
    against exact attention."""
    q, k, v = make_qkv(1, 70, lk, 2, d, seed=lk + d, q_scale=3.0)
    bk = tfa.WIDE_BLOCK_K[d]  # the card's key split cuts between these tiles
    nk = -(-lk // bk)
    cut = -(-nk // 2) * bk  # the second block's first key
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    state = None
    for a, z in ((0, cut), (cut, lk)):
        part = _partial_attn_flash(tq, tk[:, a:z], tv[:, a:z])
        m, l, _ = part
        out, _, _ = tfa.flash_attention_partial(tq, tk[:, a:z], tv[:, a:z])
        j_out, j_m, j_l = (np.asarray(x) for x in jfa.flash_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, a:z]), jnp.asarray(v[:, a:z]), interpret=True))
        np.testing.assert_allclose(out.numpy(), j_out, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(m.numpy(), j_m, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(l.numpy(), j_l, rtol=2e-5, atol=2e-5)
        state = part if state is None else _merge(state, part)
    _, l, o = state
    got = (o / l.permute(0, 2, 1)[..., None]).numpy()
    want = np.asarray(j_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_partial_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 64, 64, 1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_partial_kernel(q, k, v)
