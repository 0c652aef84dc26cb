"""The port's int8 flash attention against the JAX package's.

On the CPU the port runs the int8 kernel's plain version
(`flash_attention_int8_plain`), held against JAX's
`flash_attention(qk_int8=True[, pv_int8=True], interpret=True)` in fp32 on
the same numpy inputs, at JAX's default key tiling and at explicit ones
(the kernel's own 64-key tile among them, at every head dim),
at head dims 64 to 512: P is rounded relative to the
running max of the tiles seen so far, so the result depends on the tiling
and both walk the same tiles.  The int8 codes and integer sums are exact in
both; exp2 and the fp32 sums differ by an ulp.  qk8: tolerance 2e-5.
qk8+pv8: that ulp moves an int8 P code across a .5 boundary now and then
(76 of 76,800 outputs at the worst case here, by at most 7.1e-4), so at
most 1% of the outputs may differ by more than 2e-5, none by more than
2e-3, and the relative L2 error stays below 1e-4.  Summing the rounded P
into l (instead of the unrounded p) moves most outputs by ~1e-4.

Also: the plain version at the CUDA kernel's own key tile
(`INT8_BLOCK_K[D]`) against JAX's kernel at that tile for every head dim and
mode, so that a change of a tile is checked against JAX by itself; the
dispatcher's 'pallas_pv_int8' backend, the flag precedence and defaults of
`flash_attention` against JAX's, and the transposed-V key order the
kernel's P fragment needs (the same for mma.sync's m16n8k32 and wgmma's
m64k32 8-bit A fragment), with its round trip (tests/test_torch_cuda.py
holds the CUDA kernel to this plain version)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.ops import flash_attention as jfa
from diffusionrenderer_tpu.ops.attention import attention as j_attention
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.ops.attention import attention

CASES = [(1, 256, 256, 2, 64), (2, 200, 328, 1, 128), (1, 300, 300, 2, 128),
         (1, 256, 200, 2, 256), (2, 200, 328, 1, 512)]


def make_qkv(b, lq, lk, h, d, seed):
    """DiT-like inputs: q and k with unit RMS per head, v standard normal."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    q /= np.sqrt((q * q).mean(-1, keepdims=True))
    k /= np.sqrt((k * k).mean(-1, keepdims=True))
    return q, k, v


def run_both(q, k, v, pv8, block_k):
    got = tfa.flash_attention_int8_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                         pv_int8=pv8, block_k=block_k).numpy()
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          block_k=block_k, interpret=True, qk_int8=True,
                                          pv_int8=pv8))
    return got, want


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
@pytest.mark.parametrize("pv8", [False, True], ids=["qk8", "qk8pv8"])
@pytest.mark.parametrize("block_k", [None, 32, 64, 128],
                         ids=["default", "bk32", "bk64", "bk128"])
def test_plain_matches_jax(b, lq, lk, h, d, pv8, block_k):
    q, k, v = make_qkv(b, lq, lk, h, d, seed=lq + d)
    got, want = run_both(q, k, v, pv8, block_k)
    if not pv8:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    diff = np.abs(got - want)
    assert (diff > 2e-5).mean() <= 1e-2
    assert diff.max() <= 2e-3
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("d", sorted(tfa.INT8_BLOCK_K))
@pytest.mark.parametrize("pv8", [False, True], ids=["qk8", "qk8pv8"])
def test_plain_at_the_kernel_tile_matches_jax(d, pv8):
    """Ragged lengths (neither a multiple of the tile) at the kernel's tile."""
    q, k, v = make_qkv(1, 70, 100, 2, d, seed=d + 1)
    got, want = run_both(q, k, v, pv8, tfa.INT8_BLOCK_K[d])
    if not pv8:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    diff = np.abs(got - want)
    assert (diff > 2e-5).mean() <= 1e-2
    assert diff.max() <= 2e-3
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("pv8", [False, True], ids=["qk8", "qk8pv8"])
def test_plain_at_the_kernel_tile_matches_jax_d512_ragged(pv8):
    """D = 512 (the VAE's head, the card's two-warpgroup body) at the
    kernel's tile, with Lq and Lk not multiples of it and more than two
    tiles of keys."""
    tile = tfa.INT8_BLOCK_K[512]
    q, k, v = make_qkv(2, 130, 3 * tile - 7, 1, 512, seed=512 + pv8)
    got, want = run_both(q, k, v, pv8, tile)
    if not pv8:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    diff = np.abs(got - want)
    assert (diff > 2e-5).mean() <= 1e-2
    assert diff.max() <= 2e-3
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("pv8", [False, True], ids=["qk8", "qk8pv8"])
def test_within_quantization_tolerance_of_exact(pv8):
    """The bounds of tests/test_flash_attention.py: 0.012 (qk8), 0.025 (pv8)."""
    q, k, v = make_qkv(2, 256, 256, 2, 64, seed=7)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, block_k=128, qk_int8=True, pv_int8=pv8)
    exact = tfa.flash_attention_plain(tq, tk, tv, bounded=False)
    assert (got - exact).abs().max() < (0.025 if pv8 else 0.012)


def test_pv_int8_backend_matches_jax():
    q, k, v = make_qkv(1, 300, 300, 2, 128, seed=3)
    got = attention(*(torch.from_numpy(x) for x in (q, k, v)), backend="pallas_pv_int8")
    want = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  backend="pallas_pv_int8"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_defaults_match_jax_signature():
    """The port's flash_attention takes JAX's flags with JAX's defaults, so
    a bare call picks the same kernel family (the online softmax)."""
    jsig = inspect.signature(jfa.flash_attention).parameters
    tsig = inspect.signature(tfa.flash_attention).parameters
    for name in ("block_q", "block_k", "qk_int8", "pv_int8", "bounded", "pipelined"):
        assert tsig[name].default == jsig[name].default, name
    q, k, v = make_qkv(1, 256, 256, 2, 128, seed=5)
    q = q * 40.0  # logits large enough that the online shift matters
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flag_precedence_and_refusals():
    tq, tk, tv = (torch.from_numpy(x) for x in make_qkv(1, 128, 128, 1, 128, seed=1))
    # qk_int8 under bounded=True is dropped (JAX: qk_int8 and not bounded).
    torch.testing.assert_close(tfa.flash_attention(tq, tk, tv, qk_int8=True, bounded=True),
                               tfa.flash_attention_plain(tq, tk, tv, bounded=True))
    # pv_int8 implies qk_int8.
    torch.testing.assert_close(tfa.flash_attention(tq, tk, tv, pv_int8=True),
                               tfa.flash_attention_int8_plain(tq, tk, tv, pv_int8=True))
    with pytest.raises(ValueError, match="int8"):
        tfa.flash_attention(tq, tk, tv, pv_int8=True, bounded=True)
    # bounded with pipelined is the bounded-shift softmax, and drops qk_int8 too.
    torch.testing.assert_close(
        tfa.flash_attention(tq, tk, tv, qk_int8=True, bounded=True, pipelined=True),
        tfa.flash_attention_bounded_plain(tq, tk, tv))
    # Wide heads run (the CUDA kernel takes D = 256 and 512 too), as in JAX.
    wq, wk, wv = make_qkv(1, 64, 64, 1, 256, seed=2)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (wq, wk, wv)), qk_int8=True)
    want = np.asarray(jfa.flash_attention(jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv),
                                          interpret=True, qk_int8=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.int8_operands(tq, tk, tv)


def test_transposed_v_key_order_matches_the_p_fragment():
    """Position 4*t4 + i of each 16-key half of a 32-key group holds the key
    that thread t4 packs as byte i of its P register: keys 2*t4, 2*t4+1,
    8+2*t4, 8+2*t4+1 (the s32 accumulator columns of two n8 tiles)."""
    lk = 70
    vi = torch.arange(lk, dtype=torch.int8).reshape(1, lk, 1, 1)
    vt = tfa._transpose_v_int8(vi, 128)[0, 0, 0]
    for g in range(2):
        for half in range(2):
            for t4 in range(4):
                for i in range(4):
                    key = 32 * g + 16 * half + (i // 2) * 8 + 2 * t4 + i % 2
                    assert int(vt[32 * g + 16 * half + 4 * t4 + i]) == key
    # Keys past Lk are zero; every key appears once.
    assert torch.all(vt[96:] == 0)
    assert sorted(vt[:96].tolist()) == sorted(list(range(lk)) + [0] * (96 - lk))


@pytest.mark.parametrize("lk,lk_pad", [(70, 128), (64, 64), (1, 64)])
def test_transposed_v_round_trip(lk, lk_pad):
    """Undoing the key permutation of each 32-key group gives V back, zeros
    past Lk."""
    rng = np.random.default_rng(lk)
    vi = torch.from_numpy(rng.integers(-127, 128, (2, lk, 3, 16), dtype=np.int8))
    vt = tfa._transpose_v_int8(vi, lk_pad)
    assert vt.shape == (2, 3, 16, lk_pad)
    key_of_pos = [16 * h + 8 * a + 2 * t + b for h in range(2) for t in range(4)
                  for a in range(2) for b in range(2)]
    keys = torch.tensor([32 * g + key for g in range(lk_pad // 32) for key in key_of_pos])
    back = torch.empty_like(vt)
    back[..., keys] = vt
    assert torch.equal(back[..., :lk], vi.permute(0, 2, 3, 1))
    assert torch.all(back[..., lk:] == 0)
