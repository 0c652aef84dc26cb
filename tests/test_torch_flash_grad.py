"""The flash attention's gradient (ops/flash_attention.FlashAttentionFunction:
kernel 3's forward, here its plain version on CPU tensors, and the plain
chunked backward) against autograd of the port's attention_xla and against
jax.grad of the JAX package's attention_xla, in fp32, at head dims 64 and
128 with Lq != Lk and lengths that fill no tile.  Tolerance 2e-5 of the
largest gradient element: fp32 sums over at most 300 keys in another order.

Ring attention's gradient on one rank (an in-process gloo group of one):
RingAttentionFunction's backward is flash_attention_backward_plain's on
the ring's out, m and l, bit for bit (one hop: its fp32 sums start at zero);
'xla' and 'flash' give the Function's gradients to TOL; grad_dtype=fp32
returns the same values before the cast.  The multi-rank rings are held
to jax.grad in tests/test_torch_parallel.py.

Also: the routes under autograd (the Function whatever `bounded` says, the
dispatcher's 'pallas' / 'pallas_onlinemax' / 'auto'), the refusals of the
routes that have no gradient, and that inference under no_grad keeps its
route and values."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffusionrenderer_tpu.ops.attention import attention_xla as j_attention_xla
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.ops.attention import attention, attention_xla
from diffusionrenderer_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                                  ring_attention_local)

TOL = 2e-5

CASES = [  # (b, lq, lk, h, d)
    (2, 77, 130, 2, 64),
    (1, 130, 77, 3, 128),
    (1, 300, 300, 2, 64),
]


def inputs(b, lq, lk, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    return q, k, v, do


def port_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def jax_grads(q, k, v, do):
    _, vjp = jax.vjp(j_attention_xla, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def assert_grads_close(got, want):
    for name, g, w in zip("qkv", got, want):
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= TOL * scale, f"d{name}: max err {err:.3g} vs max {scale:.3g}"


@pytest.mark.parametrize("b,lq,lk,h,d", CASES)
@pytest.mark.parametrize("bounded", [False, True])
def test_function_grads_match_autograd_and_jax(b, lq, lk, h, d, bounded):
    q, k, v, do = inputs(b, lq, lk, h, d, seed=lq + lk + d)
    out, got = port_grads(lambda *t: tfa.flash_attention(*t, bounded=bounded), q, k, v, do)
    want_out, want = port_grads(attention_xla, q, k, v, do)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    assert_grads_close(got, want)
    assert_grads_close(got, jax_grads(q, k, v, do))


@pytest.mark.parametrize("chunk", [130 * 77, 77 * 40 + 5, 77])
def test_backward_chunks_agree(chunk):
    """Head groups (chunk >= one head's scores), query blocks of a few rows
    and of one row give the unchunked gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs(1, 130, 77, 3, 128, seed=4))
    out, m, l = tfa.flash_attention_partial_plain(q, k, v)
    whole = tfa.flash_attention_backward_plain(q, k, v, out, m, l, do)
    parts = tfa.flash_attention_backward_plain(q, k, v, out, m, l, do, max_chunk_elems=chunk)
    for a, b in zip(parts, whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_backward_grad_dtype_is_fp32_before_the_cast():
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in inputs(1, 70, 90, 2, 64, seed=6))
    out, m, l = tfa.flash_attention_partial_plain(q, k, v)
    f32 = tfa.flash_attention_backward_plain(q, k, v, out, m, l, do, grad_dtype=torch.float32)
    same = tfa.flash_attention_backward_plain(q, k, v, out, m, l, do)
    for a, b in zip(f32, same):
        assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
        assert torch.equal(a.bfloat16(), b)


@pytest.fixture(scope="module")
def one_rank_mesh():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed("cpu", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield make_mesh(1, data=1, seq=1, tensor=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_function_on_one_rank_is_the_plain_backward(one_rank_mesh, dtype):
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in inputs(2, 96, 96, 2, 64, seed=7))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention_local(*ts, one_rank_mesh, impl="flash")
    assert type(out.grad_fn).__name__ == "RingAttentionFunctionBackward"
    out.backward(do)
    _, m, l = tfa.flash_attention_partial_plain(q, k, v)
    want = tfa.flash_attention_backward_plain(q, k, v, out.detach(), m, l, do)
    for t, w in zip(ts, want):
        assert t.grad.dtype == dtype and torch.equal(t.grad, w)


def test_ring_impls_on_one_rank_match_the_function(one_rank_mesh):
    q, k, v, do = inputs(1, 80, 80, 3, 64, seed=8)
    out, got = port_grads(lambda *t: ring_attention_local(*t, one_rank_mesh, impl="flash"),
                          q, k, v, do)
    want_out, want = port_grads(tfa.FlashAttentionFunction.apply, q, k, v, do)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    assert_grads_close(got, want)
    for impl in ("xla", "auto"):  # 'auto' on CPU tensors is 'xla', plain autograd
        _, xla = port_grads(lambda *t: ring_attention_local(*t, one_rank_mesh, impl=impl),
                            q, k, v, do)
        assert_grads_close(xla, want)


@pytest.mark.parametrize("backend", ["pallas", "pallas_onlinemax"])
def test_dispatcher_takes_the_function_under_grad(backend):
    q, k, v, do = inputs(1, 64, 64, 2, 64, seed=1)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attention(*ts, backend=backend)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    _, got = port_grads(lambda *t: attention(*t, backend=backend), q, k, v, do)
    assert_grads_close(got, jax_grads(q, k, v, do))


def test_inference_keeps_its_route():
    """Under no_grad (and with no input requiring grad) the bounded call is
    the plain no-shift / online version, bit for bit as before."""
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 100, 90, 2, 64, seed=2)[:3])
    want = tfa.flash_attention_plain(q, k, v, bounded=True)
    assert torch.equal(tfa.flash_attention(q, k, v, bounded=True), want)
    with torch.no_grad():
        qg = q.clone().requires_grad_(True)
        out = tfa.flash_attention(qg, k, v, bounded=True)
    assert out.grad_fn is None and torch.equal(out, want)


@pytest.mark.parametrize("route", [
    lambda q, k, v: tfa.flash_attention(q, k, v, qk_int8=True),
    lambda q, k, v: tfa.flash_attention(q, k, v, pv_int8=True),
    lambda q, k, v: tfa.flash_attention(q, k, v, bounded=True, pipelined=True),
    lambda q, k, v: tfa.flash_attention_bounded_shift(q, k, v),
    lambda q, k, v: tfa.flash_attention_partial(q, k, v),
    lambda q, k, v: attention(q, k, v, backend="pallas_pv_int8"),
], ids=["qk_int8", "pv_int8", "bounded_pipelined", "bounded_shift", "partial", "pv_int8_backend"])
def test_routes_without_a_gradient_refuse(route):
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 64, 64, 2, 64, seed=3)[:3])
    with pytest.raises(RuntimeError, match="has no gradient"):
        route(q, k.requires_grad_(True), v)
    with torch.no_grad():  # the same route for inference
        out = route(q, k, v)
    assert (out[0] if isinstance(out, tuple) else out).shape == q.shape
