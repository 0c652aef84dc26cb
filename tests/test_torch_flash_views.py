"""Strided views through every public attention route of the port.

JAX's attention functions take any array, and the port's routes take any
strided view of (B, L, H, D) q, k and v: on the CPU the plain versions read
through the strides, on CUDA the routes copy a view to a contiguous,
16-byte-aligned tensor before the launch (tests/test_torch_cuda.py runs one
transposed view per route on the card).  Here, in fp32 on the CPU, each
route on a transposed, a sliced and a head-strided view is held to the same
route on contiguous inputs and to the JAX package's counterpart (Pallas
interpret mode) at 2e-5.  The int8 P of pv_int8 rounds at .5 ties that
torch and XLA can break apart, so that route is held to JAX with
tests/test_torch_flash_int8.py's bounds for it."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.ops import flash_attention as jfa
from diffusionrenderer_tpu.ops.attention import attention as j_attention
from diffusionrenderer_tpu_torch.ops import flash_attention as tfa
from diffusionrenderer_tpu_torch.ops.attention import attention

B, LQ, LK, H, D = 2, 130, 200, 2, 64


def _jax_flash(**kw):
    return lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True, **kw)


def _port_attention(backend):
    return lambda q, k, v: attention(q, k, v, backend=backend)


def _jax_attention(backend):
    return lambda q, k, v: j_attention(q, k, v, backend=backend)


# route -> (port function, JAX function)
ROUTES = {
    "online": (tfa.flash_attention, _jax_flash()),
    "bounded": (functools.partial(tfa.flash_attention, bounded=True), _jax_flash(bounded=True)),
    "bounded_pipelined": (functools.partial(tfa.flash_attention, bounded=True, pipelined=True),
                          _jax_flash(bounded=True, pipelined=True)),
    "bounded_shift": (tfa.flash_attention_bounded_shift, _jax_flash(bounded=True, pipelined=True)),
    "qk_int8": (functools.partial(tfa.flash_attention, qk_int8=True), _jax_flash(qk_int8=True)),
    "pv_int8": (functools.partial(tfa.flash_attention, pv_int8=True), _jax_flash(pv_int8=True)),
    "partial": (tfa.flash_attention_partial,
                lambda q, k, v: jfa.flash_attention_partial(q, k, v, interpret=True)),
    **{f"attention_{b}": (_port_attention(b), _jax_attention(b))
       for b in ("auto", "xla", "pallas", "pallas_onlinemax", "pallas_pv_int8")},
}


def inputs():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, LQ, H, D)).astype(np.float32) * 2.0
    k = rng.standard_normal((B, LK, H, D)).astype(np.float32)
    v = rng.standard_normal((B, LK, H, D)).astype(np.float32)
    return q, k, v


def as_view(x: np.ndarray, kind: str) -> torch.Tensor:
    """A non-contiguous torch view whose values are x (B, L, H, D)."""
    t = torch.from_numpy(x)
    if kind == "transposed":  # stored (B, H, L, D)
        view = t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    elif kind == "sliced":  # rows of a wider head dim, at an offset
        wide = torch.zeros(*x.shape[:3], x.shape[3] + 24)
        wide[..., 8:8 + x.shape[3]] = t
        view = wide[..., 8:8 + x.shape[3]]
    else:  # every other head of twice as many
        wide = torch.zeros(x.shape[0], x.shape[1], 2 * x.shape[2], x.shape[3])
        wide[:, :, ::2] = t
        view = wide[:, :, ::2]
    assert not view.is_contiguous() and torch.equal(view, t)
    return view


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@functools.lru_cache(maxsize=None)
def contiguous_result(route):
    return tuple(r.numpy() for r in _tuple(ROUTES[route][0](
        *(torch.from_numpy(x) for x in inputs()))))


@functools.lru_cache(maxsize=None)
def jax_result(route):
    return tuple(np.asarray(r) for r in _tuple(ROUTES[route][1](
        *(jnp.asarray(x) for x in inputs()))))


@pytest.mark.parametrize("kind", ["transposed", "sliced", "head_strided"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_view_matches_contiguous_and_jax(route, kind):
    got = tuple(r.numpy() for r in _tuple(ROUTES[route][0](*(as_view(x, kind) for x in inputs()))))
    want = contiguous_result(route)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    for g, j in zip(got, jax_result(route)):
        if route.endswith("pv_int8"):
            diff = np.abs(g - j)
            assert (diff > 2e-5).mean() <= 1e-2 and diff.max() <= 2e-3
            assert np.linalg.norm(g - j) <= 1e-4 * np.linalg.norm(j)
        else:
            np.testing.assert_allclose(g, j, rtol=2e-5, atol=2e-5)
