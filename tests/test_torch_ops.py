"""The port's DiT ops and EDM sampler against the JAX package, in fp32, on
the same numpy inputs.  Tolerance: 1e-5 relative / 1e-5 absolute unless a
test says otherwise (fp32 with differently ordered sums and transcendental
implementations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.models.dit import _apply_rope_cached as j_apply_rope
from diffusionrenderer_tpu.ops.attention import cross_attention_single_kv as j_single_kv
from diffusionrenderer_tpu.ops import norms as jn
from diffusionrenderer_tpu.ops import patch as jp
from diffusionrenderer_tpu.ops import rope as jr
from diffusionrenderer_tpu.ops import timestep as jt
from diffusionrenderer_tpu.sampling import edm as je
from diffusionrenderer_tpu_torch.ops import norms as tn
from diffusionrenderer_tpu_torch.ops.attention import cross_attention_single_kv as t_single_kv
from diffusionrenderer_tpu_torch.ops import patch as tp
from diffusionrenderer_tpu_torch.ops import rope as tr
from diffusionrenderer_tpu_torch.ops import timestep as tt
from diffusionrenderer_tpu_torch.sampling import edm as te

TOL = dict(rtol=1e-5, atol=1e-5)


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(t_out, j_out, **tol):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **(tol or TOL))


T = torch.from_numpy
J = jnp.asarray


def test_rms_and_layer_norm():
    x, w = rand(2, 7, 32), rand(32, seed=1)
    close(tn.rms_norm(T(x), T(w)), jn.rms_norm(J(x), J(w)))
    close(tn.layer_norm_no_affine(T(x)), jn.layer_norm_no_affine(J(x)))


def test_modulate_and_adaln():
    x, shift, scale = rand(2, 5, 16), rand(2, 16, seed=1), rand(2, 16, seed=2)
    close(tn.modulate(T(x), T(shift), T(scale)), jn.modulate(J(x), J(shift), J(scale)))
    emb, w1, w2, lora = rand(2, 16), rand(16, 4, seed=3), rand(4, 48, seed=4), rand(2, 48, seed=5)
    close(tn.adaln_modulation(T(emb), T(w1.T.copy()), T(w2.T.copy()), T(lora)),
          jn.adaln_modulation(J(emb), J(w1), J(w2), J(lora)))


@pytest.mark.parametrize("thw,head_dim", [((1, 4, 6), 48), ((3, 8, 8), 128), ((2, 2, 4), 64)])
def test_rope_angles_and_apply(thw, head_dim):
    t, h, w = thw
    kw = dict(h_ntk_factor=1.0, w_ntk_factor=1.5, t_ntk_factor=2.0)
    ta, ja = tr.rope_3d_angles(t, h, w, head_dim, **kw), jr.rope_3d_angles(t, h, w, head_dim, **kw)
    assert ta.shape == (t * h * w, head_dim) and ta.dtype == torch.float32
    close(ta, ja, rtol=1e-6, atol=1e-5)
    x = rand(2, t * h * w, 3, head_dim)
    cos, sin = np.cos(np.asarray(ja)), np.sin(np.asarray(ja))
    close(tr.apply_rope(T(x), T(cos), T(sin)), j_apply_rope(J(x), J(cos), J(sin)))


def test_rope_split():
    assert tr._rope_dims(128) == jr._rope_dims(128) == (44, 42, 42)


def test_patchify_unpatchify_and_embed():
    x = rand(2, 2, 4, 6, 5)
    close(tp.patchify(T(x), 2, 1), jp.patchify(J(x), 2, 1))
    y = rand(2, 2 * 2 * 3, 2 * 2 * 1 * 5)
    close(tp.unpatchify(T(y), 2, 2, 3, 2, 1, 5), jp.unpatchify(J(y), 2, 2, 3, 2, 1, 5))
    w, b = rand(20, 8, seed=1), rand(8, seed=2)
    close(tp.patch_embed(T(x), T(w.T.copy()), T(b), 2, 1), jp.patch_embed(J(x), J(w), J(b), 2, 1))


def test_timestep_embedding():
    sig = np.array([80.0, 3.1, 0.02], np.float32)
    close(tt.sinusoidal_embedding(T(sig), 64), jt.sinusoidal_embedding(J(sig), 64), atol=2e-5)
    w1, w2 = rand(64, 64, seed=1) * 0.1, rand(64, 192, seed=2) * 0.1
    t_main, t_lora = tt.timestep_embedding(T(sig), T(w1.T.copy()), T(w2.T.copy()), 64)
    j_main, j_lora = jt.timestep_embedding(J(sig), J(w1), J(w2), 64)
    close(t_main, j_main, atol=2e-5)
    close(t_lora, j_lora, atol=5e-5)


@pytest.mark.parametrize("steps", [1, 15, 35])
def test_edm_sigma_table(steps):
    np.testing.assert_array_equal(te.edm_sigmas(steps).numpy(), np.asarray(je.edm_sigmas(steps)))


def test_scale_and_euler_step():
    x, f = rand(2, 3, 4, 4, 16), rand(2, 3, 4, 4, 16, seed=1)
    for s, s_next in ((80.0, 50.1), (0.3, 0.02), (0.02, 0.0)):
        close(te.scale_model_input(T(x), torch.tensor(s)), je.scale_model_input(J(x), s))
        close(te.edm_step(T(f), torch.tensor(s), torch.tensor(s_next), T(x)),
              je.edm_step(J(f), s, s_next, J(x)), rtol=1e-5, atol=1e-4)


def test_sample_edm_trajectory():
    """The Euler loop against the JAX scan, with the same linear denoiser."""
    x0 = rand(1, 1, 2, 2, 4) * 80.0
    sig = te.edm_sigmas(6)
    got = te.sample_edm(lambda x, s: 0.3 * x + s * 0.01, T(x0), sig)
    want = je.sample_edm(lambda x, s: 0.3 * x + s * 0.01, J(x0), je.edm_sigmas(6))
    close(got, want, rtol=1e-5, atol=1e-4)


def test_cross_attention_single_kv():
    context, wv = rand(3, 1, 16), rand(16, 64, seed=1)
    got = t_single_kv(T(context), None, T(wv.T.copy()), 4)
    assert got.shape == (3, 1, 4, 16)
    close(got, j_single_kv(J(context), None, J(wv), 4))
