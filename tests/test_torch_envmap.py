"""The port's envmap preprocessing and resampling against the JAX package's.

The same numpy inputs go through diffusionrenderer_tpu.envmap / ops.resample
and their counterparts in the port, on the CPU in float32.  Tolerance 1e-5
(absolute and relative): both sides compute the same float32 expressions;
sin, atan2, arccos and linspace may differ by an ulp between XLA and torch,
which moves a sample coordinate by ~1e-7 of the image size, so the images
here are small enough (<= 64 texels across) that this stays below 1e-5 of
a texel-to-texel difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu import envmap as jenv
from diffusionrenderer_tpu.ops import resample as jres
from diffusionrenderer_tpu_torch import envmap as tenv
from diffusionrenderer_tpu_torch.ops import resample as tres
from diffusionrenderer_tpu_torch.utils.cache import LRUCache

TOL = dict(rtol=1e-5, atol=1e-5)


def hdr(*shape, seed=0, scale=100.0):
    """HDR-range content: |N(0, 1)| * scale, a few values far above it."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32) * scale
    x.reshape(-1)[::97] *= 20.0
    return x


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def j(x):
    return np.asarray(x)


def test_tonemaps_match_jax():
    x = hdr(8, 12, 3, seed=1)
    x[0, 0] = [0.0, 1e-4, 0.003]  # the linear segment of the sRGB curve
    np.testing.assert_allclose(tenv.rgb_to_srgb(t(x / 200.0)).numpy(),
                               j(jenv.rgb_to_srgb(jnp.asarray(x / 200.0))), **TOL)
    np.testing.assert_allclose(tenv.reinhard(t(x)).numpy(), j(jenv.reinhard(jnp.asarray(x))),
                               **TOL)
    got, want = tenv.hdr_tonemaps(t(x)), jenv.hdr_tonemaps(jnp.asarray(x))
    for key in ("env_ldr", "env_log"):
        np.testing.assert_allclose(got[key].numpy(), j(want[key]), **TOL)


def test_direction_fields_match_jax():
    np.testing.assert_allclose(tenv.latlong_vec(12, 20, "cpu").numpy(),
                               j(jenv.latlong_vec(12, 20)), **TOL)
    for face in range(6):
        d = tenv._cube_face_dirs(face, 8, "cpu")
        np.testing.assert_allclose(d.numpy(), j(jenv._cube_face_dirs(face, 8)), **TOL)
        np.testing.assert_allclose(tenv._dirs_to_equirect_grid(d).numpy(),
                                   j(jenv._dirs_to_equirect_grid(jnp.asarray(d.numpy()))),
                                   **TOL)


def test_grid_sample_and_resize_match_jax():
    img = hdr(9, 13, 3, seed=2, scale=3.0)
    grid = np.random.default_rng(3).uniform(-1.2, 1.2, (5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(tres.grid_sample_bilinear(t(img), t(grid)).numpy(),
                               j(jres.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid))),
                               **TOL)
    for oh, ow in ((5, 21), (18, 26), (9, 13)):
        np.testing.assert_allclose(tres.resize_bilinear(t(img), oh, ow).numpy(),
                                   j(jres.resize_bilinear(jnp.asarray(img), oh, ow)), **TOL)


def test_latlong_to_cubemap_matches_jax():
    pano = hdr(16, 32, 3, seed=4, scale=5.0)
    got = tenv.latlong_to_cubemap(t(pano), 8)
    assert got.shape == (6, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), j(jenv.latlong_to_cubemap(jnp.asarray(pano), 8)),
                               **TOL)


def edge_and_corner_dirs(r):
    """Directions whose bilinear taps leave their face: across each of the
    four edges of every face at three along-edge positions, and beyond each
    face's four corners."""
    dirs = []
    inner = r - 0.75  # gx in the last half texel: the +1 tap is off the face
    for f in range(6):
        for jj in (0, 2, r - 1):
            a = (jj + 0.5) * 2.0 / r - 1.0
            for g in (inner, -0.25):
                b = (g + 0.5) * 2.0 / r - 1.0
                dirs.append(jres._cube_face_dir(f, b, a))  # across u = +-1
                dirs.append(jres._cube_face_dir(f, a, b))  # across v = +-1
        for gu in (inner, -0.25):
            for gv in (inner, -0.25):
                dirs.append(jres._cube_face_dir(f, (gu + 0.5) * 2.0 / r - 1.0,
                                                (gv + 0.5) * 2.0 / r - 1.0))
    d = np.asarray(dirs, np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("seam", [True, False], ids=["seam", "clamp"])
def test_sample_cubemap_matches_jax(seam):
    r = 8
    cube = hdr(6, r, r, 3, seed=5, scale=4.0)
    rand = np.random.default_rng(6).standard_normal((20, 24, 3)).astype(np.float32)
    for dirs in (rand, edge_and_corner_dirs(r)):
        got = tres.sample_cubemap(t(cube), t(dirs), seam=seam).numpy()
        want = j(jres.sample_cubemap(jnp.asarray(cube), jnp.asarray(dirs), seam=seam))
        np.testing.assert_allclose(got, want, **TOL)


def test_cube_adjacency_table_matches_jax():
    for mine, theirs in ((tres._NEIGH_FACE, jres._NEIGH_FACE),
                         (tres._NEIGH_EDGE, jres._NEIGH_EDGE),
                         (tres._NEIGH_FLIP, jres._NEIGH_FLIP)):
        np.testing.assert_array_equal(mine, theirs)


def test_preprocess_matches_jax():
    x = hdr(6, 16, 3, seed=7)
    x[0, 0] = [np.nan, np.inf, -np.inf]
    x[1, 1] = [-3.0, 7e4, 1.0]
    for kw in ({}, {"brightness": 2.5}, {"flip": True}, {"rotation_deg": 180.0},
               {"brightness": 0.5, "flip": True, "rotation_deg": 90.0}):
        np.testing.assert_array_equal(tenv.preprocess_panorama(t(x), **kw).numpy(),
                                      j(jenv.preprocess_panorama(jnp.asarray(x), **kw)))


@pytest.mark.parametrize("mode", ["cubemap", "direct"])
@pytest.mark.parametrize("flip,rot,bright", [(False, 0.0, 1.0), (True, 180.0, 1.0),
                                             (True, 90.0, 3.0)])
def test_render_projection_matches_jax(mode, flip, rot, bright):
    pano = hdr(32, 64, 3, seed=8)
    pano[3, 5] = [np.nan, np.inf, 1.0]
    kw = dict(resolution=(12, 20), env_brightness=bright, env_flip=flip, env_rot=rot,
              num_frames=2, use_cache=False, mode=mode, cubemap_res=16)
    got = tenv.render_projection_from_panorama(pano, device="cpu", **kw)
    want = jenv.render_projection_from_panorama(pano, **kw)
    for key in ("env_ldr", "env_log"):
        assert got[key].shape == (2, 12, 20, 3)
        np.testing.assert_allclose(got[key].numpy(), j(want[key]), **TOL)


@pytest.mark.parametrize("size", [(12, 12), (8, 10)], ids=["same", "resized"])
def test_tonemap_image_direct_matches_jax(size):
    ball = hdr(12, 12, 3, seed=9, scale=10.0)
    got = tenv.tonemap_image_direct(ball, size, num_frames=3, use_cache=False, device="cpu")
    want = jenv.tonemap_image_direct(ball, size, num_frames=3, use_cache=False)
    for key in ("env_ldr", "env_log"):
        assert got[key].shape == (3, *size, 3)
        np.testing.assert_allclose(got[key].numpy(), j(want[key]), **TOL)


def test_env_input_forms():
    """Arrays of rank 2 to 4, 1 or 4 channels, and tensors, as JAX takes them."""
    x = hdr(8, 16, 4, seed=10)
    for arr in (x, x[None], x[..., :1], x[..., 0], torch.from_numpy(x)):
        np.testing.assert_array_equal(tenv._load_env_input(arr),
                                      jenv._load_env_input(np.asarray(arr)))


def test_cache_hits_and_misses():
    c = LRUCache(max_size=2)
    assert c.get("a") is None and (c.hits, c.misses) == (0, 1)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1 and (c.hits, c.misses) == (1, 1)
    c.put("c", 3)  # evicts "b", the least recently used
    assert c.get("b") is None and c.get("c") == 3 and len(c) == 2

    tenv.clear_environment_cache()
    pano = hdr(8, 16, 3, seed=11)
    before = tenv.get_cache_stats()
    r1 = tenv.render_projection_from_panorama(pano, (8, 16), device="cpu")
    r2 = tenv.render_projection_from_panorama(pano, (8, 16), device="cpu")
    assert r1 is r2
    r3 = tenv.render_projection_from_panorama(pano, (8, 16), device="cpu", num_frames=2)
    assert r3["env_ldr"].shape[0] == 2
    b1 = tenv.tonemap_image_direct(pano, (8, 16), device="cpu")
    assert tenv.tonemap_image_direct(pano, (8, 16), device="cpu") is b1
    stats = tenv.get_cache_stats()
    assert stats["cache_size"] == 3 and stats["max_size"] == 10
    assert stats["hits"] - before["hits"] == 2 and stats["misses"] - before["misses"] == 3
    tenv.clear_environment_cache()
    assert tenv.get_cache_stats()["cache_size"] == 0


def test_envmap_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv.render_projection_from_panorama(hdr(8, 16, 3), (8, 16), use_cache=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv.latlong_vec(4, 8)
