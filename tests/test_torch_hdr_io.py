"""The port's native HDR codec and loader chain against the JAX package's.

The port builds its own copy of the codec (diffusionrenderer_tpu_torch/
csrc/hdr_codec.cc, exr_codec.cc) into build/native/; the JAX package builds
its own (diffusionrenderer_tpu/native).  Files written by either codec are
read by the other: RGBE and PFM decode to identical floats (same decoder
arithmetic), EXR (ZIP, half) likewise; a round trip is held to the format's
precision (RGBE: one 8-bit mantissa per channel under a shared exponent, so
1/128 of the pixel's largest channel; half: 2e-3 relative)."""

import struct

import numpy as np
import pytest

from diffusionrenderer_tpu import io as jio
from diffusionrenderer_tpu.native import rgbe as jrgbe
from diffusionrenderer_tpu_torch import api as tapi
from diffusionrenderer_tpu_torch import io as tio


@pytest.fixture(scope="module")
def hdr_img():
    rng = np.random.default_rng(0)
    img = np.abs(rng.standard_normal((16, 32, 3))).astype(np.float32)
    img[0, 0] = [0, 0, 0]
    img[1, 1] = [1000.0, 0.5, 1e-4]
    img[2, 3] = [3e4, 2e4, 1e-3]
    return img


def rgbe_bound(img):
    return img.max(axis=-1, keepdims=True) / 128.0 + 1e-6


def write_pfm(path, img, little_endian=True):
    h, w, c = img.shape
    scale = -1.0 if little_endian else 1.0
    with open(path, "wb") as f:
        f.write((b"PF" if c == 3 else b"Pf") + b"\n" + f"{w} {h}\n{scale}\n".encode())
        f.write(img[::-1].astype("<f4" if little_endian else ">f4").tobytes())


def test_rgbe_roundtrip(hdr_img, tmp_path):
    path = str(tmp_path / "rt.hdr")
    tio.save_hdr(path, hdr_img)
    back = tio.native_read(path)
    assert back.shape == hdr_img.shape and back.dtype == np.float32
    assert np.all(np.abs(back - hdr_img) <= rgbe_bound(hdr_img))


@pytest.mark.parametrize("ext", [".hdr", ".exr"])
def test_cross_read_with_the_jax_codec(hdr_img, tmp_path, ext):
    """Each package reads the other's files to the same floats."""
    save_t, save_j = (tio.save_hdr, jrgbe.save_hdr) if ext == ".hdr" else (tio.save_exr,
                                                                          jrgbe.save_exr)
    by_jax, by_port = str(tmp_path / f"jax{ext}"), str(tmp_path / f"port{ext}")
    save_j(by_jax, hdr_img)
    save_t(by_port, hdr_img)
    np.testing.assert_array_equal(tio.native_read(by_jax), jrgbe.load(by_jax))
    np.testing.assert_array_equal(jrgbe.load(by_port), tio.native_read(by_port))
    np.testing.assert_array_equal(tio.native_read(by_port), tio.native_read(by_jax))


@pytest.mark.parametrize("little_endian", [True, False], ids=["le", "be"])
@pytest.mark.parametrize("channels", [3, 1])
def test_pfm(hdr_img, tmp_path, little_endian, channels):
    img = hdr_img if channels == 3 else hdr_img[..., :1]
    path = str(tmp_path / "t.pfm")
    write_pfm(path, img, little_endian)
    got = tio.native_read(path)
    assert got.shape == (16, 32, 3)
    np.testing.assert_array_equal(got, jrgbe.load(path))
    np.testing.assert_array_equal(got, np.broadcast_to(img, got.shape))


def test_exr_roundtrip_and_independent_file(tmp_path):
    rng = np.random.default_rng(7)
    img = (rng.uniform(0, 1, (37, 53, 3)).astype(np.float32) ** 2) * 50.0
    img[0, 0] = [0.0, 1e-6, 30000.0]
    p = str(tmp_path / "rt.exr")
    tio.save_exr(p, img)
    back = tio.native_read(p)
    assert (np.abs(back - img) / np.maximum(np.abs(img), 1e-4)).max() < 2e-3
    # A FLOAT, uncompressed file built by hand reads back bit-exactly.
    from test_native_io import _write_minimal_exr_none_float

    small = rng.uniform(-2, 100, (5, 9, 3)).astype(np.float32)
    q = str(tmp_path / "oracle.exr")
    _write_minimal_exr_none_float(q, small)
    np.testing.assert_array_equal(tio.native_read(q), small)


def test_loader_chain_matches_jax(hdr_img, tmp_path):
    """load_hdr_file / load_hdr_image / api.load_hdr: the JAX package's
    shapes and values, through the native codec for .hdr, .exr and .pfm."""
    for ext, save in ((".hdr", jrgbe.save_hdr), (".exr", jrgbe.save_exr)):
        path = str(tmp_path / f"chain{ext}")
        save(path, hdr_img)
        np.testing.assert_array_equal(tio.load_hdr_file(path), jio.load_hdr_file(path))
        img = tapi.load_hdr(path)
        assert img.shape == (1, 16, 32, 3) and img.dtype == np.float32 and img.max() > 1.0
        np.testing.assert_array_equal(img, jio.load_hdr_image(path))
    path = str(tmp_path / "chain.pfm")
    write_pfm(path, hdr_img)
    np.testing.assert_array_equal(tio.load_hdr_file(path), hdr_img)


def test_refusals(tmp_path):
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"not an exr file at all")
    with pytest.raises(ValueError, match="exr_read failed"):
        tio.native_read(str(bad))
    with pytest.raises(ValueError, match="rgbe_read failed"):
        tio.native_read(str(tmp_path / "missing.hdr"))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        tio.save_hdr(str(tmp_path / "x.hdr"), np.zeros((4, 4, 4), np.float32))
    # A header that promises more pixels than the file holds.
    trunc = tmp_path / "trunc.pfm"
    trunc.write_bytes(b"PF\n4 4\n-1.0\n" + struct.pack("<3f", 1, 2, 3))
    with pytest.raises(ValueError, match="pfm_read failed"):
        tio.native_read(str(trunc))
