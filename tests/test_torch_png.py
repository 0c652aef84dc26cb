"""The port's PNG codec (io.read_png / io.write_png) and the CLI's frame
loaders (io.load_image, load_video, save_frames), against imageio and the
JAX package's loaders (diffusionrenderer_tpu/cli.py _load_image,
_load_video, _save_frames).  Every comparison is bitwise."""

import os
import struct
import sys
import zlib

import imageio.v3 as iio
import numpy as np
import pytest

from diffusionrenderer_tpu import cli as jcli
from diffusionrenderer_tpu.native import rgbe
from diffusionrenderer_tpu_torch import io as tio


def rand(shape, dtype, seed=0):
    return np.random.default_rng(seed).integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


# A reference encoder, independent of the codec under test: every row under
# the one filter asked for (or filter y % 5 for "mixed"), byte by byte.
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(arr, ctype, depth, filt, interlace=0):
    h, w = arr.shape[:2]
    data = arr.astype(">u2").tobytes() if depth == 16 else arr.astype(np.uint8).tobytes()
    stride = len(data) // h
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    raw = bytearray()
    prior = bytes(stride)
    for y in range(h):
        line = data[y * stride:(y + 1) * stride]
        f = y % 5 if filt == "mixed" else filt
        out = bytearray(stride)
        for i in range(stride):
            a = line[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            out[i] = (line[i] - pred) & 0xFF
        raw += bytes([f]) + out
        prior = line

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (tio.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + chunk(b"tEXt", b"Comment\x00ignored")
            + chunk(b"IDAT", zlib.compress(bytes(raw))[:7])
            + chunk(b"IDAT", zlib.compress(bytes(raw))[7:])
            + chunk(b"IEND", b""))


CHANNELS = {0: None, 2: 3, 4: 2, 6: 4}


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_reads_every_colour_type_depth_and_filter(tmp_path, depth, ctype, filt):
    dtype = np.uint16 if depth == 16 else np.uint8
    c = CHANNELS[ctype]
    want = rand((7, 5) if c is None else (7, 5, c), dtype, seed=depth + ctype)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(encode_png(want, ctype, depth, filt))
    got = tio.read_png(path)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (9, 13), (1, 1, 3), (16, 24, 3), (33, 17, 1)])
def test_round_trip_is_bitwise(tmp_path, shape):
    want = rand(shape, np.uint8, seed=sum(shape))
    path = str(tmp_path / "x.png")
    tio.write_png(path, want)
    got = tio.read_png(path)
    np.testing.assert_array_equal(got, want[..., 0] if len(shape) == 3 and shape[-1] == 1 else want)


@pytest.mark.parametrize("shape,dtype", [((12, 10), np.uint8), ((12, 10, 3), np.uint8),
                                         ((12, 10, 4), np.uint8), ((12, 10, 2), np.uint8),
                                         ((12, 10), np.uint16)],
                         ids=["gray8", "rgb8", "rgba8", "gray_alpha8", "gray16"])
def test_reads_imageio_files_as_imageio_does(tmp_path, shape, dtype):
    path = str(tmp_path / "x.png")
    iio.imwrite(path, rand(shape, dtype, seed=3))
    want = np.asarray(iio.imread(path))
    got = tio.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_reads_a_smooth_imageio_image(tmp_path):
    """A smooth image, where the encoder's adaptive filtering picks the
    predicting filters."""
    yy, xx = np.mgrid[0:60, 0:80]
    g = ((np.sin(xx / 9) + np.cos(yy / 7) + 2) * 60).astype(np.uint8)
    img = np.stack([g, g // 2, 255 - g], -1)
    path = str(tmp_path / "s.png")
    iio.imwrite(path, img)
    np.testing.assert_array_equal(tio.read_png(path), img)


@pytest.mark.parametrize("shape", [(12, 10), (12, 10, 3)], ids=["gray", "rgb"])
def test_imageio_reads_the_port_files(tmp_path, shape):
    want = rand(shape, np.uint8, seed=4)
    path = str(tmp_path / "x.png")
    tio.write_png(path, want)
    np.testing.assert_array_equal(np.asarray(iio.imread(path)), want)


@pytest.mark.parametrize("ctype,depth,interlace,words", [
    (3, 8, 0, "palette"), (0, 8, 1, "interlaced"), (0, 4, 0, "bit depth 4")])
def test_refuses_what_it_does_not_read(tmp_path, ctype, depth, interlace, words):
    path = str(tmp_path / "bad.png")
    arr = np.zeros((4, 4), np.uint8)
    data = encode_png(arr, ctype, 8, 0, interlace)
    if depth != 8:  # rewrite IHDR's depth byte and its CRC
        ihdr = bytearray(data[12:29])
        ihdr[12] = depth
        data = data[:12] + bytes(ihdr) + struct.pack(">I", zlib.crc32(bytes(ihdr))) + data[33:]
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=words) as e:
        tio.read_png(path)
    assert path in str(e.value)


def test_refuses_a_corrupt_chunk(tmp_path):
    path = str(tmp_path / "x.png")
    tio.write_png(path, rand((4, 4, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        tio.read_png(path)


def test_write_png_refuses_other_dtypes_and_shapes(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        tio.write_png(str(tmp_path / "a.png"), np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="RGB"):
        tio.write_png(str(tmp_path / "b.png"), np.zeros((4, 4, 4), np.uint8))


# ---------------------------------------------------------------------------
# The CLI's loaders against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    paths = {}
    for name, shape, dtype in (("gray8", (12, 10), np.uint8), ("rgb8", (12, 10, 3), np.uint8),
                               ("rgba8", (12, 10, 4), np.uint8),
                               ("gray16", (12, 10), np.uint16)):
        paths[name] = str(d / f"{name}.png")
        iio.imwrite(paths[name], rand(shape, dtype, seed=len(name)))
    paths["hdr"] = str(d / "sky.hdr")
    rgbe.save_hdr(paths["hdr"], np.abs(np.random.default_rng(5).standard_normal(
        (12, 10, 3))).astype(np.float32) * 4)
    paths["bmp"] = str(d / "rgb.bmp")
    iio.imwrite(paths["bmp"], rand((12, 10, 3), np.uint8, seed=6))
    return paths


@pytest.mark.parametrize("name", ["gray8", "rgb8", "rgba8", "gray16", "hdr", "bmp"])
def test_load_image_matches_jax(files, name):
    want = jcli._load_image(files[name])
    got = tio.load_image(files[name])
    assert got.dtype == want.dtype and got.shape == want.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)


def test_gray_alpha_is_gray_repeated(tmp_path):
    path = str(tmp_path / "ga.png")
    ga = rand((6, 4, 2), np.uint8, seed=7)
    iio.imwrite(path, ga)
    np.testing.assert_array_equal(tio.load_image(path), np.repeat(ga[..., :1], 3, axis=-1))


@pytest.mark.parametrize("names", [["rgb8", "gray8"], ["rgb8", "gray16"], ["hdr", "rgba8"]],
                         ids=["uint8", "mixed_uint16", "mixed_hdr"])
def test_load_video_matches_jax(files, names):
    paths = [files[n] for n in names]
    want = jcli._load_video(paths)
    got = tio.load_video(paths)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames", [1, 3])
def test_save_frames_matches_jax(tmp_path, frames):
    arr = np.random.default_rng(8).uniform(-0.1, 1.1, (frames, 6, 4, 3)).astype(np.float32)
    for pkg, save in (("jax", jcli._save_frames), ("port", tio.save_frames)):
        os.makedirs(tmp_path / pkg)
        save(arr, str(tmp_path / pkg / "out.png"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        np.testing.assert_array_equal(tio.read_png(str(tmp_path / "port" / n)),
                                      np.asarray(iio.imread(str(tmp_path / "jax" / n))))


def test_other_formats_need_imageio(files, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.raises(RuntimeError, match="imageio"):
        tio.load_image(files["bmp"])
    # PNG and HDR need nothing beyond the port.
    assert tio.load_image(files["rgb8"]).shape == (12, 10, 3)
    assert tio.load_image(files["hdr"]).dtype == np.float32
