"""The port's PNG reader and writers (standard library and numpy only)
against Pillow, which the port itself never imports.

- ``read_png`` decodes exactly what Pillow decodes: every PNG of the
  reference scenes, the port's showcase textures, and seeded images of
  each colour type written with each of the five row filters (the test's
  own encoder: Pillow picks its filters itself);
- an invalid file raises ``ValueError`` naming the file: a palette at 16
  bits, a palette without ``PLTE``, an interlace method PNG does not
  define, not a PNG (16-bit samples, palettes and Adam7 interlacing
  decode as Pillow's: tests/test_torch_image_decode.py);
- ``load_texture_rgb`` / ``load_texture_gray`` equal the JAX package's
  Pillow loaders value for value;
- the showcase textures the port writes hold exactly the u8 values of the
  JAX package's Pillow-written files.
"""
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from path_tracer_torch.utils.image_io import (
    encode_png,
    load_texture_gray,
    load_texture_rgb,
    read_png,
    save_png,
)

SCENES = Path(__file__).parent / "scenes"
SCENE_PNGS = sorted(SCENES.glob("*/*.png"))
COLOUR_TYPES = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels
SHOWCASE_PNGS = ("terrain_albedo.png", "terrain_normal.png",
                 "terrain_rough.png", "leaf_alpha.png", "leaf_albedo.png",
                 "billboard_emissive.png")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_filtered(pixels: np.ndarray, colour: int, filt) -> bytes:
    """8-bit PNG of ``pixels`` [H,W,C] with row filter ``filt`` (0-4) on
    every row, or "mixed": row y takes filter y % 5."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    out = bytearray()
    for y in range(h):
        line = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        kind = y % 5 if filt == "mixed" else filt
        pred = [np.zeros_like(line), left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][kind]
        out.append(kind)
        out += ((line - pred) % 256).astype(np.uint8).tobytes()
        prev = line
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


def _pillow(path) -> np.ndarray:
    arr = np.asarray(Image.open(path))
    return arr[:, :, None] if arr.ndim == 2 else arr


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("colour", sorted(COLOUR_TYPES))
def test_read_png_equals_pillow_per_filter(tmp_path, colour, filt):
    g = np.random.default_rng(colour * 10 + (5 if filt == "mixed" else filt))
    pixels = g.integers(0, 256, (13, 17, COLOUR_TYPES[colour]), np.uint8)
    pixels[4:7] = pixels[3]  # repeated rows: Up and Paeth predict exactly
    path = tmp_path / "x.png"
    path.write_bytes(_encode_filtered(pixels, colour, filt))
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, pixels)
    np.testing.assert_array_equal(got, _pillow(path))


@pytest.mark.parametrize("path", SCENE_PNGS, ids=lambda p: p.parent.name
                         + "/" + p.name)
def test_scene_pngs_decode_as_pillow_and_the_jax_loaders(path):
    from path_tracer_tpu.utils import image_io as jio

    np.testing.assert_array_equal(read_png(path), _pillow(path))
    np.testing.assert_array_equal(load_texture_rgb(path),
                                  jio.load_texture_rgb(path))
    np.testing.assert_array_equal(load_texture_gray(path),
                                  jio.load_texture_gray(path))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_loaders_convert_as_the_jax_loaders(tmp_path, mode):
    """RGBA drops alpha, gray spreads over RGB, gray from colour is the
    Rec.709 luma with round half up: the JAX package's loaders' values."""
    from path_tracer_tpu.utils import image_io as jio

    g = np.random.default_rng(len(mode))
    shape = (9, 11) if mode == "L" else (9, 11, len(mode))
    path = tmp_path / f"{mode}.png"
    Image.fromarray(g.integers(0, 256, shape, np.uint8), mode).save(path)
    for port, ref in ((load_texture_rgb, jio.load_texture_rgb),
                      (load_texture_gray, jio.load_texture_gray)):
        got, want = port(path), ref(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_writers_round_trip_through_pillow(tmp_path):
    g = np.random.default_rng(3)
    rgb = g.integers(0, 256, (7, 5, 3), np.uint8)
    gray = g.integers(0, 256, (7, 5), np.uint8)
    save_png(rgb, tmp_path / "rgb.png")
    save_png(gray, tmp_path / "gray.png")
    assert Image.open(tmp_path / "rgb.png").mode == "RGB"
    assert Image.open(tmp_path / "gray.png").mode == "L"
    np.testing.assert_array_equal(_pillow(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(_pillow(tmp_path / "gray.png")[:, :, 0],
                                  gray)
    np.testing.assert_array_equal(read_png(tmp_path / "gray.png")[:, :, 0],
                                  gray)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))


def _patched_ihdr(path: Path, offset: int, value: int) -> None:
    """Set one byte of the IHDR chunk's body (8: bit depth, 9: colour
    type, 12: interlace method)."""
    data = bytearray(path.read_bytes())
    data[8 + 8 + offset] = value
    path.write_bytes(bytes(data))


def _without_plte(path: Path) -> None:
    data = path.read_bytes()
    pos, out = 8, bytearray(data[:8])
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] != b"PLTE":
            out += data[pos:pos + 12 + length]
        pos += 12 + length
    path.write_bytes(bytes(out))


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced",
                                  "not a png"])
def test_unsupported_pngs_raise_naming_the_file(tmp_path, kind):
    path = tmp_path / f"{kind}.png"
    if kind == "16-bit":  # a 16-bit file marked as a palette
        Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4)
                        * 999).save(path)
        _patched_ihdr(path, 9, 3)
    elif kind == "palette":  # a palette file without its palette
        Image.fromarray(np.zeros((3, 4), np.uint8), "L").convert(
            "P").save(path)
        _without_plte(path)
    elif kind == "interlaced":  # an interlace method PNG does not define
        Image.fromarray(np.zeros((4, 4), np.uint8), "L").save(path)
        _patched_ihdr(path, 12, 2)
    else:
        path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match=path.name):
        read_png(path)


def test_showcase_textures_equal_the_jax_package_files(tmp_path):
    """The port's showcase PNGs (its own writer, default texture dir)
    decode to exactly the u8 arrays of the JAX package's Pillow-written
    files, and the port's reader decodes both as Pillow does."""
    from path_tracer_torch.scene import showcase
    from path_tracer_tpu.scene.showcase import generate_showcase_textures

    port_dir = showcase.default_texture_dir()
    showcase.generate_showcase_textures(port_dir)
    generate_showcase_textures(tmp_path)
    for name in SHOWCASE_PNGS:
        want = _pillow(tmp_path / name)
        np.testing.assert_array_equal(_pillow(port_dir / name), want,
                                      err_msg=name)
        np.testing.assert_array_equal(read_png(port_dir / name), want,
                                      err_msg=name)
        np.testing.assert_array_equal(read_png(tmp_path / name), want,
                                      err_msg=name)
