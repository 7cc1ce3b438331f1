"""The port's image decoders (``utils/image_io.py`` PNG, ``utils/jpeg.py``
baseline JPEG; standard library and numpy) against Pillow, which the port
itself never imports.

- PNG: every colour type at every bit depth the format allows, with and
  without ``tRNS``, plain and Adam7-interlaced, from the test's own encoder
  (Pillow writes few of these), decode as Pillow's ``convert("RGBA")``,
  and ``read_png`` as Pillow's mode; Pillow's quirks pinned: 16-bit gray
  clips to 255, and a ``tRNS`` key's low byte is compared with the 8-bit
  value (gray scaled or clipped, 16-bit RGB's high bytes);
- JPEG: Pillow's baseline and progressive files at 4:4:4, 4:2:2 and
  4:2:0, qualities 50, 75 and 95, gray, restart intervals, optimized
  Huffman tables, odd and tiny sizes: at most one level off on any texel
  (the count of texels off is stated, and is 0); a progressive file
  decodes to the texels of the same image coded as baseline, and a glb
  with a progressive texture converts as the JAX converter converts it;
  a hierarchical, 12-bit or DNL file raises naming what it holds, and the
  texture loaders refuse a GIF (tests/test_torch_jpeg_kinds.py has the
  lossless, arithmetic-coded, CMYK and YCCK kinds);
- the fixtures in tests/fixtures/torch_images (what ``chip_smoke.py``
  checks on the card, where Pillow is absent): Pillow's decode beside
  each image is still Pillow's, and the port decodes each to it.
"""
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from path_tracer_torch.utils.image_io import (
    decode_image_rgba,
    load_texture_gray,
    load_texture_rgb,
    read_png,
    read_png_rgba,
)
from path_tracer_torch.utils.jpeg import decode_jpeg

FIXTURES = Path(__file__).parent / "fixtures" / "torch_images"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = [(c, d) for c, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16),
                               3: (1, 2, 4, 8), 4: (8, 16),
                               6: (8, 16)}.items() for d in ds]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _scanlines(samples: np.ndarray, depth: int, filt: int) -> bytes:
    """Rows of samples [h, w*c] packed at ``depth`` bits, each behind
    filter byte ``filt`` (0 None or 1 Sub, per byte with bpp = 1, which
    a decoder must undo with its own bpp only at depth < 8)."""
    out = bytearray()
    for row in samples:
        if depth == 16:
            raw = row.astype(">u2").tobytes()
        elif depth == 8:
            raw = row.astype(np.uint8).tobytes()
        else:
            per = 8 // depth
            r = np.concatenate([row, np.zeros((-len(row)) % per, row.dtype)])
            r = r.astype(np.uint8).reshape(-1, per)
            shifts = 8 - depth * (np.arange(per) + 1)
            raw = (r << shifts).sum(axis=1).astype(np.uint8).tobytes()
        if filt == 1 and depth < 8:
            b = np.frombuffer(raw, np.uint8).astype(np.int64)
            raw = ((b - np.concatenate([[0], b[:-1]])) & 255).astype(
                np.uint8).tobytes()
        else:
            filt = 0
        out += bytes([filt]) + raw
    return bytes(out)


def _encode(samples, colour, depth, plte=None, trns=None, interlace=0,
            filt=0) -> bytes:
    h, w, c = samples.shape
    if interlace:
        raw = b"".join(
            _scanlines(samples[y0::dy, x0::dx].reshape(-1, len(range(
                x0, w, dx)) * c), depth, filt)
            for x0, y0, dx, dy in ADAM7
            if len(range(x0, w, dx)) and len(range(y0, h, dy)))
    else:
        raw = _scanlines(samples.reshape(h, w * c), depth, filt)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(plte, np.uint8).ravel()))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _cases(colour, depth, seed):
    """PNG files of one colour type and depth: sizes 1x1 to 17x13, plain
    and interlaced, without tRNS, with a key one pixel has and with a
    random key (a palette's: a random number of alpha entries)."""
    g = np.random.default_rng(seed)
    hi = 1 << depth
    for (h, w) in ((1, 1), (3, 5), (13, 17), (9, 8)):
        for interlace in (0, 1):
            for trns_kind in (None, "hit", "random"):
                c = CHANNELS[colour]
                plte = trns = None
                if colour == 3:
                    n = int(g.integers(1, hi + 1))
                    plte = g.integers(0, 256, (n, 3))
                    s = g.integers(0, min(hi, n + 2), (h, w, 1))
                    if trns_kind:
                        trns = bytes(g.integers(0, 256, int(g.integers(
                            1, n + 1))).astype(np.uint8))
                else:
                    s = g.integers(0, hi, (h, w, c))
                    if trns_kind and colour in (0, 2):
                        key = (s[0, 0] if trns_kind == "hit"
                               else g.integers(0, hi, c))
                        trns = struct.pack(f">{c}H", *map(int, key))
                yield _encode(s, colour, depth, plte, trns, interlace,
                              filt=int(g.integers(0, 2)))


@pytest.mark.parametrize("colour,depth", DEPTHS)
def test_png_decodes_as_pillow(colour, depth):
    n = 0
    for data in _cases(colour, depth, seed=colour * 100 + depth):
        im = Image.open(io.BytesIO(data))
        want = np.asarray(im.convert("RGBA"))
        np.testing.assert_array_equal(read_png_rgba(data), want)
        np.testing.assert_array_equal(decode_image_rgba(data), want)
        mode = np.asarray(im.convert("RGB" if colour == 3 else im.mode
                                     .replace("I;16", "L").replace("1", "L")))
        got = read_png(data)
        if colour == 3:
            got = got[:, :, :3]
        np.testing.assert_array_equal(got.reshape(mode.shape), mode)
        n += 1
    assert n == 24


def test_png_quirks_pinned():
    """16-bit gray reaches 8 bits by clipping; a key's low byte is compared
    with the scaled (2-bit) or clipped (16-bit) gray, or with an RGB16
    image's high bytes."""
    gray16 = np.array([[[0], [100], [255], [256], [300], [65535]]])
    data = _encode(gray16, 0, 16, trns=struct.pack(">H", 0x01FF))
    got = read_png_rgba(data)
    assert got[0, :, 0].tolist() == [0, 100, 255, 255, 255, 255]
    assert got[0, :, 3].tolist() == [255, 255, 0, 0, 0, 0]
    gray2 = np.array([[[0], [1], [2], [3]]])
    got = read_png_rgba(_encode(gray2, 0, 2, trns=struct.pack(">H", 1)))
    assert got[0, :, 0].tolist() == [0, 85, 170, 255]
    assert got[0, :, 3].tolist() == [255] * 4  # no 8-bit value equals 1
    rgb16 = np.array([[[258, 514, 770], [1, 2, 3]]])
    keyed = _encode(rgb16, 2, 16, trns=struct.pack(">HHH", 0x101, 2, 3))
    got = read_png_rgba(keyed)
    assert got[0, :, :3].tolist() == [[1, 2, 3], [0, 0, 0]]
    assert got[0, :, 3].tolist() == [0, 255]
    for data in (_encode(gray16, 0, 16, trns=struct.pack(">H", 0x01FF)),
                 _encode(gray2, 0, 2, trns=struct.pack(">H", 1)), keyed):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(read_png_rgba(data), want)


@pytest.mark.parametrize("colour,depth", [(0, 16), (0, 2), (3, 4), (2, 16)])
def test_texture_loaders_match_the_jax_loaders(tmp_path, colour, depth):
    from path_tracer_tpu.utils import image_io as jax_io

    g = np.random.default_rng(depth)
    plte = g.integers(0, 256, (16, 3)) if colour == 3 else None
    s = g.integers(0, 16 if colour == 3 else 1 << depth,
                   (7, 9, CHANNELS[colour]))
    path = tmp_path / "t.png"
    path.write_bytes(_encode(s, colour, depth, plte,
                             trns=bytes([0, 99]) if colour == 3 else None))
    np.testing.assert_array_equal(load_texture_rgb(path),
                                  jax_io.load_texture_rgb(path))
    np.testing.assert_array_equal(load_texture_gray(path),
                                  jax_io.load_texture_gray(path))


def _image():
    yy, xx = np.mgrid[0:61, 0:83]
    smooth = np.stack([(xx * 3) % 256, (yy * 4) % 256,
                       ((xx + yy) * 2) % 256], -1)
    noise = np.random.default_rng(3).integers(0, 256, (61, 83, 3))
    return np.where(((xx // 16 + yy // 16) % 2 == 0)[..., None], smooth,
                    noise).astype(np.uint8)


def _jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _against_pillow(data: bytes) -> tuple:
    """(largest texel difference, texels off) of the port's decode."""
    im = Image.open(io.BytesIO(data))
    want = np.asarray(im).astype(np.int64)
    got = decode_jpeg(data).astype(np.int64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    return int(diff.max()), int((diff > 0).sum())


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_baseline_jpeg_decodes_as_pillow(quality, subsampling):
    img = _image()
    for kw in ({}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}):
        data = _jpeg(img, quality=quality, subsampling=subsampling, **kw)
        assert (b"\xff\xdd" in data) == bool(kw)
        worst, off = _against_pillow(data)
        assert worst <= 1 and off == 0, (kw, worst, f"{off} texels off")


def test_gray_and_small_jpegs_decode_as_pillow():
    img = _image()
    for data in (_jpeg(img[..., 1], quality=75),
                 _jpeg(img[..., 0], quality=95, restart_marker_blocks=2)):
        worst, off = _against_pillow(data)
        assert worst <= 1 and off == 0, f"{off} texels off"
    g = np.random.default_rng(4)
    for h, w in ((1, 1), (2, 2), (3, 17), (17, 3), (9, 4), (33, 2)):
        for sub in (0, 1, 2):
            data = _jpeg(g.integers(0, 256, (h, w, 3)).astype(np.uint8),
                         quality=80, subsampling=sub)
            worst, off = _against_pillow(data)
            assert worst <= 1 and off == 0, (h, w, sub, f"{off} texels off")
    rgba = decode_image_rgba(_jpeg(img[..., 2]))
    assert rgba.shape == (61, 83, 4) and (rgba[..., 3] == 255).all()


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_jpeg_decodes_as_pillow(quality, subsampling):
    """Pillow's progressive files (DC and AC first and refine scans,
    spectral selection, end-of-band runs), with and without restart
    markers and with optimized Huffman tables: Pillow's texels, and those
    of the same image coded as baseline."""
    img = _image()
    baseline = decode_jpeg(_jpeg(img, quality=quality,
                                 subsampling=subsampling))
    for kw in ({}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1},
               {"optimize": True}):
        data = _jpeg(img, quality=quality, subsampling=subsampling,
                     progressive=True, **kw)
        assert b"\xff\xc2" in data
        assert (b"\xff\xdd" in data) == ("optimize" not in kw and bool(kw))
        worst, off = _against_pillow(data)
        assert worst <= 1 and off == 0, (kw, worst, f"{off} texels off")
        np.testing.assert_array_equal(decode_jpeg(data), baseline)


def test_gray_and_small_progressive_jpegs_decode_as_pillow():
    """test_gray_and_small_jpegs_decode_as_pillow's gray and small odd
    images, coded progressive."""
    img = _image()
    for data in (_jpeg(img[..., 1], quality=75, progressive=True),
                 _jpeg(img[..., 0], quality=95, progressive=True,
                       restart_marker_blocks=2)):
        assert b"\xff\xc2" in data
        worst, off = _against_pillow(data)
        assert worst <= 1 and off == 0, f"{off} texels off"
    g = np.random.default_rng(4)
    for h, w in ((1, 1), (2, 2), (3, 17), (17, 3), (9, 4), (33, 2)):
        for sub in (0, 1, 2):
            data = _jpeg(g.integers(0, 256, (h, w, 3)).astype(np.uint8),
                         quality=80, subsampling=sub, progressive=True)
            worst, off = _against_pillow(data)
            assert worst <= 1 and off == 0, (h, w, sub, f"{off} texels off")


def _glb_with_jpeg(tmp_path, jpeg: bytes) -> Path:
    """tests/test_gltf.py's quad as a .glb whose base colour texture is
    ``jpeg``, stored in the binary chunk behind a bufferView."""
    import base64
    import json

    from tests.test_gltf import _build_gltf

    doc = json.loads(_build_gltf(tmp_path, binary=False).read_text())
    blob = base64.b64decode(doc["buffers"][0].pop("uri").split(",", 1)[1])
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob),
                               "byteLength": len(jpeg)})
    blob += jpeg + b"\x00" * ((-len(jpeg)) % 4)
    doc["buffers"][0]["byteLength"] = len(blob)
    doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1,
                      "mimeType": "image/jpeg"}]
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    glb = (b"glTF" + struct.pack("<II", 2, 28 + len(js) + len(blob))
           + struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(blob), 0x004E4942) + blob)
    path = tmp_path / "prog.glb"
    path.write_bytes(glb)
    return path


def test_glb_with_progressive_texture_converts_as_jax(tmp_path):
    """``path-tracer-torch convert`` of a glb whose texture is a
    progressive JPEG (4:2:0, restart markers): the JAX converter's ISF
    bytes and texture names, and its texels."""
    from path_tracer_torch import cli
    from path_tracer_tpu.scene.gltf import convert_gltf_to_isf

    jpeg = _jpeg(_image(), quality=85, subsampling=2, progressive=True,
                 restart_marker_blocks=4)
    assert b"\xff\xc2" in jpeg
    src = _glb_with_jpeg(tmp_path, jpeg)
    cli.main(["convert", str(src), str(tmp_path / "port")])
    convert_gltf_to_isf(src, tmp_path / "jax")
    port, want = tmp_path / "port", tmp_path / "jax"
    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in port.iterdir()) == names
    assert "albedo_tex_0.png" in names
    assert (port / "scene.isf").read_bytes() == \
        (want / "scene.isf").read_bytes()
    for name in names:
        if name.endswith(".png"):
            a, b = Image.open(port / name), Image.open(want / name)
            assert a.mode == b.mode, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    texels = read_png(port / "albedo_tex_0.png")
    np.testing.assert_array_equal(
        texels.reshape(61, 83, -1)[..., :3],
        np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")))


def test_unsupported_jpegs_raise_naming_the_marker(tmp_path):
    """What Pillow refuses raises ``ValueError`` naming the image and what
    it holds: a hierarchical frame (SOF5), 12-bit samples, a height set by
    DNL, and bytes no decoder reads (a bare GIF header), with their leading
    bytes; a GIF texture decodes through Pillow, as the JAX loaders read
    it (without Pillow it raises: tests/test_torch_image_formats.py)."""
    img = _image()
    data = bytearray(_jpeg(img))
    sof = data.index(b"\xff\xc0")
    hier = bytearray(data)
    hier[sof + 1] = 0xC5  # the same frame header, differential
    with pytest.raises(ValueError, match=r"hier\.jpg: differential "
                       r"sequential \(SOF5\)"):
        decode_jpeg(bytes(hier), "hier.jpg")
    twelve = bytearray(data)
    twelve[sof + 4] = 12  # the frame's sample precision
    with pytest.raises(ValueError, match=r"p12\.jpg: 12-bit"):
        decode_jpeg(bytes(twelve), "p12.jpg")
    dnl = bytearray(data)
    dnl[sof + 5:sof + 7] = b"\x00\x00"  # the height, left to DNL
    with pytest.raises(ValueError, match=r"dnl\.jpg: .*DNL"):
        decode_jpeg(bytes(dnl), "dnl.jpg")
    for bad in (bytes(hier), bytes(twelve), bytes(dnl)):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(bad)).load()
    with pytest.raises(ValueError, match=r"x\.gif: Pillow cannot read "
                       r"this image \(leading bytes b'GIF89a'"):
        decode_image_rgba(b"GIF89a", "x.gif")
    gif = tmp_path / "t.gif"
    Image.fromarray(img).save(gif)
    want = np.asarray(Image.open(gif).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(load_texture_rgb(gif), want)
    assert load_texture_gray(gif).shape == want.shape[:2]


def test_fixtures_hold_pillows_decode_and_the_port_matches():
    sources = sorted(p for p in FIXTURES.iterdir()
                     if not p.name.endswith(".pillow.png"))
    assert {p.suffix for p in sources} == {".jpg", ".png"}
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 100_000
    for src in sources:
        want = np.asarray(Image.open(src).convert("RGBA"))
        stored = src.with_name(src.name + ".pillow.png")
        np.testing.assert_array_equal(np.asarray(Image.open(stored)), want)
        np.testing.assert_array_equal(read_png(stored), want)
        np.testing.assert_array_equal(
            decode_image_rgba(src.read_bytes(), src.name), want)
