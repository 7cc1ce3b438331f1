"""Texture formats other than PNG and JPEG, on the CPU.

The JAX package's loaders open any image Pillow reads
(``path_tracer_tpu/utils/image_io.py``), and so does its glTF converter.
The port keeps PNG and JPEG on its own decoders and hands every other
format to Pillow, imported only then, with the JAX package's conversions.

- Loaders: for each format and mode Pillow writes (fixtures written by
  Pillow into the test's directory), the port's ``load_texture_rgb`` and
  ``load_texture_gray`` are 0 texels off the JAX package's, and
  ``decode_image_rgba`` 0 texels off Pillow's ``convert("RGBA")``.
- A scene: ``head`` with its albedo and alpha textures re-saved as BMP,
  LZW TIFF and lossless WebP loads the same texels and renders bit-equal
  to the PNG scene (the port alone).
- A file Pillow cannot read (truncated, malformed, past its pixel limit)
  raises ``ValueError`` naming the file and its leading bytes.
- Without Pillow (``import PIL`` failing): a BMP texture raises naming
  the file, its leading bytes and the need for Pillow; the PNG scene
  still loads and renders.
"""
import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, str(Path(__file__).parent / "tools"))
from torch_image_formats import WRITERS, resave_scene, save  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

ALL_MODES = ("1", "L", "I;16", "P", "RGB", "RGBA", "CMYK")
# The source modes each writer takes (Pillow 12.1.0; a writer may store
# another mode, e.g. WebP keeps RGB or RGBA, GIF a palette).
MODES = {
    "bmp": ("1", "L", "P", "RGB", "RGBA"),
    "gif": ("1", "L", "I;16", "P", "RGB", "RGBA"),
    "tiff_raw": ALL_MODES, "tiff_lzw": ALL_MODES, "tiff_deflate": ALL_MODES,
    "tiff_packbits": ALL_MODES,
    "webp_lossy": ALL_MODES, "webp_lossless": ALL_MODES,
    "tga_raw": ("1", "L", "P", "RGB", "RGBA"),
    "tga_rle": ("L", "P", "RGB", "RGBA"),
    "ppm": ("1", "L", "I;16", "RGB", "RGBA"),
    "ico": ("1", "L", "I;16", "P", "RGB", "RGBA"),
    "dds": ("L", "RGB", "RGBA"),
    "jpeg2000": ("L", "I;16", "RGB", "RGBA", "CMYK"),
    "qoi": ("RGB", "RGBA"),
    "pcx": ("1", "L", "P", "RGB"),
    "sgi": ("L", "RGB", "RGBA"),
    "im": ALL_MODES,
    "avif": ALL_MODES,
    "xbm": ("1",),
    "msp": ("1",),
}
CASES = [(w, m) for w in WRITERS for m in MODES[w]]


def _source(mode: str) -> Image.Image:
    """A seeded 37 x 29 image of ``mode``: noise, with a 16-bit gray that
    spans the range (so Pillow's clip to 8 bits shows) and a 64-colour
    palette."""
    g = np.random.default_rng(21)
    px = g.integers(0, 256, (29, 37, 4), dtype=np.uint8)
    if mode == "1":
        return Image.fromarray(px[..., 0] > 127)
    if mode == "I;16":
        return Image.fromarray(px[..., 0].astype(np.uint16) * 257
                               + px[..., 1] % 7)
    if mode == "P":
        return Image.fromarray(px[..., :3]).quantize(64)
    if mode == "L":
        return Image.fromarray(px[..., 0])
    if mode == "RGB":
        return Image.fromarray(px[..., :3])
    return Image.frombytes(mode, (37, 29), px.tobytes())  # RGBA, CMYK


def _write(path: Path, writer: str, mode: str) -> Path:
    img = _source(mode)
    assert img.mode == mode
    return save(img, path, writer)


@pytest.mark.parametrize("writer,mode", CASES)
def test_loaders_match_jax_and_pillow(tmp_path, writer, mode):
    from path_tracer_torch.utils import image_io
    from path_tracer_tpu.utils import image_io as jax_io

    path = _write(tmp_path / f"tex.{writer}", writer, mode)
    data = path.read_bytes()
    assert data[:8] != b"\x89PNG\r\n\x1a\n" and data[:2] != b"\xff\xd8"
    for name in ("load_texture_rgb", "load_texture_gray"):
        got, want = getattr(image_io, name)(path), getattr(jax_io, name)(path)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    with Image.open(io.BytesIO(data)) as img:
        want = np.asarray(img.convert("RGBA"), np.uint8)
    np.testing.assert_array_equal(
        image_io.decode_image_rgba(data, path.name), want)


@pytest.fixture(scope="module")
def head_png():
    """(scene, 16 x 12 render) of ``head`` with its PNG textures."""
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.scene import load_scene

    scene = load_scene(REPO / "tests" / "scenes" / "head" / "scene.isf",
                       device="cpu")
    return scene, render(scene, Profile(resolution=Resolution(16, 12),
                                        samples=1, bounces=2))


@pytest.mark.parametrize("writer", ["bmp", "tiff_lzw", "webp_lossless"])
def test_isf_textures_in_other_formats_render_as_png(tmp_path, head_png,
                                                     writer):
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.scene import load_scene

    png_scene, png_image = head_png
    scene = load_scene(resave_scene(REPO / "tests" / "scenes" / "head",
                                    tmp_path, writer), device="cpu")
    assert scene.tex_data.shape == png_scene.tex_data.shape
    assert np.array_equal(scene.tex_data.numpy(), png_scene.tex_data.numpy())
    image = render(scene, Profile(resolution=Resolution(16, 12), samples=1,
                                  bounces=2))
    assert png_image.std() > 0
    np.testing.assert_array_equal(image, png_image)


def _bmp_header(width: int, height: int) -> bytes:
    """A 24-bit BMP's file and info headers for width x height pixels."""
    return (b"BM" + struct.pack("<IHHI", 58, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, width, height, 1, 24, 0, 4,
                          2835, 2835, 0, 0))


def _qoi(cut: int) -> bytes:
    buf = io.BytesIO()
    _source("RGB").save(buf, "QOI")
    return buf.getvalue()[:cut]


# Files Pillow recognises and cannot read, each failing in another way:
# truncated pixel data (OSError), an unknown signature
# (UnidentifiedImageError), a QOI cut in its header (ValueError) and in
# its data (IndexError), and a BMP past Pillow's pixel limit
# (DecompressionBombError).
MALFORMED = {
    "bmp_truncated": lambda: _bmp_header(16, 16) + bytes(40),
    "unidentified": lambda: b"NOTANIMAGE" + bytes(64),
    "qoi_header_cut": lambda: _qoi(20),
    "qoi_data_cut": lambda: _qoi(len(_qoi(1 << 20)) // 2),
    "bmp_bomb": lambda: _bmp_header(100000, 100000) + bytes(4),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_unreadable_files_raise_naming_the_file(tmp_path, case):
    from path_tracer_torch.utils.image_io import (
        decode_image_rgba,
        load_texture_gray,
        load_texture_rgb,
    )

    data = MALFORMED[case]()
    path = tmp_path / f"{case}.img"
    path.write_bytes(data)
    for call, name in ((lambda: load_texture_rgb(path), str(path)),
                       (lambda: load_texture_gray(path), str(path)),
                       (lambda: decode_image_rgba(data, "tex.img"),
                        "tex.img")):
        with pytest.raises(ValueError) as e:
            call()
        msg = str(e.value)
        assert name in msg and "Pillow cannot read" in msg, msg
        assert f"leading bytes {data[:8]!r}" in msg, msg


_WITHOUT_PILLOW = """
import sys
sys.modules["PIL"] = None  # any import of Pillow now fails
from pathlib import Path
from path_tracer_torch.config import Profile, Resolution
from path_tracer_torch.models.renderer import render
from path_tracer_torch.scene import load_scene
from path_tracer_torch.utils.image_io import decode_image_rgba, load_texture_rgb

bmp_scene, bmp, png_scene = sys.argv[1:4]
for call in (lambda: load_texture_rgb(bmp),
             lambda: decode_image_rgba(Path(bmp).read_bytes(), "tex.bmp"),
             lambda: load_scene(bmp_scene, device="cpu")):
    try:
        call()
    except ValueError as e:
        print("RAISED:", e)
img = render(load_scene(png_scene, device="cpu"),
             Profile(resolution=Resolution(16, 12), samples=1, bounces=2))
assert img.std() > 0
print("PNG RENDERED", "PIL" in {m for m, v in sys.modules.items() if v})
"""


def test_without_pillow_other_formats_raise_naming_the_file(tmp_path):
    scene = REPO / "tests" / "scenes" / "alpha_transparency"
    isf = resave_scene(scene, tmp_path, "bmp")
    assert "albedo_tex_0.bmp" in json.dumps(json.loads(isf.read_text()))
    bmp_dir = isf.parent
    proc = subprocess.run(
        [sys.executable, "-c", _WITHOUT_PILLOW, str(isf),
         str(bmp_dir / "albedo_tex_0.bmp"), str(scene / "scene.isf")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    raised = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("RAISED:")]
    assert len(raised) == 3, proc.stdout
    for ln, name in zip(raised, ("albedo_tex_0.bmp", "tex.bmp",
                                 "albedo_tex_0.bmp")):
        assert name in ln and "leading bytes b'BM" in ln, ln
        assert "need Pillow, which is not installed" in ln, ln
    assert "PNG RENDERED False" in proc.stdout, proc.stdout
