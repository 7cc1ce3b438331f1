"""Re-save an ISF scene's PNG textures in another format with Pillow.

    python tests/tools/torch_image_formats.py SCENE_DIR OUT_DIR WRITER...

For each WRITER (a key of ``WRITERS``: bmp, tiff_lzw, webp_lossless, ...)
writes OUT_DIR/<WRITER>/: a copy of SCENE_DIR with every PNG texture
saved again by Pillow as <stem>.<WRITER> and ``scene.isf`` naming the new
files. The port reads such textures through Pillow, as the JAX package's
loaders do; a scene so re-saved loads the same texels as the PNG one
wherever the writer is lossless. ``tests/test_torch_image_formats.py`` and
``chip_smoke.py`` (phase 8b, in a child process, so that its own process
imports Pillow only through the port) use it.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

# Key -> (Pillow's format, its save options): every writer of Pillow 12.1.0
# that the JAX package's loaders can meet in a texture directory.
WRITERS = {
    "bmp": ("BMP", {}),
    "gif": ("GIF", {}),
    "tiff_raw": ("TIFF", {}),
    "tiff_lzw": ("TIFF", {"compression": "tiff_lzw"}),
    "tiff_deflate": ("TIFF", {"compression": "tiff_adobe_deflate"}),
    "tiff_packbits": ("TIFF", {"compression": "packbits"}),
    "webp_lossy": ("WEBP", {"quality": 80}),
    "webp_lossless": ("WEBP", {"lossless": True}),
    "tga_raw": ("TGA", {}),
    "tga_rle": ("TGA", {"compression": "tga_rle"}),
    "ppm": ("PPM", {}),
    "ico": ("ICO", {}),
    "dds": ("DDS", {}),
    "jpeg2000": ("JPEG2000", {}),
    "qoi": ("QOI", {}),
    "pcx": ("PCX", {}),
    "sgi": ("SGI", {}),
    "im": ("IM", {}),
    "avif": ("AVIF", {}),
    "xbm": ("XBM", {}),
    "msp": ("MSP", {}),
}


def save(img, path: Path, writer: str) -> Path:
    """Save the Pillow image ``img`` at ``path`` with ``writer``."""
    fmt, options = WRITERS[writer]
    img.save(path, fmt, **options)
    return path


def resave_scene(scene_dir, out_dir, writer: str) -> Path:
    """OUT_DIR/<writer>/scene.isf: the scene with its PNG textures re-saved
    by ``writer``. Raises if the ISF does not name each PNG exactly once."""
    from PIL import Image

    src, out = Path(scene_dir), Path(out_dir) / writer
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    text = (src / "scene.isf").read_text()
    for png in sorted(src.glob("*.png")):
        name = f"{png.stem}.{writer}"
        with Image.open(png) as img:
            save(img, out / name, writer)
        if text.count(f'"{png.name}"') != 1:
            raise ValueError(f"{src}: scene.isf names {png.name} "
                             f"{text.count(png.name)} times")
        text = text.replace(f'"{png.name}"', f'"{name}"')
    (out / "scene.isf").write_text(text)
    return out / "scene.isf"


def main(argv: list) -> int:
    if len(argv) < 3 or any(w not in WRITERS for w in argv[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    for writer in argv[2:]:
        print(resave_scene(argv[0], argv[1], writer))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
