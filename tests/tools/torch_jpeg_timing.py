"""Seconds per megapixel of the port's JPEG decoder (``utils/jpeg.py``),
by kind, on the host this runs on; no Pillow.

Each JPEG fixture of tests/fixtures/torch_images (29 x 37, so the fixed
cost of a call weighs in) is decoded ``repeats`` times and its least time
kept; a 1024 x 1024 lossless RGB JPEG of tests/scenes/head's albedo
texels (predictor 4, written by tests/tools/torch_jpeg_writer.py) is
decoded once, and must equal the PNG's texels.

Run from the repository's root: ``python tests/tools/torch_jpeg_timing.py``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

KINDS = (("gray_q75", "baseline gray"), ("rgb_4", "baseline"),
         ("ll_gray", "lossless gray"), ("ll_rgb", "lossless RGB"),
         ("arith_420", "arithmetic sequential"),
         ("arith_prog", "arithmetic progressive"), ("cmyk", "CMYK"),
         ("ycck", "YCCK"))


def kind_of(name: str) -> str:
    if name.startswith("rgb_411"):
        return "4:1:1"
    return next(k for prefix, k in KINDS if name.startswith(prefix))


def head_lossless() -> tuple:
    """(lossless JPEG bytes, the texels [1024, 1024, 3]) of
    tests/scenes/head/albedo_tex_0.png."""
    import torch_jpeg_writer as jw

    from path_tracer_torch.utils.image_io import read_png

    rgb = read_png(REPO / "tests" / "scenes" / "head" / "albedo_tex_0.png")
    h, w = rgb.shape[:2]
    return jw.lossless([rgb[..., i] for i in range(3)], [(1, 1)] * 3, w, h,
                       4), rgb


def _least(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def time_decoders(repeats: int = 5, head=None) -> list:
    """[{kind, file, pixels, seconds, s_per_mp}] of every JPEG fixture and
    the 1 MP lossless head albedo (``head``: ``head_lossless()``'s, if
    made already)."""
    import numpy as np

    from path_tracer_torch.utils.jpeg import decode_jpeg

    rows = []
    fixtures = REPO / "tests" / "fixtures" / "torch_images"
    for path in sorted(fixtures.glob("*.jpg")):
        data = path.read_bytes()
        px = decode_jpeg(data, path.name)
        secs = _least(lambda: decode_jpeg(data, path.name), repeats)
        rows.append(dict(kind=kind_of(path.name), file=path.name,
                         pixels=px.shape[0] * px.shape[1], seconds=secs))
    data, rgb = head or head_lossless()
    t0 = time.perf_counter()
    if not np.array_equal(decode_jpeg(data, "head"), rgb):
        raise AssertionError("the lossless head albedo decodes wrong")
    secs = time.perf_counter() - t0
    rows.append(dict(kind="lossless RGB", file="head albedo (1024 x 1024)",
                     pixels=rgb.shape[0] * rgb.shape[1], seconds=secs))
    for r in rows:
        r["s_per_mp"] = r["seconds"] / (r["pixels"] / 1e6)
    return rows


if __name__ == "__main__":
    import platform

    print(f"host: {platform.processor() or platform.machine()}, "
          f"python {platform.python_version()}")
    for r in time_decoders():
        print(f"{r['kind']:<24} {r['file']:<28} {r['pixels']:>8} px "
              f"{r['seconds']:.6f} s {r['s_per_mp']:.3f} s/MP")
