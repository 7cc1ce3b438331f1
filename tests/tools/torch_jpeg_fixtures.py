"""Write the JPEG fixtures of tests/fixtures/torch_images that Pillow does
not write (or writes only as CMYK), each beside its Pillow decode
``<name>.pillow.png`` (``Image.open(...).convert("RGBA")``):

- ``ll_gray_p7.jpg``: lossless gray, predictor 7, point transform 0;
- ``ll_rgb_p4_restart.jpg``: lossless RGB (no colour marker), predictor 4,
  point transform 1, a restart marker every 3 MCU rows;
- ``arith_420_restart.jpg``: Pillow's baseline 4:2:0 file (q75, a restart
  marker every MCU row), arithmetic-coded sequential (SOF9);
- ``arith_prog_422.jpg``: Pillow's progressive 4:2:2 file (q85),
  arithmetic-coded progressive (SOF10);
- ``cmyk_q75.jpg``: Pillow's CMYK file (Adobe transform 0);
- ``ycck_q75.jpg``: the same bytes with Adobe transform 2 (YCCK);
- ``rgb_411_q75.jpg``: 4:1:1 (luma sampled 4x1), Huffman-coded by the
  writer from libjpeg's quality-75 tables.

Needs Pillow. Run from the repository's root:
``python tests/tools/torch_jpeg_fixtures.py [out_dir]``.
"""
from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_jpeg_writer as jw  # noqa: E402

H, W = 29, 37  # the size of the other fixtures


def source() -> np.ndarray:
    """A 29 x 37 RGB image: smooth ramps and noise in a checker."""
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = np.stack([(xx * 7) % 256, (yy * 9) % 256,
                       ((xx + yy) * 4) % 256], -1)
    noise = np.random.default_rng(20).integers(0, 256, (H, W, 3))
    return np.where(((xx // 8 + yy // 8) % 2 == 0)[..., None], smooth,
                    noise).astype(np.uint8)


def _pillow(img, mode=None, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def q75_tables() -> dict:
    """libjpeg's quality-75 luminance and chrominance tables (natural
    order), as Pillow writes them."""
    from PIL import Image

    im = Image.open(io.BytesIO(_pillow(source(), quality=75)))
    return {k: np.asarray(v) for k, v in im.quantization.items()}


def rgb_411(img) -> bytes:
    """4:1:1 of ``img``: luma 4x1, chroma 1x1, libjpeg's q75 tables."""
    qt = q75_tables()
    ycc = jw.ycbcr(img)
    factors = [(4, 1), (1, 1), (1, 1)]
    lay, _, _ = jw.layout(W, H, [dict(h=h, v=v) for h, v in factors])
    comps = []
    for i, ((h, v), (cw, ch, bw, bh)) in enumerate(zip(factors, lay)):
        plane = ycc[..., i]
        if h == 1:  # the mean of each 4 samples across
            plane = np.pad(plane, ((0, 0), (0, 4 * cw - W)), mode="edge")
            plane = plane.reshape(ch, cw, 4).mean(axis=2)
        comps.append(dict(id=i + 1, h=h, v=v, tq=min(i, 1),
                          coef=jw.fdct(plane.clip(0, 255), qt[min(i, 1)], bh,
                                       bw)))
    return jw.dct(comps, W, H, qt)


def fixtures() -> dict:
    img = source()
    cmyk = np.concatenate([img, img[..., :1] // 3], axis=2)
    cmyk_file = _pillow(cmyk, "CMYK", quality=75)
    ycck = bytearray(cmyk_file)
    at = ycck.index(b"Adobe") + 11
    assert ycck[at] == 0
    ycck[at] = 2
    return {
        "ll_gray_p7.jpg": jw.lossless([img[..., 1]], [(1, 1)], W, H, 7),
        "ll_rgb_p4_restart.jpg": jw.lossless(
            [img[..., i] for i in range(3)], [(1, 1)] * 3, W, H, 4, pt=1,
            restart_rows=3),
        "arith_420_restart.jpg": jw.to_arithmetic(_pillow(
            img, quality=75, subsampling=2, restart_marker_rows=1)),
        "arith_prog_422.jpg": jw.to_arithmetic(_pillow(
            img, quality=85, subsampling=1, progressive=True)),
        "cmyk_q75.jpg": cmyk_file,
        "ycck_q75.jpg": bytes(ycck),
        "rgb_411_q75.jpg": rgb_411(img),
    }


def main(out: Path) -> None:
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    for name, data in fixtures().items():
        (out / name).write_bytes(data)
        Image.open(io.BytesIO(data)).convert("RGBA").save(
            out / (name + ".pillow.png"))
        print(f"wrote {out / name}: {len(data)} bytes")


if __name__ == "__main__":
    root = Path(__file__).resolve().parents[2]
    main(Path(sys.argv[1]) if len(sys.argv) > 1
         else root / "tests" / "fixtures" / "torch_images")
