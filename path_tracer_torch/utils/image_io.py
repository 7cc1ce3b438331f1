"""PNG writer (stdlib only) and texture loaders (Pillow, imported lazily).

Gray conversion of non-gray textures uses the Rec.709 luma the reference's
Rust image crate uses (0.2126/0.7152/0.0722, round half up), as the JAX
package does.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def load_texture_rgb(path) -> np.ndarray:
    """PNG as [H,W,3] float32 in [0,1] (raw values, no sRGB decode)."""
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return arr.astype(np.float32) / 255.0


def load_texture_gray(path) -> np.ndarray:
    """PNG as [H,W] float32 in [0,1]; RGB(A) sources reduced by Rec.709 luma."""
    from PIL import Image

    img = Image.open(path)
    if img.mode in ("L", "I;16", "I"):
        arr = np.asarray(img.convert("L"), np.uint8)
    else:
        rgb = np.asarray(img.convert("RGB"), np.float32)
        luma = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
        arr = np.floor(luma + 0.5).clip(0, 255).astype(np.uint8)
    return arr.astype(np.float32) / 255.0


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(pixels_u8: np.ndarray) -> bytes:
    """[H,W,3] uint8 → PNG bytes (8-bit RGB, filter 0 on every row)."""
    img = np.ascontiguousarray(pixels_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(pixels_u8: np.ndarray, path) -> None:
    """Save [H,W,3] uint8 to PNG."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(pixels_u8))
