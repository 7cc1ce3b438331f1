"""PNG reader and writers, standard library and numpy only.

The reader takes what the scenes' textures are: 8-bit, non-interlaced PNGs
of colour type 0 (gray), 2 (RGB), 4 (gray + alpha) and 6 (RGBA), with any
of the five row filters. Anything else (16-bit or 1/2/4-bit samples,
palettes, Adam7 interlacing) raises ``ValueError`` naming the file.

The texture loaders convert as the JAX package's Pillow loaders do: RGB
drops alpha and spreads gray over three channels; gray of a non-gray image
is the Rec.709 luma the reference's Rust image crate uses
(floor(0.2126 R + 0.7152 G + 0.0722 B + 0.5), in float32); values are
divided by 255.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of 8-bit scanlines → [h, w, bpp] uint8.

    A pixel depends on its left, upper and upper-left neighbours, so all
    pixels of one anti-diagonal (y + x = k) are reconstructed together;
    each row keeps its own filter type (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"{rows.size} bytes of image data for {h} rows of "
                         f"{stride}")
    rows = rows.reshape(h, stride + 1)
    kinds = rows[:, 0].astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown row filter {kinds.max()}")
    line = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # Reconstructed pixels with a zero row above and a zero column left.
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for k in range(h + w - 1):
        ys = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        xs = k - ys
        left = out[ys + 1, xs]
        up = out[ys, xs + 1]
        upleft = out[ys, xs]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, upleft))
        kind = kinds[ys][:, None]
        pred = np.where(kind == 1, left,
                        np.where(kind == 2, up,
                                 np.where(kind == 3, (left + up) >> 1,
                                          np.where(kind == 4, paeth, 0))))
        out[ys + 1, xs + 1] = (line[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode a PNG file, or its bytes, to uint8 [H, W, C] with C = 1, 2, 3
    or 4 (gray, gray + alpha, RGB, RGBA)."""
    if isinstance(path, (bytes, bytearray)):
        data, path = bytes(path), "<bytes>"
    else:
        data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); only 8-bit, non-interlaced "
            "gray, gray+alpha, RGB and RGBA are read")
    try:
        return _unfilter(zlib.decompress(b"".join(idat)), h, w,
                         _CHANNELS[colour])
    except (ValueError, zlib.error) as e:
        raise ValueError(f"{path}: {e}") from None


def _rgb_u8(pixels: np.ndarray) -> np.ndarray:
    """[H,W,C] uint8 → [H,W,3] uint8 (alpha dropped, gray spread)."""
    if pixels.shape[2] in (1, 2):
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return pixels[:, :, :3]


def load_texture_rgb(path) -> np.ndarray:
    """PNG as [H,W,3] float32 in [0,1] (raw values, no sRGB decode)."""
    return _rgb_u8(read_png(path)).astype(np.float32) / 255.0


def load_texture_gray(path) -> np.ndarray:
    """PNG as [H,W] float32 in [0,1]; a gray PNG passes through, any other
    is reduced by the Rec.709 luma with round half up."""
    pixels = read_png(path)
    if pixels.shape[2] == 1:
        arr = pixels[:, :, 0]
    else:
        rgb = _rgb_u8(pixels).astype(np.float32)
        luma = (np.float32(0.2126) * rgb[..., 0]
                + np.float32(0.7152) * rgb[..., 1]
                + np.float32(0.0722) * rgb[..., 2])
        arr = np.floor(luma + np.float32(0.5)).clip(0, 255).astype(np.uint8)
    return arr.astype(np.float32) / 255.0


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(pixels_u8: np.ndarray) -> bytes:
    """[H,W,3] (RGB) or [H,W] (gray) uint8 → PNG bytes (8-bit, filter 0 on
    every row)."""
    img = np.ascontiguousarray(pixels_u8, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"expected [H,W,3] or [H,W] uint8, got {img.shape}")
    h, w, c = img.shape
    colour = 2 if c == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(pixels_u8: np.ndarray, path) -> None:
    """Save [H,W,3] or [H,W] uint8 to PNG."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(pixels_u8))
