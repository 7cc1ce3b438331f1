"""PNG and JPEG readers and a PNG writer, standard library and numpy only,
and texture loaders that hand any other format to Pillow.

The PNG reader takes every PNG (colour types 0, 2, 3, 4 and 6 at every bit
depth the format allows, any of the five row filters, Adam7 interlacing,
``PLTE`` and ``tRNS``) and decodes it as Pillow does: ``read_png`` gives
the samples of Pillow's mode for it, ``read_png_rgba`` Pillow's
``Image.open(...).convert("RGBA")``, with its quirks:

- 1-, 2- and 4-bit gray scale to 8 bits (x 255, 85, 17); 16-bit gray is
  clipped to 255 (not scaled); 16-bit RGB, gray + alpha and RGBA keep the
  most significant byte;
- a gray or RGB ``tRNS`` key is compared by its low byte with the 8-bit
  samples (gray scaled or clipped, 16-bit RGB's high bytes); a 1-bit
  image's key is 0, or 255 if it is not 0;
- palette indices past the palette read black; ``tRNS`` gives the first
  entries' alpha, the rest 255; gray + alpha and RGBA ignore ``tRNS``.

``decode_image_rgba`` reads a PNG or a JPEG (``utils/jpeg.py``: every 8-bit
JPEG Pillow decodes) as RGBA, as the glTF converter's textures need.

The texture loaders take the same two formats, told apart by their leading
bytes, and convert as the JAX package's Pillow loaders do: RGB drops alpha
and spreads gray over three channels; gray of a non-gray image is the
Rec.709 luma the reference's Rust image crate uses (floor(0.2126 R +
0.7152 G + 0.0722 B + 0.5), in float32); values are divided by 255. A
CMYK JPEG reaches RGB as Pillow's ``convert("RGB")`` takes it there
(``cmyk_to_rgb``).

Any other image (BMP, GIF, TIFF, WebP, TGA, ...: whatever Pillow opens, as
the JAX package's loaders take it) is decoded by Pillow, imported only
then (``_pillow_u8``), with the JAX package's conversions: ``convert("RGB")``
for the RGB loader; for the gray loader ``convert("L")`` of modes ``L``,
``I;16`` and ``I``, else ``convert("RGB")`` and the luma above; and
``convert("RGBA")`` for ``decode_image_rgba``. Without Pillow, or where
Pillow cannot read the bytes, it raises ``ValueError`` naming the file
and its leading bytes. PNG and JPEG never need Pillow.
"""
from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of scanlines [h, 1 + stride] (a filter
    byte, then the row) → [h, stride] uint8, with ``bpp`` bytes a pixel
    (at least 1) for the left neighbour.

    A byte depends on its left, upper and upper-left neighbours, so all
    pixels of one anti-diagonal (y + x = k) are reconstructed together;
    each row keeps its own filter type (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    w = stride // bpp
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
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def _samples(raw: memoryview, h: int, w: int, c: int, depth: int):
    """(samples [h, w, c] uint8 or uint16, bytes used) of one image or
    Adam7 pass whose filtered scanlines start ``raw``."""
    stride = (w * c * depth + 7) // 8
    need = h * (stride + 1)
    if len(raw) < need:
        raise ValueError(f"{len(raw)} bytes of image data for {h} rows of "
                         f"{stride}")
    rows = np.frombuffer(raw[:need], np.uint8).reshape(h, stride + 1)
    data = _unfilter(rows, max(1, c * depth // 8))
    if depth == 8:
        out = data
    elif depth == 16:
        out = data.view(">u2").astype(np.uint16)
    else:
        bits = np.unpackbits(data, axis=1)  # most significant bit first
        per = bits.reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (per * weights).sum(axis=2, dtype=np.uint8)
    return out[:, :w * c].reshape(h, w, c), need


def _decode_png(data: bytes, name) -> dict:
    """The PNG's samples and what its chunks say: ``pixels`` [H, W, C]
    (uint16 at depth 16, else uint8), ``colour``, ``depth``, ``palette``
    [256, 3] uint8 and ``trns`` (the chunk's bytes) or None."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat, palette, trns = 8, None, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, colour, compression, filtering, interlace = header
    if (colour not in _DEPTHS or depth not in _DEPTHS[colour]
            or compression or filtering or interlace > 1):
        raise ValueError(
            f"{name}: invalid PNG header (bit depth {depth}, colour type "
            f"{colour}, compression {compression}, filter {filtering}, "
            f"interlace {interlace})")
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    c = _CHANNELS[colour]
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
        if interlace:
            dtype = np.uint16 if depth == 16 else np.uint8
            pixels = np.zeros((h, w, c), dtype)
            for x0, y0, dx, dy in _ADAM7:
                pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
                if pw <= 0 or ph <= 0:
                    continue
                sub, used = _samples(raw, ph, pw, c, depth)
                pixels[y0::dy, x0::dx] = sub
                raw = raw[used:]
        else:
            pixels, _ = _samples(raw, h, w, c, depth)
    except (ValueError, zlib.error) as e:
        raise ValueError(f"{name}: {e}") from None
    pal = np.zeros((256, 3), np.uint8)
    if palette is not None:
        entries = np.frombuffer(palette[:len(palette) // 3 * 3], np.uint8)
        pal[:min(256, entries.size // 3)] = entries.reshape(-1, 3)[:256]
    return dict(pixels=pixels, colour=colour, depth=depth, palette=pal,
                trns=trns)


def _mode_u8(png: dict) -> np.ndarray:
    """The 8-bit samples of the PNG's Pillow mode, [H, W, C]: gray scaled
    or clipped (C 1), gray + alpha (2; RGBA at 16 bits), RGB (3), RGBA
    (4); a palette image expanded to RGB, or RGBA when it has ``tRNS``."""
    px, colour, depth = png["pixels"], png["colour"], png["depth"]
    if colour == 3:
        rgb = png["palette"][px[:, :, 0]]
        if png["trns"] is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        t = np.frombuffer(png["trns"][:256], np.uint8)
        alpha[:t.size] = t
        return np.concatenate([rgb, alpha[px[:, :, :1]]], axis=2)
    if depth == 16:
        if colour == 0:  # Pillow's I;16 reaches 8 bits by clipping
            return np.minimum(px, 255).astype(np.uint8)
        px = (px >> 8).astype(np.uint8)
        if colour == 4:  # Pillow opens 16-bit gray + alpha as RGBA
            return np.concatenate([np.repeat(px[:, :, :1], 3, axis=2),
                                   px[:, :, 1:]], axis=2)
        return px
    if colour == 0 and depth < 8:
        return (px * {1: 255, 2: 85, 4: 17}[depth]).astype(np.uint8)
    return px


def _read_bytes(path):
    if isinstance(path, (bytes, bytearray, memoryview)):
        return bytes(path), "<bytes>"
    return Path(path).read_bytes(), path


def read_png(path) -> np.ndarray:
    """Decode a PNG file, or its bytes, to uint8 [H, W, C]: the samples of
    Pillow's mode for it (C = 1 gray, 2 gray + alpha, 3 RGB, 4 RGBA; a
    palette image expanded to RGB, or RGBA with ``tRNS``)."""
    data, name = _read_bytes(path)
    return _mode_u8(_decode_png(data, name))


def read_png_rgba(path) -> np.ndarray:
    """A PNG file, or its bytes, as uint8 [H, W, 4]: Pillow's
    ``convert("RGBA")``, ``tRNS`` included (the module docstring)."""
    data, name = _read_bytes(path)
    png = _decode_png(data, name)
    px = _mode_u8(png)
    h, w, c = px.shape
    if c == 4:
        return px
    if c == 2:
        return np.concatenate([np.repeat(px[:, :, :1], 3, axis=2),
                               px[:, :, 1:]], axis=2)
    rgb = np.repeat(px, 3, axis=2) if c == 1 else px
    alpha = np.full((h, w, 1), 255, np.uint8)
    if png["trns"] is not None and png["colour"] in (0, 2):
        n = 1 if png["colour"] == 0 else 3
        if len(png["trns"]) < 2 * n:
            raise ValueError(f"{name}: short tRNS chunk")
        key = np.array(struct.unpack(f">{n}H", png["trns"][:2 * n]))
        if png["colour"] == 0 and png["depth"] == 1:
            key = np.array([255 if key[0] else 0])
        else:
            key = key & 0xFF
        alpha[(px.astype(np.int64) == key).all(axis=2)] = 0
    return np.concatenate([rgb, alpha], axis=2)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """uint8 [..., 4] CMYK (Pillow's mode ``CMYK``) → [..., 3] RGB as
    Pillow's ``convert("RGB")`` (Convert.c's cmyk2rgb): each channel
    255 - k - (x (255 - k)) / 255, the product rounded as MULDIV255."""
    x = cmyk.astype(np.int64)
    nk = 255 - x[..., 3:]
    t = x[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# The modes the JAX package's gray loader passes through ``convert("L")``.
_GRAY_MODES = ("L", "I;16", "I")


def _pillow_u8(data: bytes, name, mode: str) -> np.ndarray:
    """uint8 [H, W, C] of Pillow's ``Image.open(...).convert(mode)`` for an
    image that is neither PNG nor JPEG; ``mode`` "gray" is the gray
    loader's choice, "L" for modes ``_GRAY_MODES``, else "RGB". The one
    place the port imports Pillow."""
    lead = bytes(data[:8])
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{name}: neither a PNG nor a JPEG image (leading "
                         f"bytes {lead!r}); other formats need Pillow, which "
                         "is not installed") from None
    # What Pillow's plugins raise on a file they cannot read: OSError
    # (UnidentifiedImageError, truncation), ValueError, SyntaxError,
    # IndexError and struct.error on malformed headers or data, EOFError,
    # DecompressionBombError past its pixel limit.
    unreadable = (OSError, ValueError, SyntaxError, IndexError, EOFError,
                  struct.error, Image.DecompressionBombError)
    try:
        with Image.open(io.BytesIO(data)) as img:
            if mode == "gray":
                mode = "L" if img.mode in _GRAY_MODES else "RGB"
            px = np.asarray(img.convert(mode), np.uint8)
    except unreadable as e:
        raise ValueError(f"{name}: Pillow cannot read this image (leading "
                         f"bytes {lead!r}): {type(e).__name__}: {e}"
                         ) from None
    return px if px.ndim == 3 else px[:, :, None]


def _image_u8(data: bytes, name, mode: str) -> np.ndarray:
    """uint8 [H, W, C] samples of an image told apart by its leading
    bytes: a PNG's of its Pillow mode (``read_png``), a JPEG's gray or
    RGB, CMYK reaching RGB by ``cmyk_to_rgb``; any other image Pillow's
    conversion to ``mode`` (``_pillow_u8``)."""
    if data[:8] == _SIGNATURE:
        return _mode_u8(_decode_png(data, name))
    if data[:2] == b"\xff\xd8":
        from path_tracer_torch.utils.jpeg import decode_jpeg

        px = decode_jpeg(data, name)
        if px.ndim == 2:
            return px[:, :, None]
        return cmyk_to_rgb(px) if px.shape[2] == 4 else px
    return _pillow_u8(data, name, mode)


def decode_image_rgba(data: bytes, name="<bytes>") -> np.ndarray:
    """An image's bytes as uint8 [H, W, 4], as Pillow's
    ``Image.open(...).convert("RGBA")`` gives it (the glTF converter's
    textures): PNG and JPEG, the two image types a glTF 2.0 file may
    carry, by the port's decoders (a JPEG has alpha 255), any other
    through Pillow."""
    if data[:8] == _SIGNATURE:
        return read_png_rgba(data)
    px = _image_u8(data, name, "RGBA")
    if px.shape[2] == 4:
        return px
    rgb = np.repeat(px, 3, axis=2) if px.shape[2] == 1 else px
    alpha = np.full(px.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=2)


def _rgb_u8(pixels: np.ndarray) -> np.ndarray:
    """[H,W,C] uint8 → [H,W,3] uint8 (alpha dropped, gray spread)."""
    if pixels.shape[2] in (1, 2):
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return pixels[:, :, :3]


def load_texture_rgb(path) -> np.ndarray:
    """An image as [H,W,3] float32 in [0,1] (raw values, no sRGB
    decode)."""
    data, name = _read_bytes(path)
    return _rgb_u8(_image_u8(data, name, "RGB")).astype(np.float32) / 255.0


def load_texture_gray(path) -> np.ndarray:
    """An image as [H,W] float32 in [0,1]; a gray image passes through,
    any other is reduced by the Rec.709 luma with round half up."""
    data, name = _read_bytes(path)
    pixels = _image_u8(data, name, "gray")
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
    """[H,W,3] (RGB), [H,W,4] (RGBA) or [H,W] (gray) uint8 → PNG bytes
    (8-bit, filter 0 on every row)."""
    img = np.ascontiguousarray(pixels_u8, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"expected [H,W,3], [H,W,4] or [H,W] uint8, got "
                         f"{img.shape}")
    h, w, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(pixels_u8: np.ndarray, path) -> None:
    """Save [H,W,3], [H,W,4] or [H,W] uint8 to PNG."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(pixels_u8))
