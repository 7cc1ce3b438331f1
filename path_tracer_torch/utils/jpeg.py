"""JPEG decoder, standard library and numpy only.

Decodes every 8-bit JPEG that libjpeg-turbo (the decoder behind Pillow)
decodes, to the samples Pillow's ``Image.open`` gives:

- sequential (SOF0, SOF1) and progressive (SOF2) Huffman-coded frames,
  and their arithmetic-coded twins (SOF9, SOF10; ``utils/jpeg_arith.py``),
  with 1 (gray), 3 or 4 components, sampling factors 1 to 4 each way,
  one or several scans, restart intervals; a progressive file's spectral
  selection and successive approximation (DC and AC first and refine
  scans, end-of-band runs), its coefficients then going through the
  sequential path's steps below (libjpeg's block smoothing acts only on a
  file whose last scans are missing, so a whole file decodes to the same
  samples as its coefficients coded sequentially);
- the integer inverse DCT of libjpeg's ``jidctint.c`` (``JDCT_ISLOW``,
  the default), with its range limit;
- lossless frames (SOF3): Huffman-coded differences, predictors 1-7, the
  point transform, restart intervals, interleaved or not, undone as
  ``jdlossls.c`` / ``jddiffct.c`` do (the first row of a scan and of each
  iMCU row in which a restart marker is read is predicted from its left
  neighbour, the first sample of such a row from 2^(7 - Pt));
- upsampling as ``jdsample.c`` picks it: the "fancy" triangle filter for
  a 2:1 ratio across (h2v1), down (h1v2) or both (h2v2), with its
  rounding biases; replication for every other whole ratio, for a
  component 2 samples wide or narrower under h2v1 and h2v2, and for every
  lossless component; a ratio that is not whole raises;
- colour as ``jdapimin.c`` / ``jdcolor.c`` read it: three components are
  YCbCr (fixed-point YCbCr -> RGB) with a JFIF marker, an Adobe marker of
  transform 1 or 2, or, with neither, unless the ids are 'R', 'G', 'B'
  (or the frame is lossless); else RGB. Four are CMYK, or YCCK (which
  ``ycck_cmyk_convert`` turns into CMYK) with an Adobe transform other
  than 0, every sample then inverted as Pillow's ``CMYK;I`` raw mode
  does. libjpeg converts no colour of a lossless frame: YCbCr or YCCK
  there raises, as Pillow does.

Hierarchical frames (SOF5-SOF7, SOF13-SOF15), arithmetic-coded lossless
(SOF11), samples of other than 8 bits, a height set by DNL, 2 components,
more than 10 blocks in an interleaved MCU and a sampling ratio that is
not whole raise ``ValueError`` naming the image and what it holds, as
Pillow refuses them. Pillow does not apply an EXIF orientation on
``open``, and neither does this.
"""
from __future__ import annotations

import struct
from array import array

import numpy as np

from path_tracer_torch.utils.jpeg_arith import decode_arith_scan

# Zigzag position k -> natural (row-major) index of the 8x8 block.
_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
# The frames decoded: marker -> (arithmetic, progressive, lossless).
_FRAMES = {0xC0: (False, False, False), 0xC1: (False, False, False),
           0xC2: (False, True, False), 0xC3: (False, False, True),
           0xC9: (True, False, False), 0xCA: (True, True, False)}
_REFUSED = {
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}


def _huffman_lut(counts, symbols) -> array:
    """65,536 entries: for the next 16 bits of the stream, the code's
    length << 8 | its symbol (0 where no code matches)."""
    lut = array("H", bytes(2 * 65536))
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            n = 1 << (16 - length)
            lut[lo:lo + n] = array("H", [length << 8 | symbols[k]]) * n
            code += 1
            k += 1
        code <<= 1
    return lut


# Zero bits past a segment's end: more than one block can read, so a
# stream that ends early fails the next block's length check.
_PAD_BITS = 2048


def _peek16(segment: bytes) -> array:
    """For each bit position of an entropy-coded segment (its 0xFF00
    stuffing removed), the 16 bits from there on, zero past the end (the
    bits libjpeg feeds in at a marker)."""
    bits = np.unpackbits(np.frombuffer(segment, np.uint8))
    bits = np.concatenate([bits, np.zeros(_PAD_BITS, np.uint8)]).astype(
        np.uint32)
    n = bits.size - 16
    peek = np.zeros(n, np.uint32)
    for k in range(16):
        peek = (peek << 1) | bits[k:k + n]
    return array("H", peek.astype(np.uint16).tobytes())


def _entropy_segments(data: bytes, pos: int):
    """(segments between restart markers with stuffing removed, the
    position of the marker that ends the scan)."""
    segments, cur, start = [], bytearray(), pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            cur += data[start:]
            segments.append(bytes(cur))
            return segments, len(data)
        nxt = data[i + 1]
        if nxt == 0x00:
            cur += data[start:i + 1]
            pos = start = i + 2
        elif nxt == 0xFF:  # fill byte before a marker
            cur += data[start:i]
            pos = start = i + 1
        elif 0xD0 <= nxt <= 0xD7:
            cur += data[start:i]
            segments.append(bytes(cur))
            cur = bytearray()
            pos = start = i + 2
        else:
            cur += data[start:i]
            segments.append(bytes(cur))
            return segments, i


def _decode_scan(segments, scan, mcus, interval, name) -> None:
    """Huffman-decode one scan's blocks into their components' ``coef``
    (quantized, natural order), ``interval`` MCUs (all, if 0) a restart
    segment. ``mcus``: each MCU's blocks in order (``_scan_mcus``)."""
    per_seg = interval if interval else len(mcus)
    zz = _ZIGZAG
    for seg_i, segment in enumerate(segments):
        todo = mcus[seg_i * per_seg:(seg_i + 1) * per_seg]
        if not todo:
            break
        peek = _peek16(segment)
        limit = 8 * len(segment)
        pos = 0
        pred = {c: 0 for c, _, _ in scan}
        for mcu in todo:
            for ci, dc_lut, ac_lut, coef, base in mcu:
                if pos > limit:
                    raise ValueError(f"{name}: entropy-coded data ends early")
                e = dc_lut[peek[pos]]
                if not e:
                    raise ValueError(f"{name}: bad Huffman code")
                pos += e >> 8
                s = e & 255
                if s:
                    v = peek[pos] >> (16 - s)
                    pos += s
                    pred[ci] += v - (1 << s) + 1 if v < 1 << (s - 1) else v
                coef[base] = pred[ci]
                k = 1
                while k < 64:
                    e = ac_lut[peek[pos]]
                    if not e:
                        raise ValueError(f"{name}: bad Huffman code")
                    pos += e >> 8
                    rs = e & 255
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        if k > 63:
                            raise ValueError(f"{name}: coefficient past 63")
                        v = peek[pos] >> (16 - s)
                        pos += s
                        coef[base + zz[k]] = (v - (1 << s) + 1
                                              if v < 1 << (s - 1) else v)
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break


def _decode_progressive_scan(segments, mcus, interval, ss, se, ah, al,
                             name) -> None:
    """Huffman-decode one scan of a progressive JPEG into the components'
    ``coef`` (libjpeg's jdphuff.c): coefficients ``ss``..``se`` (zigzag),
    a first scan (``ah`` 0) writing them shifted left by ``al``, a refine
    scan adding bit ``al`` to them. DC scans may interleave components;
    AC scans hold one, and code runs of blocks with no coefficient left
    in the band as one end-of-band run. Predictions and runs restart at
    each restart marker."""
    per_seg = interval if interval else len(mcus)
    zz = _ZIGZAG
    p1, m1 = 1 << al, -1 << al
    for seg_i, segment in enumerate(segments):
        todo = mcus[seg_i * per_seg:(seg_i + 1) * per_seg]
        if not todo:
            break
        peek = _peek16(segment)
        limit = 8 * len(segment)
        pos = 0
        if ss == 0:  # DC scans
            pred = {}
            for mcu in todo:
                for ci, dc_lut, _, coef, base in mcu:
                    if pos > limit:
                        raise ValueError(f"{name}: entropy-coded data ends "
                                         "early")
                    if ah:  # refine: one raw bit
                        if peek[pos] >> 15:
                            coef[base] |= p1
                        pos += 1
                        continue
                    e = dc_lut[peek[pos]]
                    if not e:
                        raise ValueError(f"{name}: bad Huffman code")
                    pos += e >> 8
                    s = e & 255
                    v = 0
                    if s:
                        v = peek[pos] >> (16 - s)
                        pos += s
                        if v < 1 << (s - 1):
                            v += 1 - (1 << s)
                    pred[ci] = pred.get(ci, 0) + v
                    coef[base] = pred[ci] << al
            continue
        eobrun = 0
        for ((_, _, ac_lut, coef, base),) in todo:
            if pos > limit:
                raise ValueError(f"{name}: entropy-coded data ends early")
            k = ss
            if not ah:  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                while k <= se:
                    e = ac_lut[peek[pos]]
                    if not e:
                        raise ValueError(f"{name}: bad Huffman code")
                    pos += e >> 8
                    r, s = (e & 255) >> 4, e & 15
                    if s:
                        k += r
                        if k > se:
                            raise ValueError(f"{name}: coefficient past the "
                                             "band")
                        v = peek[pos] >> (16 - s)
                        pos += s
                        if v < 1 << (s - 1):
                            v += 1 - (1 << s)
                        coef[base + zz[k]] = v << al
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += peek[pos] >> (16 - r)
                            pos += r
                        eobrun -= 1
                        break
                continue
            # AC refine: new coefficients are +-1 << al; every coefficient
            # already non-zero that the run passes takes one correction bit.
            if not eobrun:
                while k <= se:
                    e = ac_lut[peek[pos]]
                    if not e:
                        raise ValueError(f"{name}: bad Huffman code")
                    pos += e >> 8
                    r, s = (e & 255) >> 4, e & 15
                    if s:
                        s = p1 if peek[pos] >> 15 else m1
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += peek[pos] >> (16 - r)
                            pos += r
                        break
                    while k <= se:
                        z = base + zz[k]
                        c = coef[z]
                        if c:
                            if peek[pos] >> 15 and not c & p1:
                                coef[z] = c + p1 if c >= 0 else c + m1
                            pos += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        if k > se:
                            raise ValueError(f"{name}: coefficient past the "
                                             "band")
                        coef[base + zz[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    z = base + zz[k]
                    c = coef[z]
                    if c:
                        if peek[pos] >> 15 and not c & p1:
                            coef[z] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    k += 1
                eobrun -= 1


# jidctint.c's constants (CONST_BITS 13).
_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x, shift: int):
    """One pass of jidctint.c over axis 1 of x [N, 8, M] (int64): the even
    and odd parts, descaled by ``shift`` with rounding."""
    c = _C
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * c["f0541"]
    tmp2 = z1 + z3 * -c["f1847"]
    tmp3 = z1 + z2 * c["f0765"]
    tmp0 = (x[:, 0] + x[:, 4]) << 13
    tmp1 = (x[:, 0] - x[:, 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["f1175"]
    t0 = t0 * c["f0298"]
    t1 = t1 * c["f2053"]
    t2 = t2 * c["f3072"]
    t3 = t3 * c["f1501"]
    z1 = z1 * -c["f0899"]
    z2 = z2 * -c["f2562"]
    z3 = z3 * -c["f1961"] + z5
    z4 = z4 * -c["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    rnd = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(v + rnd) >> shift for v in out], axis=1)


def _idct(blocks: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow of dequantized blocks [N, 64] →
    samples [N, 8, 8] uint8 (rows, columns), through its range limit
    (value + 128 clamped to 0..255, modulo 1024 beyond +-512)."""
    x = blocks.reshape(-1, 8, 8).astype(np.int64)  # [N, row(v), col(u)]
    ws = _idct_1d(x, 13 - 2)  # columns: along the row index
    out = _idct_1d(ws.transpose(0, 2, 1), 13 + 2 + 3)
    out = out.transpose(0, 2, 1)  # back to [N, row, col]
    idx = out & 1023
    table = np.concatenate([np.arange(128, 256), np.full(384, 255),
                            np.zeros(384), np.arange(0, 128)]).astype(np.uint8)
    return table[idx]


def _fancy_h(x: np.ndarray) -> np.ndarray:
    """jdsample.c's h2v1_fancy_upsample over axis 1 (int arrays)."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out


def _colsums(x: np.ndarray) -> tuple:
    """(above, below) [H, W]: 3 x + the row above, 3 x + the row below,
    the edge rows their own neighbours (jdmainct.c's context rows)."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    return 3 * x + up, 3 * x + down


def _upsample(plane: np.ndarray, ratio: tuple, fancy: bool, name):
    """A component's real samples [h, w] expanded by ``ratio`` (the
    largest sampling factors over its own, across and down) as jdsample.c
    does; ``fancy`` is off for a lossless frame."""
    (hmax, h), (vmax, v) = ratio
    if hmax % h or vmax % v:
        raise ValueError(f"{name}: sampling factors {h}x{v} against "
                         f"{hmax}x{vmax}: not a whole ratio")
    hx, vx = hmax // h, vmax // v
    x = plane.astype(np.int64)
    h, w = x.shape
    if hx == 1 and vx == 1:
        return x
    if hx == 2 and vx == 1 and fancy and w > 2:
        return _fancy_h(x)
    if hx == 2 and vx == 2 and fancy and w > 2:
        rows = []
        for cs in _colsums(x):
            left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            o = np.empty((h, 2 * w), np.int64)
            o[:, 0::2] = (3 * cs + left + 8) >> 4
            o[:, 1::2] = (3 * cs + right + 7) >> 4
            rows.append(o)
        out = np.empty((2 * h, 2 * w), np.int64)
        out[0::2], out[1::2] = rows
        return out
    if hx == 1 and vx == 2 and fancy:
        above, below = _colsums(x)
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (above + 1) >> 2
        out[1::2] = (below + 2) >> 2
        return out
    return np.repeat(np.repeat(x, vx, axis=0), hx, axis=1)


def _ycc_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: fixed point, SCALEBITS 16."""
    one_half = 1 << 15
    fix = lambda v: int(v * 65536 + 0.5)
    cbx, crx = cb - 128, cr - 128
    r = y + ((fix(1.40200) * crx + one_half) >> 16)
    g = y + ((-fix(0.34414) * cbx + one_half - fix(0.71414) * crx) >> 16)
    b = y + ((fix(1.77200) * cbx + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _read(data: bytes, name) -> dict:
    """Walk a JPEG's markers and decode its scans: the frame (its
    components' quantized coefficients, or a lossless frame's samples),
    the quantization tables and the colour markers."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG image")
    qt, dc_tabs, ac_tabs, dac = {}, {}, {}, {}
    frame, interval, jfif, adobe = None, 0, False, None
    pos = 2
    while True:
        i = data.find(b"\xff", pos)
        while 0 <= i < len(data) - 1 and data[i + 1] == 0xFF:
            i += 1
        if i < 0 or i + 1 >= len(data):
            raise ValueError(f"{name}: no EOI marker")
        marker = data[i + 1]
        pos = i + 2
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _REFUSED:
            raise ValueError(f"{name}: {_REFUSED[marker]} JPEG is not "
                             "supported (Pillow does not decode it); "
                             f"marker 0xFF{marker:02X}")
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDB:  # DQT
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[k + 1:k + 1 + n],
                                     ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[list(_ZIGZAG)] = vals
                qt[tq] = table
                k += 1 + n
        elif marker == 0xC4:  # DHT
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = body[k + 1:k + 17]
                n = sum(counts)
                lut = _huffman_lut(counts, body[k + 17:k + 17 + n])
                (ac_tabs if tc else dc_tabs)[th] = lut
                k += 17 + n
        elif marker == 0xCC:  # DAC
            for k in range(0, len(body) - 1, 2):
                tc, tb, val = body[k] >> 4, body[k] & 15, body[k + 1]
                if tc:
                    dac[("ac", tb)] = val
                elif val & 15 > val >> 4:
                    raise ValueError(f"{name}: DAC with L > U")
                else:
                    dac[("dc", tb)] = (val & 15, val >> 4)
        elif marker == 0xDD:  # DRI
            (interval,) = struct.unpack(">H", body[:2])
        elif marker in _FRAMES:
            frame = _frame(marker, body, name)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: scan before the frame header")
            segments, pos = _entropy_segments(data, pos)
            _scan(frame, body, segments, interval, dc_tabs, ac_tabs, dac,
                  name)
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    return dict(frame=frame, qt=qt, jfif=jfif, adobe=adobe)


def _frame(marker: int, body: bytes, name) -> dict:
    """A frame header's components and layout: for each component its
    sampling factors, real size in samples (``w``, ``h_px``) and, for a
    DCT frame, its blocks across and down the MCU grid and their
    coefficients (zero until the scans fill them)."""
    arith, progressive, lossless = _FRAMES[marker]
    precision, height, width, nf = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG samples are not "
                         "supported (Pillow decodes 8-bit only)")
    if nf not in (1, 3, 4):
        raise ValueError(f"{name}: {nf}-component JPEG is not supported "
                         "(gray, three components or CMYK)")
    if height == 0:
        raise ValueError(f"{name}: JPEG height set by DNL is not supported")
    comps = {}
    for c in range(nf):
        cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
        hs, vs = hv >> 4, hv & 15
        if not (1 <= hs <= 4 and 1 <= vs <= 4):
            raise ValueError(f"{name}: sampling factors {hs}x{vs} are not "
                             "valid (1 to 4 each way)")
        comps[cid] = dict(order=c, h=hs, v=vs, tq=tq)
    hmax = max(c["h"] for c in comps.values())
    vmax = max(c["v"] for c in comps.values())
    size = 1 if lossless else 8  # samples a block
    mx, my = -(-width // (size * hmax)), -(-height // (size * vmax))
    for c in comps.values():
        c["w"] = -(-width * c["h"] // hmax)
        c["h_px"] = -(-height * c["v"] // vmax)
        if not lossless:
            c["bw"], c["bh"] = mx * c["h"], my * c["v"]
            c["coef"] = array("i", bytes(4 * 64 * c["bw"] * c["bh"]))
    return dict(width=width, height=height, comps=comps, hmax=hmax,
                vmax=vmax, mx=mx, my=my, arith=arith,
                progressive=progressive, lossless=lossless)


def _scan(frame, body, segments, interval, dc_tabs, ac_tabs, dac,
          name) -> None:
    """Decode one scan (SOS ``body``, its entropy-coded ``segments``)."""
    ns = body[0]
    scan = [(body[1 + 2 * j], body[2 + 2 * j] >> 4, body[2 + 2 * j] & 15)
            for j in range(ns)]
    ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
    ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
    comps = frame["comps"]
    if any(cid not in comps for cid, _, _ in scan):
        raise ValueError(f"{name}: scan names a missing component")
    if ns > 1 and sum(comps[cid]["h"] * comps[cid]["v"]
                      for cid, _, _ in scan) > 10:
        raise ValueError(f"{name}: more than 10 blocks in an MCU")
    if frame["lossless"]:
        if not 1 <= ss <= 7 or se or ah or al > 7:
            raise ValueError(f"{name}: lossless scan of predictor {ss}, "
                             f"point transform {al}: not a valid scan")
        _decode_lossless_scan(segments, frame, scan, dc_tabs, interval, ss,
                              al, name)
        return
    if frame["progressive"]:
        if (se > 63 or ss > se or (ss == 0) != (se == 0) or (ss and ns != 1)
                or al > 13):
            raise ValueError(f"{name}: progressive scan of coefficients "
                             f"{ss}-{se}, {ns} components: not a valid scan")
        need = "dc" if ss == 0 and not ah else ("ac" if ss else None)
    elif ss != 0 or se != 63:
        raise ValueError(f"{name}: scan of coefficients {ss}-{se}: not a "
                         "sequential JPEG")
    else:
        need = "both"
    if frame["arith"]:  # conditioning tables 0-15, DAC's or the defaults
        tables = {t: t for t in range(16)}
        mcus = _scan_mcus(frame, scan, tables, tables, need, name)
        decode_arith_scan(segments, mcus, interval,
                          (frame["progressive"], ss, se, ah, al), dac, name)
        return
    mcus = _scan_mcus(frame, scan, dc_tabs, ac_tabs, need, name)
    if frame["progressive"]:
        _decode_progressive_scan(segments, mcus, interval, ss, se, ah, al,
                                 name)
    else:
        _decode_scan(segments, scan, mcus, interval, name)


def _scan_mcus(frame, scan, dc_tabs, ac_tabs, need, name) -> list:
    """Each MCU's blocks in scan order: (component id, DC table, AC table,
    coefficients, block offset). ``need`` names the entropy tables the
    scan reads ("dc", "ac", "both" or None); a table it does not read may
    be missing (None)."""
    comps = frame["comps"]
    specs = []
    for cid, td, ta in scan:
        dc, ac = dc_tabs.get(td), ac_tabs.get(ta)
        if ((need in ("dc", "both") and dc is None)
                or (need in ("ac", "both") and ac is None)):
            raise ValueError(f"{name}: scan names a missing Huffman table")
        specs.append((cid, comps[cid], dc, ac))
    mcus = []
    if len(specs) == 1:  # non-interleaved: the component's own blocks
        cid, c, dc, ac = specs[0]
        bw, bh = -(-c["w"] // 8), -(-c["h_px"] // 8)
        for by in range(bh):
            for bx in range(bw):
                mcus.append(((cid, dc, ac, c["coef"],
                              64 * (by * c["bw"] + bx)),))
        return mcus
    for my in range(frame["my"]):
        for mx in range(frame["mx"]):
            mcu = []
            for cid, c, dc, ac in specs:
                for v in range(c["v"]):
                    for h in range(c["h"]):
                        by, bx = my * c["v"] + v, mx * c["h"] + h
                        mcu.append((cid, dc, ac, c["coef"],
                                    64 * (by * c["bw"] + bx)))
            mcus.append(tuple(mcu))
    return mcus


def _decode_lossless_scan(segments, frame, scan, dc_tabs, interval,
                          predictor, pt, name) -> None:
    """Decode one lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c) into
    its components' ``samples`` [h_px, w] uint8.

    An MCU is one sample of a component alone, or h x v samples of each
    component of an interleaved scan, the samples past a component's
    edge dummies. Restart intervals are whole rows of MCUs. Differences
    are undone one iMCU row at a time (one MCU row interleaved, v rows of
    a component alone); an iMCU row that starts the scan, or in which a
    restart marker is read, starts with a first row."""
    comps = frame["comps"]
    specs = [(comps[cid], dc_tabs.get(td)) for cid, td, _ in scan]
    if any(t is None for _, t in specs):
        raise ValueError(f"{name}: scan names a missing Huffman table")
    if len(specs) > 1:
        per_row = -(-frame["width"] // frame["hmax"])
        rows = -(-frame["height"] // frame["vmax"])
        shapes = [(c["v"], c["h"]) for c, _ in specs]
    else:
        c = specs[0][0]
        per_row, rows, shapes = c["w"], c["h_px"], [(1, 1)]
    if interval % per_row:
        raise ValueError(f"{name}: restart interval {interval} is not a "
                         f"whole number of MCU rows of {per_row}")
    rows_per_seg = interval // per_row if interval else rows
    luts = [t for (_, t), (v, h) in zip(specs, shapes) for _ in range(v * h)]
    per_mcu = len(luts)
    flat = array("i", bytes(4 * per_mcu * per_row * rows))
    n = 0
    for seg_i, segment in enumerate(segments):
        todo = min(rows_per_seg, rows - seg_i * rows_per_seg) * per_row
        if todo <= 0:
            break
        peek = _peek16(segment)
        limit = 8 * len(segment)
        pos = 0
        for _ in range(todo):
            if pos > limit:
                raise ValueError(f"{name}: entropy-coded data ends early")
            for lut in luts:
                e = lut[peek[pos]]
                if not e:
                    raise ValueError(f"{name}: bad Huffman code")
                pos += e >> 8
                s = e & 255
                if s == 16:
                    flat[n] = 32768
                elif s:
                    v = peek[pos] >> (16 - s)
                    pos += s
                    flat[n] = v - (1 << s) + 1 if v < 1 << (s - 1) else v
                n += 1
    if n < len(flat):
        raise ValueError(f"{name}: lossless scan ends early")
    diffs = np.frombuffer(flat, np.int32).reshape(rows, per_row, per_mcu)
    k = 1 if len(specs) > 1 else specs[0][0]["v"]  # MCU rows an iMCU row
    restarts = range(rows_per_seg, rows, rows_per_seg)
    first_imcu = {0} | {r // k for r in restarts}
    off = 0
    for (c, _), (v, h) in zip(specs, shapes):
        d = diffs[:, :, off:off + v * h].reshape(rows, per_row, v, h)
        d = d.transpose(0, 2, 1, 3).reshape(rows * v, per_row * h)
        off += v * h
        first = {i * c["v"] for i in first_imcu}
        c["samples"] = _undifference(d[:c["h_px"], :c["w"]], predictor, pt,
                                     first)


def _undifference(d: np.ndarray, predictor: int, pt: int, first) -> np.ndarray:
    """jdlossls.c's undifferencers over differences [h, w]: rows in
    ``first`` from their left neighbour (the first sample from 2^(7 -
    pt)), the others' first sample from above and the rest by
    ``predictor``; every sum modulo 2^16, then scaled by 2^pt to 8 bits."""
    h, w = d.shape
    d = d.astype(np.int64)
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        row = d[y]
        if y in first:
            out[y] = (np.cumsum(row) + (1 << (7 - pt))) & 0xFFFF
            continue
        up = out[y - 1]
        if predictor in (2, 3) or w == 1:
            out[y, 0] = (row[0] + up[0]) & 0xFFFF
            if predictor == 2:
                out[y, 1:] = (row[1:] + up[1:]) & 0xFFFF
            elif w > 1:
                out[y, 1:] = (row[1:] + up[:-1]) & 0xFFFF
            continue
        if predictor in (1, 4, 5):  # linear in the left neighbour
            step = row.copy()
            if predictor == 4:
                step[1:] += up[1:] - up[:-1]
            elif predictor == 5:
                step[1:] += (up[1:] - up[:-1]) >> 1
            step[0] += up[0]
            out[y] = np.cumsum(step) & 0xFFFF
            continue
        ra = int(row[0] + up[0]) & 0xFFFF
        out[y, 0] = ra
        rl, ul = row.tolist(), up.tolist()
        vals = [ra]
        for x in range(1, w):
            rb, rc = ul[x], ul[x - 1]
            p = rb + ((ra - rc) >> 1) if predictor == 6 else (ra + rb) >> 1
            ra = (rl[x] + p) & 0xFFFF
            vals.append(ra)
        out[y] = vals
    return ((out << pt) & 0xFF).astype(np.uint8)


def _finish(frame, qt, jfif: bool, adobe, name) -> np.ndarray:
    """Dequantize and inverse-DCT (or take a lossless frame's samples),
    upsample and colour-convert."""
    planes = []
    comps = sorted(frame["comps"].items(), key=lambda kv: kv[1]["order"])
    lossless = frame["lossless"]
    for _, c in comps:
        if lossless:
            plane = c.get("samples")
            if plane is None:
                raise ValueError(f"{name}: component without a scan")
        else:
            if c["tq"] not in qt:
                raise ValueError(f"{name}: missing quantization table")
            coef = np.frombuffer(c["coef"], np.int32).reshape(-1, 64)
            px = _idct(coef.astype(np.int64) * qt[c["tq"]])
            px = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3)
            plane = px.reshape(c["bh"] * 8, c["bw"] * 8)[:c["h_px"], :c["w"]]
        up = _upsample(plane, ((frame["hmax"], c["h"]),
                               (frame["vmax"], c["v"])), not lossless, name)
        planes.append(up[:frame["height"], :frame["width"]])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = [cid for cid, _ in comps]
    if len(planes) == 4:  # CMYK, or YCCK with an Adobe transform
        if adobe:
            if lossless:
                raise ValueError(f"{name}: a lossless YCCK JPEG is not "
                                 "supported (libjpeg converts no colour "
                                 "of a lossless frame)")
            # ycck_cmyk_convert gives 255 - RGB, which CMYK;I inverts back.
            cmy = _ycc_rgb(*planes[:3])
            return np.concatenate(
                [cmy, (255 - planes[3]).astype(np.uint8)[..., None]], axis=2)
        return (255 - np.stack(planes, axis=-1)).astype(np.uint8)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = lossless or ids == [ord("R"), ord("G"), ord("B")]
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    if lossless:
        raise ValueError(f"{name}: a lossless YCbCr JPEG is not supported "
                         "(libjpeg converts no colour of a lossless frame)")
    return _ycc_rgb(*planes)


def decode_jpeg(data: bytes, name="<bytes>") -> np.ndarray:
    """A JPEG's bytes → uint8 [H, W] (one component), [H, W, 3] (RGB) or
    [H, W, 4] (CMYK, as Pillow's mode ``CMYK`` holds it): the samples
    Pillow gives (the module docstring)."""
    r = _read(data, name)
    return _finish(r["frame"], r["qt"], r["jfif"], r["adobe"], name)


def jpeg_coefficients(data: bytes, name="<bytes>") -> dict:
    """A DCT JPEG's quantized coefficients: {component id: int32 [blocks
    down, blocks across, 64] (natural order, the MCU grid's blocks)}."""
    frame = _read(data, name)["frame"]
    if frame["lossless"]:
        raise ValueError(f"{name}: a lossless JPEG holds no coefficients")
    return {cid: np.frombuffer(c["coef"], np.int32).reshape(
        c["bh"], c["bw"], 64).copy() for cid, c in frame["comps"].items()}
