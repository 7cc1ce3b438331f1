"""JPEG files that Pillow does not write, for the port's decoder tests;
numpy only.

- ``lossless``: lossless JPEG (SOF3), 8-bit: Huffman-coded differences of
  predictor 1-7, point transform ``pt``, restart intervals of whole MCU
  rows, one interleaved scan or a scan per component, any sampling
  factors. The first row of a scan and of each restart interval is
  predicted as libjpeg-turbo's ``jdlossls.c`` / ``jddiffct.c`` predict
  it, so a file decodes in Pillow to its (point-transformed) samples;
- ``dct``: a DCT file from quantized coefficients, Huffman-coded
  sequential (SOF1) or arithmetic-coded sequential (SOF9), with any
  sampling factors, markers and restart interval;
- ``to_arithmetic``: a Huffman file's coefficients, markers and scan
  script, arithmetic-coded (SOF9 or SOF10), as ``jpegtran -arithmetic``
  writes it; the coefficients are read by the port's
  ``path_tracer_torch.utils.jpeg.jpeg_coefficients``, so the tests hold
  each such file to Pillow: it decodes to the texels of its source;
- ``fdct``: quantized coefficients of a component's samples;
- ``ycbcr``: JFIF's RGB -> YCbCr, in floats.

The arithmetic coder is T.81 Annex D's QM coder, encoded as
libjpeg-turbo's ``jcarith.c`` does it, with the statistics and
conditioning of Annexes F.1.4 and G.1.3.
"""
from __future__ import annotations

import struct

import numpy as np

ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), and
# index 113, the fixed probability 0.5 of T.851.
_QM = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))

# Huffman tables: T.81 K.3's luminance DC lengths, then one code a length
# up to 14 bits: 17 categories for lossless (the 16 at 14 bits), 16 for a
# DCT file's DC; every AC symbol at 8 bits.
DC_COUNTS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0)
DC_SYMBOLS = tuple(range(17))
DCT_DC_COUNTS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0)
AC_SYMBOLS = (0x00, 0xF0) + tuple(r << 4 | s for r in range(16)
                                  for s in range(1, 11))
AC_COUNTS = (0,) * 7 + (len(AC_SYMBOLS),) + (0,) * 8


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


JFIF = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    """An Adobe APP14 marker with colour ``transform`` (0 none, 1 YCbCr,
    2 YCCK)."""
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                transform))


def _frame(code, width, height, comps) -> bytes:
    """SOFn of 8-bit samples; comps: (id, h, v, tq)."""
    body = struct.pack(">BHHB", 8, height, width, len(comps))
    for cid, h, v, tq in comps:
        body += bytes([cid, h << 4 | v, tq])
    return segment(code, body)


def _scan_header(sel, ss, se, ah, al) -> bytes:
    """SOS; sel: (id, DC table, AC table)."""
    body = bytes([len(sel)])
    for cid, td, ta in sel:
        body += bytes([cid, td << 4 | ta])
    return segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


def _dht(tc, th, counts, symbols) -> bytes:
    return segment(0xC4, bytes([tc << 4 | th, *counts, *symbols]))


def _codes(counts, symbols) -> dict:
    """symbol -> (code, length) of a Huffman table (T.81 Annex C)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    """A Huffman-coded segment: bits most significant first, 0xFF
    stuffed with 0x00, padded with 1 bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 255
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def done(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _magnitude(v: int) -> tuple:
    """(category, extra bits) of a difference or coefficient (F.1.2.1)."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


class _QMEncoder:
    """jcarith.c's arith_encode, emit and finish_pass; statistics bins are
    bytes: MPS << 7 | state index."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _flush_zeros(self) -> None:
        self.out += b"\x00" * self.zc
        self.zc = 0

    def _emit_stacked(self) -> None:
        """Output the buffered byte and every stacked 0xFF (no carry)."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._flush_zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self) -> None:
        if self.buffer >= 0:
            self._flush_zeros()
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nlps, nmps, switch = _QM[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = ((sv & 0x80) ^ (switch << 7)) | nlps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) | nmps
        while True:  # renormalization and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._emit_stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """Terminate the segment (D.1.8) and return its bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._emit_stacked()
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        out = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return out


class _ArithScan:
    """One arithmetic-coded scan's statistics and predictions."""

    def __init__(self, n_comps: int, dc_tbls, ac_tbls, dac: dict):
        self.enc = _QMEncoder()
        self.dc_tbls, self.ac_tbls, self.dac = dc_tbls, ac_tbls, dac
        self.fixed = bytearray([113])
        self.n = n_comps
        self.reset()

    def reset(self) -> None:
        self.dc_stats = {t: bytearray(64) for t in self.dc_tbls}
        self.ac_stats = {t: bytearray(256) for t in self.ac_tbls}
        self.last_dc = [0] * self.n
        self.ctx = [0] * self.n

    def dc(self, ci: int, tbl: int, v: int) -> None:
        """F.1.4.1: a DC difference ``v`` of scan component ``ci``."""
        e, stats = self.enc, self.dc_stats[tbl]
        s0 = self.ctx[ci]
        if v == 0:
            e.encode(stats, s0, 0)
            self.ctx[ci] = 0
            return
        e.encode(stats, s0, 1)
        if v > 0:
            e.encode(stats, s0 + 1, 0)
            st, self.ctx[ci] = s0 + 2, 4
        else:
            v = -v
            e.encode(stats, s0 + 1, 1)
            st, self.ctx[ci] = s0 + 3, 8
        m = 0
        v -= 1
        if v:
            e.encode(stats, st, 1)
            m, v2, st = 1, v, 20
            v2 >>= 1
            while v2:
                e.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        e.encode(stats, st, 0)
        lo, hi = self.dac.get(("dc", tbl), (0, 1))
        if m < (1 << lo) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << hi) >> 1:
            self.ctx[ci] += 8
        st += 14
        m >>= 1
        while m:
            e.encode(stats, st, 1 if m & v else 0)
            m >>= 1

    def ac_value(self, stats, st: int, k: int, v: int, kx: int) -> None:
        """F.1.4.3 from the sign on: a non-zero AC value at zigzag ``k``,
        ``st`` its S0 + 1 bin's base (3 (k - 1))."""
        e = self.enc
        e.encode(self.fixed, 0, 0 if v > 0 else 1)
        v = abs(v)
        st += 2
        m = 0
        v -= 1
        if v:
            e.encode(stats, st, 1)
            m, v2 = 1, v >> 1
            if v2:
                e.encode(stats, st, 1)
                m <<= 1
                st = 189 if k <= kx else 217
                v2 >>= 1
                while v2:
                    e.encode(stats, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
        e.encode(stats, st, 0)
        st += 14
        m >>= 1
        while m:
            e.encode(stats, st, 1 if m & v else 0)
            m >>= 1

    def ac(self, tbl: int, vals, ss: int, se: int) -> None:
        """F.1.4.2 / G.1.3.2: coefficients ``vals`` (zigzag, already
        point-transformed) of band ss..se."""
        e, stats = self.enc, self.ac_stats[tbl]
        kx = self.dac.get(("ac", tbl), 5)
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            e.encode(stats, st, 0)  # not the end of the block
            while vals[k] == 0:
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            e.encode(stats, st + 1, 1)
            self.ac_value(stats, st, k, vals[k], kx)
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, tbl: int, block, ss: int, se: int, ah: int,
                  al: int) -> None:
        """G.1.3.3: bit ``al`` of band ss..se of ``block`` (natural order,
        full coefficients)."""
        e, stats = self.enc, self.ac_stats[tbl]
        z = [block[ZIGZAG[k]] for k in range(64)]
        now = [abs(c) >> al for c in z]
        before = [abs(c) >> ah for c in z]
        ke = se
        while ke > 0 and not now[ke]:
            ke -= 1
        kex = ke
        while kex > 0 and not before[kex]:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                e.encode(stats, st, 0)
            while True:
                v = now[k]
                if v:
                    if v >> 1:  # already non-zero: its correction bit
                        e.encode(stats, st + 2, v & 1)
                    else:
                        e.encode(stats, st + 1, 1)
                        e.encode(self.fixed, 0, 1 if z[k] < 0 else 0)
                    break
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)


def layout(width, height, comps):
    """Per component: (samples wide, samples high, blocks across, blocks
    down of the MCU grid), and the MCU grid's columns and rows."""
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    out = []
    for c in comps:
        out.append((-(-width * c["h"] // hmax), -(-height * c["v"] // vmax),
                    mx * c["h"], my * c["v"]))
    return out, mx, my


def _mcus(width, height, comps, scan_comps):
    """Each MCU of a scan over ``scan_comps`` (indices into comps): a list
    of (scan position, component index, block row, block column)."""
    lay, mx, my = layout(width, height, comps)
    if len(scan_comps) == 1:
        ci = scan_comps[0]
        w, h = lay[ci][0], lay[ci][1]
        return [[(0, ci, by, bx)] for by in range(-(-h // 8))
                for bx in range(-(-w // 8))]
    out = []
    for y in range(my):
        for x in range(mx):
            mcu = []
            for pos, ci in enumerate(scan_comps):
                c = comps[ci]
                for v in range(c["v"]):
                    for h in range(c["h"]):
                        mcu.append((pos, ci, y * c["v"] + v, x * c["h"] + h))
            out.append(mcu)
    return out


def _arith_scan(width, height, comps, scan, interval, dac) -> bytes:
    """One arithmetic-coded scan's entropy-coded data, restart markers
    included. scan: (component indices, ss, se, ah, al, progressive)."""
    idx, ss, se, ah, al, progressive = scan
    dc_tbls = {comps[i]["td"] for i in idx}
    ac_tbls = {comps[i]["ta"] for i in idx}
    sc = _ArithScan(len(idx), dc_tbls, ac_tbls, dac)
    out = bytearray()
    mcus = _mcus(width, height, comps, idx)
    for n, mcu in enumerate(mcus):
        if interval and n and n % interval == 0:
            out += sc.enc.finish() + bytes([0xFF, 0xD0 + (n // interval - 1)
                                            % 8])
            sc.reset()
        for pos, ci, by, bx in mcu:
            c = comps[ci]
            block = [int(x) for x in c["coef"][by, bx]]
            if not progressive:
                sc.dc(pos, c["td"], block[0] - sc.last_dc[pos])
                sc.last_dc[pos] = block[0]
                sc.ac(c["ta"], [block[ZIGZAG[k]] for k in range(64)], 1, 63)
            elif ss == 0 and ah == 0:
                m = block[0] >> al
                sc.dc(pos, c["td"], m - sc.last_dc[pos])
                sc.last_dc[pos] = m
            elif ss == 0:
                sc.enc.encode(sc.fixed, 0, (block[0] >> al) & 1)
            elif ah == 0:
                z = [block[ZIGZAG[k]] for k in range(64)]
                vals = [(abs(x) >> al) * (1 if x >= 0 else -1) for x in z]
                sc.ac(c["ta"], vals, ss, se)
            else:
                sc.ac_refine(c["ta"], block, ss, se, ah, al)
    return bytes(out + sc.enc.finish())


def _huffman_scan(width, height, comps, idx, interval) -> bytes:
    """One sequential Huffman scan (the module's fixed tables)."""
    dc = _codes(DCT_DC_COUNTS, DC_SYMBOLS[:16])
    ac = _codes(AC_COUNTS, AC_SYMBOLS)
    out, bits = bytearray(), _Bits()
    pred = [0] * len(idx)
    for n, mcu in enumerate(_mcus(width, height, comps, idx)):
        if interval and n and n % interval == 0:
            out += bits.done() + bytes([0xFF, 0xD0 + (n // interval - 1) % 8])
            bits, pred = _Bits(), [0] * len(idx)
        for pos, ci, by, bx in mcu:
            block = comps[ci]["coef"][by, bx]
            z = [int(block[ZIGZAG[k]]) for k in range(64)]
            s, extra = _magnitude(z[0] - pred[pos])
            pred[pos] = z[0]
            bits.put(*dc[s])
            if s:
                bits.put(extra, s)
            run = 0
            for k in range(1, 64):
                if z[k] == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac[0xF0])
                    run -= 16
                s, extra = _magnitude(z[k])
                bits.put(*ac[run << 4 | s])
                bits.put(extra, s)
                run = 0
            if run:
                bits.put(*ac[0x00])
    return bytes(out + bits.done())


def _dac_segment(dac: dict) -> bytes:
    body = b""
    for (kind, tbl), val in sorted(dac.items()):
        if kind == "dc":
            body += bytes([tbl, val[1] << 4 | val[0]])
        else:
            body += bytes([16 + tbl, val])
    return segment(0xCC, body) if body else b""


def dct(comps, width, height, qtables, *, coding="huffman", interval=0,
        app=JFIF) -> bytes:
    """A sequential DCT JPEG of one interleaved scan (or a scan per
    component where ``comps`` hold ``"scan"`` numbers).

    comps: dicts of ``id``, ``h``, ``v``, ``tq``, ``coef`` [blocks down,
    blocks across, 64] (quantized, natural order, the whole MCU grid:
    ``layout``'s blocks), and for arithmetic coding ``td`` / ``ta``
    (conditioning tables, default 0). qtables: {tq: 64 values in natural
    order}. dac: {("dc", t): (L, U), ("ac", t): Kx}, written as a DAC
    marker; coding "huffman" (SOF1) or "arithmetic" (SOF9)."""
    comps = [dict(c) for c in comps]
    arith = coding == "arithmetic"
    for c in comps:
        c.setdefault("td", 0)
        c.setdefault("ta", 0)
    out = b"\xff\xd8" + app
    for tq, q in sorted(qtables.items()):
        zz = [int(q[ZIGZAG[k]]) for k in range(64)]
        out += segment(0xDB, bytes([tq, *zz]))
    out += _frame(0xC9 if arith else 0xC1, width, height,
                  [(c["id"], c["h"], c["v"], c["tq"]) for c in comps])
    if not arith:
        out += _dht(0, 0, DCT_DC_COUNTS, DC_SYMBOLS[:16])
        out += _dht(1, 0, AC_COUNTS, AC_SYMBOLS)
    if interval:
        out += segment(0xDD, struct.pack(">H", interval))
    groups = {}
    for i, c in enumerate(comps):
        groups.setdefault(c.get("scan", 0), []).append(i)
    for idx in groups.values():
        out += _scan_header([(comps[i]["id"], 0, 0) for i in idx], 0, 63, 0,
                            0)
        if arith:
            out += _arith_scan(width, height, comps, (idx, 0, 63, 0, 0,
                                                      False), interval, {})
        else:
            out += _huffman_scan(width, height, comps, idx, interval)
    return out + b"\xff\xd9"


def _markers(data: bytes):
    """(marker, body, start, end) of each marker segment of a JPEG, the
    entropy-coded data of a scan skipped."""
    pos = 2
    while True:
        while data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) or \
                0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
        marker = data[pos + 1]
        if marker == 0xD9:
            return
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, data[pos + 4:pos + 2 + length], pos, pos + 2 + length
        pos += 2 + length


def to_arithmetic(data: bytes, *, interval=None, dac=None) -> bytes:
    """A Huffman-coded JPEG (SOF0-SOF2) arithmetic-coded: its markers,
    quantization tables and scan script kept, DHT dropped, SOF0/1 -> SOF9
    and SOF2 -> SOF10, each scan's Huffman table numbers its conditioning
    tables'. ``interval`` replaces the restart interval (0: no restarts);
    dac: {("dc", t): (L, U), ("ac", t): Kx}, written as a DAC marker."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from path_tracer_torch.utils.jpeg import jpeg_coefficients

    coefs = jpeg_coefficients(data)
    out, comps, width, height, progressive = bytearray(b"\xff\xd8"), [], 0, 0, False
    cur_interval = 0
    for marker, body, start, end in _markers(data):
        if marker in (0xC0, 0xC1, 0xC2):
            progressive = marker == 0xC2
            _, height, width, nf = struct.unpack(">BHHB", body[:6])
            for k in range(nf):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq,
                                  coef=coefs[cid]))
            out += segment(0xCA if progressive else 0xC9, body)
            out += _dac_segment(dac or {})
            if interval is not None:
                cur_interval = interval
                if interval:
                    out += segment(0xDD, struct.pack(">H", interval))
        elif marker == 0xC4:
            continue
        elif marker == 0xDD:
            if interval is None:
                (cur_interval,) = struct.unpack(">H", body)
                out += data[start:end]
        elif marker == 0xDA:
            ns = body[0]
            ids = [body[1 + 2 * j] for j in range(ns)]
            tabs = [(body[2 + 2 * j] >> 4, body[2 + 2 * j] & 15)
                    for j in range(ns)]
            ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
            ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
            idx = [next(i for i, c in enumerate(comps) if c["id"] == cid)
                   for cid in ids]
            for i, (t_dc, t_ac) in zip(idx, tabs):
                comps[i]["td"], comps[i]["ta"] = t_dc, t_ac
            out += _scan_header([(comps[i]["id"], comps[i]["td"],
                                  comps[i]["ta"]) for i in idx], ss, se, ah,
                                al)
            out += _arith_scan(width, height, comps,
                               (idx, ss, se, ah, al, progressive),
                               cur_interval, dac or {})
        else:
            out += data[start:end]
    return bytes(out + b"\xff\xd9")


def lossless(components, factors, width, height, predictor: int, *,
             pt: int = 0, restart_rows: int = 0, interleaved: bool = True,
             ids=None, app=b"") -> bytes:
    """A lossless JPEG (SOF3) of 8-bit samples.

    components: uint8 arrays, each [ceil(height v / vmax), ceil(width h /
    hmax)] for its sampling factors (h, v) in ``factors``; a sample is
    coded as ``sample >> pt``. restart_rows: MCU rows a restart interval
    (0: none). ids: component ids (default 1, 2, ...); app: the markers
    after SOI (say ``JFIF`` or ``adobe(0)``)."""
    nf = len(components)
    ids = list(ids or range(1, nf + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    planes = []
    for x, (h, v) in zip(components, factors):
        x = np.asarray(x, np.int64) >> pt
        assert x.shape == (-(-height * v // vmax), -(-width * h // hmax)), \
            x.shape
        planes.append(x)
    out = b"\xff\xd8" + app + _frame(
        0xC3, width, height, [(cid, h, v, 0) for cid, (h, v) in
                              zip(ids, factors)])
    out += _dht(0, 0, DC_COUNTS, DC_SYMBOLS)
    for idx in ([list(range(nf))] if interleaved else [[i] for i in
                                                       range(nf)]):
        if len(idx) > 1:
            per_row, rows = -(-width // hmax), -(-height // vmax)
            shapes, k = [factors[i] for i in idx], 1
        else:
            rows, per_row = planes[idx[0]].shape
            shapes, k = [(1, 1)], factors[idx[0]][1]
        out += segment(0xDD, struct.pack(">H", restart_rows * per_row))
        out += _scan_header([(ids[i], 0, 0) for i in idx], predictor, 0, 0,
                            pt)
        step = restart_rows or rows
        # libjpeg's rule: an iMCU row (k MCU rows) during which the scan
        # starts or a restart marker is read begins with a first row.
        first_imcu = {r // k for r in range(0, rows, step)}
        mcu = []  # per MCU row and column, the samples' differences
        for i, (h, v) in zip(idx, shapes):
            d = _differences(planes[i], predictor, pt,
                             {j * factors[i][1] for j in first_imcu})
            pad = np.zeros((rows * v, per_row * h), np.int64)
            pad[:d.shape[0], :d.shape[1]] = d
            mcu.append(pad.reshape(rows, v, per_row, h).transpose(
                0, 2, 1, 3).reshape(rows, per_row, v * h))
        diffs = np.concatenate(mcu, axis=2)
        for r in range(0, rows, step):
            if r:
                out += bytes([0xFF, 0xD0 + (r // step - 1) % 8])
            out += _pack_differences(diffs[r:r + step].ravel())
    return out + b"\xff\xd9"


def _differences(x: np.ndarray, predictor: int, pt: int, first) -> np.ndarray:
    """Each sample's difference from its prediction (H.1.2.1; rows in
    ``first`` predicted as a scan's first row), as signed 16-bit."""
    h, w = x.shape
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    p = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
         rb + ((ra - rc) >> 1), (ra + rb) >> 1)[predictor - 1].copy()
    p[:, 0] = rb[:, 0]
    rows = sorted(first)
    p[rows] = ra[rows]
    p[rows, 0] = 1 << (8 - pt - 1)
    d = (x - p) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def _pack_differences(d: np.ndarray) -> bytes:
    """One restart interval's differences Huffman-coded (the lossless
    table), padded with 1 bits and 0xFF stuffed."""
    ad = np.abs(d)
    s = np.where(ad > 0, np.floor(np.log2(np.maximum(ad, 1))).astype(
        np.int64) + 1, 0)
    s[d == 32768] = 16
    codes = _codes(DC_COUNTS, DC_SYMBOLS)
    code = np.array([codes[k][0] for k in range(17)])[s]
    clen = np.array([codes[k][1] for k in range(17)])[s]
    extra = np.where(d >= 0, d, d + (1 << s) - 1) & ((1 << s) - 1)
    nbits = np.where(s == 16, 0, s)
    value = (code << nbits) | np.where(s == 16, 0, extra)
    length = clen + nbits
    j = np.arange(int(length.max(initial=1)))
    take = j[None, :] < length[:, None]
    shift = np.maximum(length[:, None] - 1 - j[None, :], 0)
    bits = ((value[:, None] >> shift) & 1)[take].astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-bits.size) % 8, np.uint8)])
    raw = np.packbits(bits)
    ff = np.flatnonzero(raw == 0xFF)
    return np.insert(raw, ff + 1, 0).tobytes()


def fdct(plane: np.ndarray, q, blocks_down: int, blocks_across: int):
    """A component's samples [h, w], edge-replicated to the MCU grid's
    ``blocks_down`` x ``blocks_across`` blocks, forward-DCT'd (T.81
    A.3.3, in floats) and quantized by ``q`` (64, natural order) with
    rounding: int [blocks down, blocks across, 64]."""
    x = np.asarray(plane, np.float64)
    h, w = x.shape
    x = np.pad(x, ((0, 8 * blocks_down - h), (0, 8 * blocks_across - w)),
               mode="edge") - 128.0
    u = np.arange(8)
    m = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    b = x.reshape(blocks_down, 8, blocks_across, 8).transpose(0, 2, 1, 3)
    f = m @ b @ m.T
    return np.round(f.reshape(blocks_down, blocks_across, 64)
                    / np.asarray(q, np.float64)).astype(np.int64)


def ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr [H, W, 3] float64."""
    r, g, b = (np.asarray(rgb, np.float64)[..., i] for i in range(3))
    return np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                     -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                     0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
