"""Arithmetic-coded JPEG scans (SOF9 sequential, SOF10 progressive),
standard library only: T.81 Annex D's QM decoder and the statistics of
Annexes F.1.4 and G.1.3, decoded as libjpeg-turbo's ``jdarith.c`` does.

A scan's statistics bins start at zero at the scan's start and at each
restart marker; components that share a conditioning table share its
bins. DC statistics are conditioned on the table's (L, U) from DAC, AC
magnitudes on its Kx (defaults 0, 1 and 5). The coefficients go into the
components' ``coef`` as the Huffman scans of ``utils/jpeg.py`` put them.
"""
from __future__ import annotations

_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), and
# entry 113: the fixed probability 0.5 (T.851) of signs and DC refinement.
_QE = (
    0x5A1D, 0x2586, 0x1114, 0x080B, 0x03D8, 0x01DA, 0x00E5, 0x006F,
    0x0036, 0x001A, 0x000D, 0x0006, 0x0003, 0x0001, 0x5A7F, 0x3F25,
    0x2CF2, 0x207C, 0x17B9, 0x1182, 0x0CEF, 0x09A1, 0x072F, 0x055C,
    0x0406, 0x0303, 0x0240, 0x01B1, 0x0144, 0x00F5, 0x00B7, 0x008A,
    0x0068, 0x004E, 0x003B, 0x002C, 0x5AE1, 0x484C, 0x3A0D, 0x2EF1,
    0x261F, 0x1F33, 0x19A8, 0x1518, 0x1177, 0x0E74, 0x0BFB, 0x09F8,
    0x0861, 0x0706, 0x05CD, 0x04DE, 0x040F, 0x0363, 0x02D4, 0x025C,
    0x01F8, 0x01A4, 0x0160, 0x0125, 0x00F6, 0x00CB, 0x00AB, 0x008F,
    0x5B12, 0x4D04, 0x412C, 0x37D8, 0x2FE8, 0x293C, 0x2379, 0x1EDF,
    0x1AA9, 0x174E, 0x1424, 0x119C, 0x0F6B, 0x0D51, 0x0BB6, 0x0A40,
    0x5832, 0x4D1C, 0x438E, 0x3BDD, 0x34EE, 0x2EAE, 0x299A, 0x2516,
    0x5570, 0x4CA9, 0x44D9, 0x3E22, 0x3824, 0x32B4, 0x2E17, 0x56A8,
    0x4F46, 0x47E5, 0x41CF, 0x3C3D, 0x375E, 0x5231, 0x4C0F, 0x4639,
    0x415E, 0x5627, 0x50E7, 0x4B85, 0x5597, 0x504F, 0x5A10, 0x5522,
    0x59EB, 0x5A1D)
_NEXT_LPS = (
    1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38, 39,
    40, 42, 43, 45, 46, 48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33,
    37, 64, 65, 67, 68, 69, 70, 72, 73, 74, 75, 77, 78, 79, 48, 50, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83, 84, 86, 87,
    87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95,
    96, 97, 99, 99, 93, 95, 101, 102, 103, 104, 99, 105, 106, 107, 103,
    105, 108, 109, 110, 111, 110, 112, 112, 113)
# Next_Index_MPS is the next index but at the ends of the chains.
_MPS_TURNS = {13: 13, 35: 9, 63: 32, 79: 48, 87: 71, 94: 86, 100: 93,
              104: 99, 107: 103, 109: 107, 111: 109, 112: 111, 113: 113}
_NEXT_MPS = tuple(_MPS_TURNS.get(i, i + 1) for i in range(114))
_SWITCH = frozenset((0, 14, 36, 64, 80, 88, 95, 105, 110, 112))


def _states() -> tuple:
    """Per statistics byte (MPS << 7 | index): (Qe, the byte after an MPS,
    the byte after an LPS)."""
    out = []
    for sv in range(256):
        i, mps = sv & 0x7F, sv & 0x80
        if i > 113:
            out.append((0, 0, 0))
            continue
        lps_mps = mps ^ (0x80 if i in _SWITCH else 0)
        out.append((_QE[i], mps | _NEXT_MPS[i], lps_mps | _NEXT_LPS[i]))
    return tuple(out)


_STATE = _states()


class _QMDecoder:
    """jdarith.c's arith_decode over one restart segment (0xFF00 stuffing
    removed), zero bytes past its end, as libjpeg feeds them at a
    marker."""

    __slots__ = ("data", "pos", "a", "c", "ct")

    def __init__(self, segment: bytes):
        self.data, self.pos = segment, 0
        self.a, self.c, self.ct = 0, 0, -16  # reads two bytes first

    def decode(self, st: bytearray, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalization and input (D.2.6)
            ct -= 1
            if ct < 0:
                if self.pos < len(self.data):
                    c = (c << 8) | self.data[self.pos]
                    self.pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe, after_mps, after_lps = _STATE[sv]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = after_mps
            else:
                st[i] = after_lps
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = after_lps
                sv ^= 0x80
            else:
                st[i] = after_mps
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _bits(dec, stats, st: int, m: int) -> int:
    v = m
    m >>= 1
    while m:
        if dec.decode(stats, st):
            v |= m
        m >>= 1
    return v


def _dc_diff(dec, stats, ctx: dict, cid, L: int, U: int, name) -> int:
    """F.2.4.1: one DC difference of component ``cid`` (its conditioning
    category in ``ctx``)."""
    s0 = ctx.get(cid, 0)
    if not dec.decode(stats, s0):
        ctx[cid] = 0
        return 0
    sign = dec.decode(stats, s0 + 1)
    st = s0 + 2 + sign
    m = dec.decode(stats, st)
    if m:
        st = 20
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{name}: arithmetic-coded magnitude "
                                 "overflows")
            st += 1
    if m < (1 << L) >> 1:
        ctx[cid] = 0
    elif m > (1 << U) >> 1:
        ctx[cid] = 12 + 4 * sign
    else:
        ctx[cid] = 4 + 4 * sign
    v = _bits(dec, stats, st + 14, m) + 1
    return -v if sign else v


def _ac_value(dec, stats, st: int, k: int, kx: int, fixed, name) -> int:
    """F.2.4.2 from the sign on: the non-zero value at zigzag ``k``, ``st``
    its S0 bin's base 3 (k - 1)."""
    sign = dec.decode(fixed, 0)
    st += 2
    m = dec.decode(stats, st)
    if m and dec.decode(stats, st):
        m <<= 1
        st = 189 if k <= kx else 217
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{name}: arithmetic-coded magnitude "
                                 "overflows")
            st += 1
    v = _bits(dec, stats, st + 14, m) + 1
    return -v if sign else v


def _int16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def decode_arith_scan(segments, mcus, interval, scan, dac, name) -> None:
    """Decode one arithmetic-coded scan into the components' ``coef``.

    mcus: each MCU's blocks (component id, DC table, AC table,
    coefficients, block offset), ``interval`` MCUs (all, if 0) a restart
    segment; scan: (progressive, ss, se, ah, al); dac: {("dc", t): (L, U),
    ("ac", t): Kx}."""
    progressive, ss, se, ah, al = scan
    per_seg = interval if interval else len(mcus)
    zz = _ZIGZAG
    fixed = bytearray([113])
    p1, m1 = 1 << al, -1 << al
    for seg_i, segment in enumerate(segments):
        todo = mcus[seg_i * per_seg:(seg_i + 1) * per_seg]
        if not todo:
            break
        dec = _QMDecoder(segment)
        decode = dec.decode
        dc_stats, ac_stats, last, ctx = {}, {}, {}, {}
        for mcu in todo:
            for cid, td, ta, coef, base in mcu:
                if progressive and ss == 0 and ah:  # DC refine
                    if decode(fixed, 0):
                        coef[base] |= p1
                    continue
                if not progressive or ss == 0:  # DC (first)
                    stats = dc_stats.setdefault(td, bytearray(64))
                    L, U = dac.get(("dc", td), (0, 1))
                    v = _dc_diff(dec, stats, ctx, cid, L, U, name)
                    last[cid] = (last.get(cid, 0) + v) & 0xFFFF
                    coef[base] = _int16(last[cid] << al)
                    if progressive:
                        continue
                    lo, hi = 1, 63
                else:
                    lo, hi = ss, se
                stats = ac_stats.setdefault(ta, bytearray(256))
                kx = dac.get(("ac", ta), 5)
                if progressive and ah:  # AC refine (G.1.3.3)
                    kex = se
                    while kex > 0 and not coef[base + zz[kex]]:
                        kex -= 1
                    k = lo
                    while k <= hi:
                        st = 3 * (k - 1)
                        if k > kex and decode(stats, st):
                            break
                        while True:
                            z = base + zz[k]
                            c = coef[z]
                            if c:
                                if decode(stats, st + 2):
                                    coef[z] = c + (m1 if c < 0 else p1)
                                break
                            if decode(stats, st + 1):
                                coef[z] = m1 if decode(fixed, 0) else p1
                                break
                            st += 3
                            k += 1
                            if k > hi:
                                raise ValueError(f"{name}: coefficient past "
                                                 "the band")
                        k += 1
                    continue
                k = lo
                while k <= hi:  # AC (first): F.2.4.2
                    st = 3 * (k - 1)
                    if decode(stats, st):
                        break  # end of block
                    while not decode(stats, st + 1):
                        st += 3
                        k += 1
                        if k > hi:
                            raise ValueError(f"{name}: coefficient past the "
                                             "band")
                    v = _ac_value(dec, stats, st, k, kx, fixed, name)
                    coef[base + zz[k]] = v * p1 if progressive else v
                    k += 1
