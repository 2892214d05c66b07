"""JPEG 2000 tier-1 decoding (ITU-T T.800 Annexes C and D), as OpenJPEG
2.5 decodes a code-block: the MQ decoder (the 47-state table; each
segment read with 0xFF 0xFF after it), the raw segments of the bypass
mode, and the three passes over stripes of four rows: significance
propagation, magnitude refinement and cleanup with its run-length mode,
on the 19 contexts (9 zero coding, 5 sign, 3 refinement, run-length,
uniform), sign prediction, and the code-block styles: bypass, context
reset, termination on each pass, vertically causal contexts, predictable
termination (nothing for a decoder to do) and segmentation symbols.

Values come out as OpenJPEG holds them: sign and magnitude with one
fraction bit, each coefficient put at the midpoint of its interval
(`oneplushalf`), then the max-shift ROI undone.
"""
from __future__ import annotations

from typing import List, Sequence

from .j2k_codestream import BYPASS, RESET, SEGSYM, VSC

# (Qe, next state on an MPS, next state on an LPS, switch the MPS)
_QE_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
# a context's state as 2 * table index + MPS
_QE = [_QE_TABLE[s >> 1][0] for s in range(94)]
_NMPS = [2 * _QE_TABLE[s >> 1][1] + (s & 1) for s in range(94)]
_NLPS = [2 * _QE_TABLE[s >> 1][2] + ((s & 1) ^ _QE_TABLE[s >> 1][3])
         for s in range(94)]

_ZC, _SC, _MAG, _AGG, _UNI = 0, 9, 14, 17, 18
# the neighbour bits of a sample: significance of its 8 neighbours, then
# the signs (1 = negative) of its significant 4-neighbours
_NW, _N, _NE, _W, _E, _SW, _S, _SE = 1, 2, 4, 8, 16, 32, 64, 128
_NNEG, _SNEG, _WNEG, _ENEG = 256, 512, 1024, 2048


def _zc_context(f: int, orient: int) -> int:
    h = bool(f & _W) + bool(f & _E)
    v = bool(f & _N) + bool(f & _S)
    d = bool(f & _NW) + bool(f & _NE) + bool(f & _SW) + bool(f & _SE)
    if orient == 1:                         # HL: vertical first
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d == 0:
            return (0, 1, 2)[min(hv, 2)]
        if d == 1:
            return (3, 4, 5)[min(hv, 2)]
        if d == 2:
            return 6 if hv == 0 else 7
        return 8
    if h == 0:
        if v == 0:
            return (0, 1, 2)[min(d, 2)]
        return 3 if v == 1 else 4
    if h == 1:
        if v == 0:
            return 5 if d == 0 else 6
        return 7
    return 8


_ZC_LUT = [[_zc_context(f, o) for f in range(256)] for o in range(4)]


def _sc_entry(f: int) -> int:
    def contribution(sig, neg):
        return 0 if not f & sig else (-1 if f & neg else 1)
    h = max(-1, min(1, contribution(_W, _WNEG) + contribution(_E, _ENEG)))
    v = max(-1, min(1, contribution(_N, _NNEG) + contribution(_S, _SNEG)))
    ctx, xor = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
                (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
                (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}[h, v]
    return 2 * ctx + xor


_SC_LUT = [_sc_entry(f) for f in range(4096)]


def decode_block(data: bytes, segs: Sequence[Sequence[int]], w: int, h: int,
                 orient: int, numbps: int, roishift: int, style: int
                 ) -> List[int]:
    """One code-block: `segs` the (passes, length) of each segment of
    `data`; the values row by row (w x h), OpenJPEG's datap."""
    w2 = w + 2
    size = w2 * (h + 2)
    f = [0] * size              # neighbour bits
    sig = [0] * size
    visited = [0] * size        # coded in this bit-plane's first pass
    refined = [0] * size
    val = [0] * size
    zc = _ZC_LUT[orient]
    sc = _SC_LUT
    vsc = bool(style & VSC)
    cx = [0] * 19

    def reset():
        for k in range(19):
            cx[k] = 0
        cx[_UNI] = 2 * 46
        cx[_AGG] = 2 * 3
        cx[_ZC] = 2 * 4

    reset()
    # the samples in stripe order: per stripe, per column, its rows
    order = []
    for y0 in range(0, h, 4):
        for x in range(w):
            col = [(y + 1) * w2 + x + 1 for y in range(y0, min(y0 + 4, h))]
            order.append((col, y0 + 4 <= h))
    buf = b""
    a = c = ct = bp = 0

    def mq(k):
        nonlocal a, c, ct, bp
        s = cx[k]
        qe = _QE[s]
        a -= qe
        if (c >> 16) < qe:
            if a < qe:
                d = s & 1
                cx[k] = _NMPS[s]
            else:
                d = (s & 1) ^ 1
                cx[k] = _NLPS[s]
            a = qe
        elif a & 0x8000:
            c -= qe << 16
            return s & 1
        else:
            c -= qe << 16
            if a < qe:
                d = (s & 1) ^ 1
                cx[k] = _NLPS[s]
            else:
                d = s & 1
                cx[k] = _NMPS[s]
        while True:
            if ct == 0:
                if buf[bp] == 0xFF:
                    if buf[bp + 1] > 0x8F:
                        c += 0xFF00
                        ct = 8
                    else:
                        bp += 1
                        c += buf[bp] << 9
                        ct = 7
                else:
                    bp += 1
                    c += buf[bp] << 8
                    ct = 8
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a & 0x8000:
                return d

    def raw():
        nonlocal c, ct, bp
        if ct == 0:
            if c == 0xFF:
                if buf[bp] > 0x8F:
                    c, ct = 0xFF, 8
                else:
                    c, ct = buf[bp], 7
                    bp += 1
            else:
                c, ct = buf[bp], 8
                bp += 1
        ct -= 1
        return (c >> ct) & 1

    def significant(i, neg, first_row):
        sig[i] = 1
        f[i - 1] |= _E | (_ENEG if neg else 0)
        f[i + 1] |= _W | (_WNEG if neg else 0)
        if not (vsc and first_row):
            u = i - w2
            f[u - 1] |= _SE
            f[u] |= _S | (_SNEG if neg else 0)
            f[u + 1] |= _SW
        u = i + w2
        f[u - 1] |= _NE
        f[u] |= _N | (_NNEG if neg else 0)
        f[u + 1] |= _NW

    tops = {col[0] for col, _ in order}          # each stripe's first row

    def sigpass(one_half, is_raw):
        for col, _ in order:
            for i in col:
                if sig[i] or not f[i] & 0xFF:
                    continue
                if is_raw:
                    if raw():
                        neg = raw()
                        val[i] = -one_half if neg else one_half
                        significant(i, neg, i in tops)
                else:
                    if mq(zc[f[i] & 0xFF]):
                        e = sc[f[i] & 0xFFF]
                        neg = mq(e >> 1) ^ (e & 1)
                        val[i] = -one_half if neg else one_half
                        significant(i, neg, i in tops)
                visited[i] = 1

    def refpass(half, is_raw):
        for col, _ in order:
            for i in col:
                if not sig[i] or visited[i]:
                    continue
                if is_raw:
                    v = raw()
                else:
                    v = mq(16 if refined[i] else (15 if f[i] & 0xFF else 14))
                if v ^ (val[i] < 0):
                    val[i] += half
                else:
                    val[i] -= half
                refined[i] = 1

    def cleanup(one_half):
        for col, full in order:
            start = 0
            if full:
                i0, i1, i2, i3 = col
                if not (f[i0] | f[i1] | f[i2] | f[i3]):
                    if not mq(_AGG):
                        continue
                    start = (mq(_UNI) << 1) | mq(_UNI)
                    i = col[start]
                    e = sc[f[i] & 0xFFF]
                    neg = mq(e >> 1) ^ (e & 1)
                    val[i] = -one_half if neg else one_half
                    significant(i, neg, start == 0)
                    start += 1
            for i in col[start:]:
                if sig[i] or visited[i]:
                    visited[i] = 0
                    continue
                if mq(zc[f[i] & 0xFF]):
                    e = sc[f[i] & 0xFFF]
                    neg = mq(e >> 1) ^ (e & 1)
                    val[i] = -one_half if neg else one_half
                    significant(i, neg, i in tops)
        if style & SEGSYM:
            mq(_UNI)
            mq(_UNI)
            mq(_UNI)
            mq(_UNI)

    bpno = roishift + numbps
    passtype = 2
    pos = 0
    for passes, length in segs:
        seg_raw = bool(style & BYPASS) and passtype < 2 and \
            bpno <= numbps - 4
        buf = bytes(data[pos:pos + length]) + b"\xff\xff"
        pos += length
        if seg_raw:
            c = ct = bp = 0
        else:
            bp = 0
            c = buf[0] << 16
            if buf[0] == 0xFF:
                if buf[1] > 0x8F:
                    c += 0xFF00
                    ct = 8
                else:
                    bp = 1
                    c += buf[1] << 9
                    ct = 7
            else:
                bp = 1
                c += buf[1] << 8
                ct = 8
            c <<= 7
            ct -= 7
            a = 0x8000
        for _ in range(passes):
            if bpno < 1:
                break
            one = 1 << bpno
            if passtype == 0:
                sigpass(one | (one >> 1), seg_raw)
            elif passtype == 1:
                refpass(one >> 1, seg_raw)
            else:
                cleanup(one | (one >> 1))
            if style & RESET and not seg_raw:
                reset()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = [0] * (w * h)
    for y in range(h):
        out[y * w:(y + 1) * w] = val[(y + 1) * w2 + 1:(y + 1) * w2 + 1 + w]
    if roishift:
        if roishift >= 31:
            return [0] * (w * h)
        thresh = 1 << roishift
        for k, v in enumerate(out):
            m = -v if v < 0 else v
            if m >= thresh:
                m >>= roishift
                out[k] = -m if v < 0 else m
    return out
