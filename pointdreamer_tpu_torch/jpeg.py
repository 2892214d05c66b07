"""Baseline and progressive JPEG decoding in numpy, bit-equal to
libjpeg-turbo's default decode (what PIL's `Image.open(...).convert("RGB")`
returns):

- baseline and extended sequential Huffman frames (SOF0 / SOF1), 8-bit,
  one (grey) or three (YCbCr; RGB when an Adobe marker says so)
  components, interleaved or one scan a component, restart intervals,
  partial MCUs at any size; APPn and COM segments skipped;
- progressive Huffman frames (SOF2, jdphuff.c): DC first and refinement
  scans, AC first scans with end-of-band runs, AC refinement scans with
  their correction bits, one coefficient buffer across all scans and
  restart intervals.  libjpeg-turbo reads a multi-scan file whole before
  its output pass, so block smoothing (jdcoefct.c smoothing_ok) applies
  only when some low-frequency coefficient still lacks bits after the
  last scan; such a file raises NotImplementedError naming it;
- the ISLOW integer IDCT of jidctint.c (13-bit constants, two passes, the
  post-IDCT range-limit table of jdmaster.c);
- the fancy upsampling of jdsample.c: the h2v1 and h2v2 triangle filters
  (rounding biases 1 / 2 and 8 / 7, edge columns and rows repeated) and
  h1v2 (biases 1 / 2), box replication for other integer ratios;
- the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16) with
  the range limit.

Lossless, hierarchical and arithmetic-coded frames, 12-bit samples and
CMYK raise NotImplementedError naming what they are.

The Huffman decode is a Python loop over symbols (a 16-bit lookup table
a code table); dequantisation, IDCT, upsampling and colour conversion are
vectorised over all blocks.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_SOF_NAMES = {
    0xC3: "lossless Huffman (SOF3)",
    0xC5: "differential sequential Huffman (SOF5)",
    0xC6: "differential progressive Huffman (SOF6)",
    0xC7: "differential lossless Huffman (SOF7)",
    0xC9: "extended sequential arithmetic (SOF9)",
    0xCA: "progressive arithmetic (SOF10)",
    0xCB: "lossless arithmetic (SOF11)",
    0xCD: "differential sequential arithmetic (SOF13)",
    0xCE: "differential progressive arithmetic (SOF14)",
    0xCF: "differential lossless arithmetic (SOF15)",
}

# natural-order index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


# ---------------------------------------------------------------------------
# entropy decoding

def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """A 65536-entry lookup from the next 16 bits to (length << 8) |
    symbol (0: no code)."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = (length << 8) \
                | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded segments of a scan starting at `pos` (split at
    RSTn, byte stuffing removed) and the offset of the marker that ends
    it."""
    segs, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG: entropy-coded data runs past the end")
        b = data[i + 1]
        if b == 0x00 or b == 0xFF:
            pos = i + 1 if b == 0xFF else i + 2
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= b <= 0xD7:
            start = pos = i + 2
            continue
        return segs, i


def _decode_blocks(seg: bytes, units, dc_luts, ac_luts, preds, out_pos,
                   out_val) -> None:
    """Decode the data units `units` ((scan slot, block index * 64) a
    unit, in stream order) from one segment, appending each nonzero
    coefficient's flat index (block index * 64 + natural position) and
    value to its slot's lists."""
    a = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.int64)
    win = ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist()
    zz = ZIGZAG.tolist()
    p = 0
    for comp, base in units:
        dc, ac = dc_luts[comp], ac_luts[comp]
        append_pos, append_val = out_pos[comp].append, out_val[comp].append
        look = dc[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        if not look:
            raise ValueError("JPEG: bad Huffman code")
        p += look >> 8
        s = look & 0xFF
        diff = 0
        if s:
            diff = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
            p += s
            if diff < 1 << (s - 1):
                diff -= (1 << s) - 1
        preds[comp] += diff
        if preds[comp]:
            append_pos(base)
            append_val(preds[comp])
        k = 1
        while k < 64:
            look = ac[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
            if not look:
                raise ValueError("JPEG: bad Huffman code")
            p += look >> 8
            rs = look & 0xFF
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("JPEG: coefficient index past 63")
                v = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                append_pos(base + zz[k])
                append_val(v)
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


# ---------------------------------------------------------------------------
# ISLOW IDCT (jidctint.c), over [N, 8, 8] int64 blocks

CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c0, c1, c2, c3, c4, c5, c6, c7, shift):
    """One pass of the ISLOW butterfly on eight inputs (arrays), descaled
    by `shift` (the all-zero-AC shortcuts of jidctint.c give the same
    values)."""
    z1 = (c2 + c6) * F0541
    tmp2 = z1 - c6 * F1847
    tmp3 = z1 + c2 * F0765
    tmp0 = (c0 + c4) << CONST_BITS
    tmp1 = (c0 - c4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c7, c5, c3, c1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1175
    t0, t1, t2, t3 = t0 * F0298, t1 * F2053, t2 * F3072, t3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by (value & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_IDCT_LIMIT = _range_limit_table()


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [N, 64] (natural order) -> uint8 samples
    [N, 8, 8], bit for bit libjpeg's jpeg_idct_islow."""
    c = coef.reshape(-1, 8, 8).astype(np.int64)
    # pass 1: columns (the input's rows index frequency v)
    ws = np.stack(_idct_1d(*[c[:, k, :] for k in range(8)],
                           shift=CONST_BITS - PASS1_BITS), axis=1)
    # pass 2: rows
    out = np.stack(_idct_1d(*[ws[:, :, k] for k in range(8)],
                            shift=CONST_BITS + PASS1_BITS + 3), axis=2)
    return _IDCT_LIMIT[out & 1023]


# ---------------------------------------------------------------------------
# upsampling (jdsample.c) and colour (jdcolor.c)

def _clamped(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """x shifted by one along `axis` (+1: the next element), the edge
    element repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, hf: int, vf: int,
             fancy_width_ok: bool) -> np.ndarray:
    """A component plane [h, w] (its downsampled size) scaled by (vf, hf)
    with libjpeg's method for that ratio."""
    x = plane.astype(np.int64)
    if (hf, vf) == (1, 1):
        return plane
    if (hf, vf) == (2, 1) and fancy_width_ok:           # h2v1_fancy
        left = (3 * x + _clamped(x, 1, -1) + 1) >> 2
        right = (3 * x + _clamped(x, 1, 1) + 2) >> 2
        return _interleave(left, right, 1).astype(np.uint8)
    if (hf, vf) == (1, 2):                               # h1v2_fancy
        up = (3 * x + _clamped(x, 0, -1) + 1) >> 2
        down = (3 * x + _clamped(x, 0, 1) + 2) >> 2
        return _interleave(up, down, 0).astype(np.uint8)
    if (hf, vf) == (2, 2) and fancy_width_ok:           # h2v2_fancy
        rows = []
        for far in (_clamped(x, 0, -1), _clamped(x, 0, 1)):
            s = 3 * x + far                              # column sums
            left = (3 * s + _clamped(s, 1, -1) + 8) >> 4
            right = (3 * s + _clamped(s, 1, 1) + 7) >> 4
            rows.append(_interleave(left, right, 1))
        return _interleave(rows[0], rows[1], 0).astype(np.uint8)
    # h2v1 / h2v2 at a width of 2 or less, and any other integer ratio:
    # box replication (h2v1_upsample, h2v2_upsample, int_upsample)
    return np.repeat(np.repeat(plane, vf, axis=0), hf, axis=1)


def _ycc_tables():
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes -> uint8 [H, W, 3], jdcolor.c's ycc_rgb_convert."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the file

def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] (RGB) or [H, W, 1] (grey), as stored
    by libjpeg-turbo's default decode (see the module docstring)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List[int]] = {}
    frame = None
    restart = 0
    adobe_transform = None
    coefs = None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                                   # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        n, = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + n]
        pos += n
        if marker in _SOF_NAMES:
            raise NotImplementedError(
                f"JPEG {_SOF_NAMES[marker]} frames are not supported: "
                "baseline, extended sequential and progressive Huffman "
                "(SOF0/SOF1/SOF2) only")
        if marker in (0xC0, 0xC1, 0xC2):
            prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
            if prec != 8:
                raise NotImplementedError(
                    f"JPEG SOF{marker - 0xC0} with {prec}-bit samples: "
                    "8-bit only")
            if nc == 4:
                raise NotImplementedError("JPEG CMYK / YCCK (4 components)"
                                          " is not supported")
            if nc not in (1, 3):
                raise NotImplementedError(f"JPEG with {nc} components")
            if h == 0:
                raise NotImplementedError("JPEG with a DNL-defined height")
            comps = []
            for i in range(nc):
                cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * i)
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            if nc == 1:
                comps[0]["h"] = comps[0]["v"] = 1
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"] = -(-w * c["h"] // hmax)
                c["h_px"] = -(-h * c["v"] // vmax)
            frame = dict(h=h, w=w, comps=comps, hmax=hmax, vmax=vmax,
                         mcux=mcux, mcuy=mcuy, progressive=marker == 0xC2)
            if frame["progressive"]:
                coefs = [[0] * (c["bh"] * c["bw"] * 64) for c in comps]
                frame["coef_bits"] = [[-1] * 64 for _ in comps]
            else:
                coefs = [([], []) for _ in comps]
        elif marker == 0xC4:                                 # DHT
            o = 0
            while o < len(seg):
                tc_th = seg[o]
                counts = seg[o + 1:o + 17]
                m = sum(counts)
                huff[tc_th >> 4, tc_th & 15] = _huffman_lut(
                    counts, seg[o + 17:o + 17 + m])
                o += 17 + m
        elif marker == 0xDB:                                 # DQT
            o = 0
            while o < len(seg):
                pq, tq = seg[o] >> 4, seg[o] & 15
                if pq:
                    vals = np.frombuffer(seg, ">u2", 64, o + 1)
                    o += 129
                else:
                    vals = np.frombuffer(seg, np.uint8, 64, o + 1)
                    o += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
        elif marker == 0xDD:                                 # DRI
            restart, = struct.unpack_from(">H", seg, 0)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:                                 # SOS
            if frame is None:
                raise ValueError("JPEG: a scan before the frame header")
            scan = _scan_progressive if frame["progressive"] else _scan
            pos = scan(data, seg, pos, frame, huff, restart, coefs)
        # APPn, COM and anything else: skipped
    if frame is None:
        raise ValueError("JPEG: no frame")
    if frame["progressive"]:
        if smoothing_applies(frame, qt):
            raise NotImplementedError(
                "JPEG: a progressive file whose scans leave low-frequency "
                "coefficients incomplete, which libjpeg-turbo decodes with "
                "block smoothing (jdcoefct.c): not supported")
        dense = [np.asarray(c, np.int64) for c in coefs]
    else:
        dense = []
        for c, (p, v) in zip(frame["comps"], coefs):
            flat = np.zeros(c["bh"] * c["bw"] * 64, np.int64)
            flat[np.asarray(p, np.int64)] = np.asarray(v, np.int64)
            dense.append(flat)
    return _finish(frame, dense, qt, adobe_transform)


# natural-order positions of the DC and the first nine AC coefficients
# (jdcoefct.c's Q01_POS .. Q30_POS)
_SAVED = ZIGZAG[:10].tolist()


def smoothing_applies(frame, qt) -> bool:
    """jdcoefct.c smoothing_ok after the last scan: every component has a
    quantisation table with the ten first coefficients nonzero and some DC
    bits, and some component has a coefficient among zigzag 1..9 whose
    bits are incomplete (its last scan's Al is not 0, or no scan had
    it)."""
    useful = False
    for c, bits in zip(frame["comps"], frame["coef_bits"]):
        q = qt.get(c["tq"])
        if q is None or any(q[k] == 0 for k in _SAVED) or bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:10])
    return useful


def _scan_header(seg, frame):
    """(components as (index, DC table, AC table), Ss, Se, Ah, Al)."""
    ns = seg[0]
    by_id = {c["id"]: i for i, c in enumerate(frame["comps"])}
    sel = []
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"JPEG: a scan names component {cid}")
        sel.append((by_id[cid], t >> 4, t & 15))
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    return sel, ss, se, a >> 4, a & 15


def _scan_units(frame, sel):
    """The data units of a scan, a list per MCU of (scan slot, block
    index * 64): one component's blocks in raster order, or the
    interleaved MCUs."""
    comps = frame["comps"]
    units = []
    if len(sel) == 1:
        ci = sel[0][0]
        c = comps[ci]
        nbx, nby = -(-c["w"] // 8), -(-c["h_px"] // 8)
        for by in range(nby):
            for bx in range(nbx):
                units.append([(0, (by * c["bw"] + bx) * 64)])
    else:
        for my in range(frame["mcuy"]):
            for mx in range(frame["mcux"]):
                mcu = []
                for slot, (ci, _, _) in enumerate(sel):
                    c = comps[ci]
                    for v in range(c["v"]):
                        for h in range(c["h"]):
                            b = (my * c["v"] + v) * c["bw"] \
                                + mx * c["h"] + h
                            mcu.append((slot, b * 64))
                units.append(mcu)
    return units


def _scan(data, seg, pos, frame, huff, restart, coefs) -> int:
    sel, ss, se, _, _ = _scan_header(seg, frame)
    if ss != 0 or se != 63:
        raise NotImplementedError("JPEG: a spectral-selection scan "
                                  f"({ss}..{se}) in a sequential frame")
    units = _scan_units(frame, sel)
    segs, end = _segments(data, pos)
    per = restart or len(units)
    if len(segs) < -(-len(units) // per):
        raise ValueError("JPEG: fewer restart intervals than MCUs need")
    dc = [huff[0, td] for _, td, _ in sel]
    ac = [huff[1, ta] for _, _, ta in sel]
    pos_lists = [[] for _ in sel]
    val_lists = [[] for _ in sel]
    for k in range(0, len(units), per):
        flat = [u for mcu in units[k:k + per] for u in mcu]
        _decode_blocks(segs[k // per], flat, dc, ac, [0] * len(sel),
                       pos_lists, val_lists)
    for slot, (ci, _, _) in enumerate(sel):
        coefs[ci][0].extend(pos_lists[slot])
        coefs[ci][1].extend(val_lists[slot])
    return end


def _scan_progressive(data, seg, pos, frame, huff, restart, coefs) -> int:
    """One scan of a progressive frame (jdphuff.c: decode_mcu_DC_first,
    decode_mcu_DC_refine, decode_mcu_AC_first, decode_mcu_AC_refine) into
    the frame's coefficient buffers (natural order)."""
    sel, ss, se, ah, al = _scan_header(seg, frame)
    if ss == 0:
        if se != 0:
            raise ValueError("JPEG: a progressive DC scan with AC terms")
    elif len(sel) != 1 or se < ss or se > 63:
        raise ValueError(f"JPEG: a bad progressive AC scan ({ss}..{se})")
    if al > 13 or (ah and ah != al + 1):
        raise ValueError(f"JPEG: bad successive approximation {ah}/{al}")
    for ci, _, _ in sel:
        bits = frame["coef_bits"][ci]
        for k in range(ss, se + 1):
            bits[k] = al
    units = _scan_units(frame, sel)
    segs, end = _segments(data, pos)
    per = restart or len(units)
    if len(segs) < -(-len(units) // per):
        raise ValueError("JPEG: fewer restart intervals than MCUs need")
    bufs = [coefs[ci] for ci, _, _ in sel]
    if ss == 0:
        luts = [huff.get((0, td)) for _, td, _ in sel]
        if ah == 0 and any(t is None for t in luts):
            raise ValueError("JPEG: a scan uses an undefined Huffman table")
    else:
        luts = [huff.get((1, sel[0][2]))]
        if luts[0] is None:
            raise ValueError("JPEG: a scan uses an undefined Huffman table")
    for k in range(0, len(units), per):
        flat = [u for mcu in units[k:k + per] for u in mcu]
        a = np.frombuffer(segs[k // per] + b"\x00" * 4, np.uint8).astype(
            np.int64)
        win = ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist()
        if ss == 0 and ah == 0:
            _dc_first(win, flat, luts, bufs, al)
        elif ss == 0:
            _dc_refine(win, flat, bufs, al)
        elif ah == 0:
            _ac_first(win, flat, luts[0], bufs[0], ss, se, al)
        else:
            _ac_refine(win, flat, luts[0], bufs[0], ss, se, al)
    return end


def _dc_first(win, units, luts, bufs, al) -> None:
    preds = [0] * len(luts)
    p = 0
    for slot, base in units:
        look = luts[slot][(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        if not look:
            raise ValueError("JPEG: bad Huffman code")
        p += look >> 8
        s = look & 0xFF
        diff = 0
        if s:
            diff = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
            p += s
            if diff < 1 << (s - 1):
                diff -= (1 << s) - 1
        preds[slot] += diff
        bufs[slot][base] = preds[slot] << al


def _dc_refine(win, units, bufs, al) -> None:
    p1 = 1 << al
    p = 0
    for slot, base in units:
        if (win[p >> 3] >> (23 - (p & 7))) & 1:
            bufs[slot][base] |= p1
        p += 1


def _ac_first(win, units, lut, buf, ss, se, al) -> None:
    zz = ZIGZAG.tolist()
    eobrun = 0
    p = 0
    for _, base in units:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            look = lut[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
            if not look:
                raise ValueError("JPEG: bad Huffman code")
            p += look >> 8
            rs = look & 0xFF
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise ValueError("JPEG: coefficient index past 63")
                v = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                buf[base + zz[k]] = v << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) \
                        >> (16 - r)
                    p += r
                eobrun -= 1
                break
            k += 1


def _ac_refine(win, units, lut, buf, ss, se, al) -> None:
    zz = ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    p = 0
    for _, base in units:
        k = ss
        if eobrun == 0:
            while k <= se:
                look = lut[(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                if not look:
                    raise ValueError("JPEG: bad Huffman code")
                p += look >> 8
                rs = look & 0xFF
                r, s = rs >> 4, rs & 15
                if s:
                    # s != 1 is a corrupt stream libjpeg warns about
                    s = p1 if (win[p >> 3] >> (23 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += ((win[p >> 3] >> (8 - (p & 7)))
                                   & 0xFFFF) >> (16 - r)
                        p += r
                    break
                # skip r zero coefficients, refining the nonzero ones
                while k <= se:
                    i = base + zz[k]
                    c = buf[i]
                    if c:
                        if (win[p >> 3] >> (23 - (p & 7))) & 1 \
                                and not c & p1:
                            buf[i] = c + (p1 if c >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s and k <= 63:
                    buf[base + zz[k]] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                i = base + zz[k]
                c = buf[i]
                if c:
                    if (win[p >> 3] >> (23 - (p & 7))) & 1 and not c & p1:
                        buf[i] = c + (p1 if c >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


def _finish(frame, coefs, qt, adobe_transform) -> np.ndarray:
    h, w = frame["h"], frame["w"]
    planes = []
    for c, flat in zip(frame["comps"], coefs):
        # libjpeg holds coefficients as 16-bit JCOEF
        flat = flat.astype(np.int16).astype(np.int64)
        blocks = idct_islow(flat.reshape(-1, 64) * qt[c["tq"]])
        plane = blocks.reshape(c["bh"], c["bw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        plane = plane[:c["h_px"], :c["w"]]
        hf, vf = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        if frame["hmax"] % c["h"] or frame["vmax"] % c["v"]:
            raise NotImplementedError("JPEG: non-integer sampling ratios")
        planes.append(upsample(plane, hf, vf, c["w"] > 2)[:h, :w])
    if len(planes) == 1:
        return planes[0][..., None]
    rgb_ids = [c["id"] for c in frame["comps"]] == [82, 71, 66]
    if adobe_transform == 0 or rgb_ids:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


def main(argv=None) -> int:
    """`python -m pointdreamer_tpu_torch.jpeg FILE [--repeat N]`: decode
    FILE N times on the host and print its shape and the median seconds
    of a decode."""
    import argparse
    import time

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("file")
    parser.add_argument("--repeat", type=int, default=5)
    args = parser.parse_args(argv)
    with open(args.file, "rb") as f:
        data = f.read()
    times = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        img = decode_jpeg(data)
        times.append(time.perf_counter() - t0)
    print(f"{args.file}: {len(data)} bytes -> {img.shape} {img.dtype}; "
          f"decode {sorted(times)[len(times) // 2]:.4f} s (median of "
          f"{args.repeat}, host CPU)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
