"""JPEG decoding in numpy, bit-equal to libjpeg-turbo 3.1's default
decode as PIL 12.1 asks for it (`Image.open(...)`: mode "L", "RGB" or
"CMYK"):

- baseline and extended sequential Huffman frames (SOF0 / SOF1), 8-bit,
  one (grey), three (YCbCr; RGB by the JFIF, Adobe and component-id rules
  of jdapimin.c default_decompress_parms) or four components (CMYK, or
  YCCK when an Adobe marker's transform is not 0: jdcolor.c
  ycck_cmyk_convert, YCbCr's tables with K passed through; PIL reads
  both with rawmode "CMYK;I", inverted), any sampling factors,
  interleaved or one scan a component, restart intervals, partial MCUs at
  any size; APPn and COM segments skipped;
- progressive Huffman frames (SOF2, jdphuff.c): DC first and refinement
  scans, AC first scans with end-of-band runs, AC refinement scans with
  their correction bits, one coefficient buffer across all scans and
  restart intervals;
- arithmetic-coded sequential and progressive frames (SOF9 / SOF10,
  jdarith.c): the QM decoder and its probability-state table, DC and AC
  conditioning (DAC segments, defaults L 0, U 1, Kx 5), the statistics
  reset at each scan and restart;
- block smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo 2.1
  and later: a 5 x 5 DC neighbourhood, the DC itself re-estimated when no
  AC coefficient has bits) where a progressive file's last scan leaves
  some of the first nine AC coefficients incomplete (smoothing_ok);
- lossless Huffman frames (SOF3, jdlhuff.c / jdlossls.c): predictors 1 to
  7, the point transform, restart intervals of whole MCU rows, box
  upsampling and no colour conversion (a JFIF or Adobe-transform frame
  raises, as libjpeg-turbo refuses it);
- the ISLOW integer IDCT of jidctint.c (13-bit constants, two passes, the
  post-IDCT range-limit table of jdmaster.c);
- the fancy upsampling of jdsample.c: the h2v1 and h2v2 triangle filters
  (rounding biases 1 / 2 and 8 / 7, edge columns and rows repeated) and
  h1v2 (biases 1 / 2), box replication for other integer ratios;
- the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16) with
  the range limit.

Hierarchical (differential) and lossless arithmetic frames and samples of
other than 8 bits raise NotImplementedError naming what they are: PIL
refuses each of them too.

The entropy decoders are Python loops over symbols (Huffman: a 16-bit
lookup table a code table; arithmetic: one call a binary decision);
dequantisation, smoothing, IDCT, upsampling and colour conversion are
vectorised over all blocks.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from .imagemode import ModeImage, natural

_SOF_NAMES = {
    0xC5: "differential sequential Huffman (SOF5)",
    0xC6: "differential progressive Huffman (SOF6)",
    0xC7: "differential lossless Huffman (SOF7)",
    0xCB: "lossless arithmetic (SOF11)",
    0xCD: "differential sequential arithmetic (SOF13)",
    0xCE: "differential progressive arithmetic (SOF14)",
    0xCF: "differential lossless arithmetic (SOF15)",
}
# the frames read here: (progressive, arithmetic, lossless)
_SOF_KINDS = {0xC0: (False, False, False), 0xC1: (False, False, False),
              0xC2: (True, False, False), 0xC3: (False, False, True),
              0xC9: (False, True, False), 0xCA: (True, True, False)}


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

def read_jpeg(data: bytes) -> dict:
    """Parse a JPEG and decode its entropy-coded data: {"frame", "qt",
    "coefs" (a component's quantised coefficients, dense, natural order a
    block; for a lossless frame its samples [rows, cols]), "adobe"
    (the Adobe transform or None), "jfif"}."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List[int]] = {}
    # arithmetic conditioning (DAC): DC (L, U) and AC K per table
    cond = {"dc": [(0, 1)] * 4, "ac": [5] * 4}
    frame = None
    restart = 0
    adobe_transform = None
    jfif = False
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
                f"JPEG {_SOF_NAMES[marker]} frames are not supported, as "
                "libjpeg-turbo does not decode them either: baseline, "
                "extended sequential, progressive and lossless Huffman, "
                "sequential and progressive arithmetic only")
        if marker in _SOF_KINDS:
            prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
            if prec != 8:
                raise NotImplementedError(
                    f"JPEG SOF{marker - 0xC0} with {prec}-bit samples: "
                    "8-bit only, as PIL")
            if nc not in (1, 3, 4):
                raise NotImplementedError(f"JPEG with {nc} components")
            if h == 0:
                raise NotImplementedError("JPEG with a DNL-defined height")
            comps = []
            for i in range(nc):
                cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * i)
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq, "v_sof": hv & 15})
            if nc == 1:
                comps[0]["h"] = comps[0]["v"] = 1
            if any(not 1 <= c["h"] <= 4 or not 1 <= c["v"] <= 4
                   for c in comps):
                raise ValueError("JPEG: a bad sampling factor")
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            progressive, arith, lossless = _SOF_KINDS[marker]
            unit = 1 if lossless else 8                  # samples a block
            mcux, mcuy = -(-w // (unit * hmax)), -(-h // (unit * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"] = -(-w * c["h"] // hmax)
                c["h_px"] = -(-h * c["v"] // vmax)
            frame = dict(h=h, w=w, comps=comps, hmax=hmax, vmax=vmax,
                         mcux=mcux, mcuy=mcuy, progressive=progressive,
                         arith=arith, lossless=lossless, unit=unit)
            if lossless:
                coefs = [np.zeros((c["bh"], c["bw"]), np.int64)
                         for c in comps]
            elif progressive or arith:
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
        elif marker == 0xCC:                                 # DAC
            for o in range(0, len(seg) - 1, 2):
                tc_tb, val = seg[o], seg[o + 1]
                if tc_tb >> 4:
                    cond["ac"][tc_tb & 3] = val
                else:
                    if (val & 15) > (val >> 4):
                        raise ValueError(f"JPEG: bad DAC value {val}")
                    cond["dc"][tc_tb & 3] = (val & 15, val >> 4)
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
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:                                 # SOS
            if frame is None:
                raise ValueError("JPEG: a scan before the frame header")
            if frame["lossless"]:
                pos = _scan_lossless(data, seg, pos, frame, huff, restart,
                                     coefs)
            elif frame["arith"]:
                pos = _scan_arith(data, seg, pos, frame, cond, restart,
                                  coefs)
            elif frame["progressive"]:
                pos = _scan_progressive(data, seg, pos, frame, huff,
                                        restart, coefs)
            else:
                pos = _scan(data, seg, pos, frame, huff, restart, coefs)
        # APPn, COM and anything else: skipped
    if frame is None:
        raise ValueError("JPEG: no frame")
    if frame["progressive"] or frame["arith"]:
        coefs = [np.asarray(c, np.int64) for c in coefs]
    elif not frame["lossless"]:
        dense = []
        for c, (p, v) in zip(frame["comps"], coefs):
            flat = np.zeros(c["bh"] * c["bw"] * 64, np.int64)
            flat[np.asarray(p, np.int64)] = np.asarray(v, np.int64)
            dense.append(flat)
        coefs = dense
    return dict(frame=frame, qt=qt, coefs=coefs, adobe=adobe_transform,
                jfif=jfif)


def jpeg_planes(data: bytes):
    """JPEG bytes -> (read_jpeg's dict, a uint8 plane a component): for a
    DCT frame each at the image's size (IDCT, smoothing, fancy
    upsampling), before any colour conversion; for a lossless frame each
    at its own sampled size."""
    j = read_jpeg(data)
    frame, qt, coefs = j["frame"], j["qt"], j["coefs"]
    if frame["lossless"]:
        return j, [p[:c["h_px"], :c["w"]] for c, p in zip(frame["comps"],
                                                            coefs)]
    if frame["progressive"] and smoothing_applies(frame, qt):
        coefs = smooth_blocks(frame, qt, coefs)
    return j, _planes(frame, coefs, qt)


def decode_jpeg_image(data: bytes) -> ModeImage:
    """JPEG bytes -> the image in PIL's mode: "L", "RGB" or "CMYK" (PIL's
    rawmode "CMYK;I": libjpeg's CMYK output inverted), as libjpeg-turbo
    decodes it (see the module docstring)."""
    j, planes = jpeg_planes(data)
    return _colour(j["frame"], planes, j["adobe"], j["jfif"])


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] (RGB; CMYK converted as PIL's
    convert("RGB") converts it) or [H, W, 1] (grey), as libjpeg-turbo
    decodes it (see the module docstring)."""
    return natural(decode_jpeg_image(data))


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


def smooth_blocks(frame, qt, coefs) -> List[np.ndarray]:
    """libjpeg-turbo's block smoothing (jdcoefct.c decompress_smooth_data,
    2.1 and later): each block's still-zero first AC coefficients
    (zigzag 1..9) whose bits are incomplete are estimated from the DC
    values of the 5 x 5 blocks around it (edges repeated), with the DC
    itself re-estimated when no AC coefficient of the component has any
    bits.  The estimate is clamped below 1 << Al of its last scan.  The
    row neighbours follow the library's iMCU-row bookkeeping, which on the
    last iMCU row of a component with v > 1 and a partial row of blocks
    counts rows as if that iMCU row were as short in every row."""
    out = []
    # iMCU rows as libjpeg counts them, from the frame header's factors
    total = -(-frame["h"] // (8 * max(c["v_sof"] for c in frame["comps"])))
    for c, flat, bits in zip(frame["comps"], coefs, frame["coef_bits"]):
        q = qt[c["tq"]]
        v = c["v_sof"]
        bw, bh = c["bw"], c["bh"]
        blocks = flat.astype(np.int16).astype(np.int64).reshape(bh, bw, 64)
        if total * v > bh:
            # a one-component frame with v > 1: libjpeg's buffer holds
            # whole iMCU rows, the rows no scan reaches zero
            blocks = np.concatenate([blocks, np.zeros(
                (total * v - bh, bw, 64), np.int64)])
        wb = -(-c["w"] // 8)                         # width_in_blocks
        hb = -(-c["h_px"] // 8)                      # height_in_blocks
        change_dc = all(b == -1 for b in bits[1:10])
        # the rows each block row reads: R-2, R-1, R, R+1, R+2
        rows = np.zeros((hb, 5), np.int64)
        for r in range(total):
            block_rows = v if r < total - 1 else (hb % v or v)
            ibr = block_rows * total
            for b in range(block_rows):
                R = r * v + b
                if R >= hb:
                    break
                ib = r * block_rows + b
                prev = R - 1 if ib > 0 else R
                pprev = R - 2 if ib > 1 else prev
                nxt = R + 1 if ib < ibr - 1 else R
                nnxt = R + 2 if ib < ibr - 2 else nxt
                rows[R] = (pprev, prev, R, nxt, nnxt)
        cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)
        dc = blocks[..., 0]
        # DC[i][j]: row offset i - 2, column offset j - 2, [hb, wb, 5, 5]
        DC = dc[rows[:, None, :, None], cols[None, :, None, :]]

        def d(k):                        # libjpeg's DC01 .. DC25
            return DC[..., (k - 1) // 5, (k - 1) % 5]

        work = blocks[:hb, :wb].copy()
        q00 = int(q[0])
        ests = [  # (zigzag index, natural index, with change_dc, without)
            (1, 1, lambda: -d(1) - d(2) + d(4) + d(5) - 3 * d(6)
             + 13 * d(7) - 13 * d(9) + 3 * d(10) - 3 * d(11) + 38 * d(12)
             - 38 * d(14) + 3 * d(15) - 3 * d(16) + 13 * d(17)
             - 13 * d(19) + 3 * d(20) - d(21) - d(22) + d(24) + d(25),
             lambda: -7 * d(11) + 50 * d(12) - 50 * d(14) + 7 * d(15)),
            (2, 8, lambda: -d(1) - 3 * d(2) - 3 * d(3) - 3 * d(4) - d(5)
             - d(6) + 13 * d(7) + 38 * d(8) + 13 * d(9) - d(10) + d(16)
             - 13 * d(17) - 38 * d(18) - 13 * d(19) + d(20) + d(21)
             + 3 * d(22) + 3 * d(23) + 3 * d(24) + d(25),
             lambda: -7 * d(3) + 50 * d(8) - 50 * d(18) + 7 * d(23)),
            (3, 16, lambda: d(3) + 2 * d(7) + 7 * d(8) + 2 * d(9)
             - 5 * d(12) - 14 * d(13) - 5 * d(14) + 2 * d(17) + 7 * d(18)
             + 2 * d(19) + d(23),
             lambda: -d(3) + 13 * d(8) - 24 * d(13) + 13 * d(18) - d(23)),
            (4, 9, lambda: -d(1) + d(5) + 9 * d(7) - 9 * d(9) - 9 * d(17)
             + 9 * d(19) + d(21) - d(25),
             lambda: d(10) + d(16) - 10 * d(17) + 10 * d(19) - d(2)
             - d(20) + d(22) - d(24) + d(4) - d(6) + 10 * d(7)
             - 10 * d(9)),
            (5, 2, lambda: 2 * d(7) - 5 * d(8) + 2 * d(9) + d(11)
             + 7 * d(12) - 14 * d(13) + 7 * d(14) + d(15) + 2 * d(17)
             - 5 * d(18) + 2 * d(19),
             lambda: -d(11) + 13 * d(12) - 24 * d(13) + 13 * d(14)
             - d(15)),
        ]
        if change_dc:
            ests += [
                (6, 3, lambda: d(7) - d(9) + 2 * d(12) - 2 * d(14) + d(17)
                 - d(19), None),
                (7, 10, lambda: d(7) - 3 * d(8) + d(9) - d(17) + 3 * d(18)
                 - d(19), None),
                (8, 17, lambda: d(7) - d(9) - 3 * d(12) + 3 * d(14) + d(17)
                 - d(19), None),
                (9, 24, lambda: d(7) + 2 * d(8) + d(9) - d(17) - 2 * d(18)
                 - d(19), None),
            ]
        for zz, nat, with_dc, without in ests:
            al = bits[zz]
            if al == 0:
                continue
            num = q00 * (with_dc() if change_dc else without())
            qk = int(q[nat])
            pred = ((qk << 7) + np.abs(num)) // (qk << 8)
            if al > 0:
                pred = np.minimum(pred, (1 << al) - 1)
            pred = np.where(num >= 0, pred, -pred)
            cur = work[..., nat]
            work[..., nat] = np.where(cur == 0, pred, cur)
        if change_dc:
            num = q00 * (
                -2 * d(1) - 6 * d(2) - 8 * d(3) - 6 * d(4) - 2 * d(5)
                - 6 * d(6) + 6 * d(7) + 42 * d(8) + 6 * d(9) - 6 * d(10)
                - 8 * d(11) + 42 * d(12) + 152 * d(13) + 42 * d(14)
                - 8 * d(15) - 6 * d(16) + 6 * d(17) + 42 * d(18) + 6 * d(19)
                - 6 * d(20) - 2 * d(21) - 6 * d(22) - 8 * d(23) - 6 * d(24)
                - 2 * d(25))
            pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
            work[..., 0] = np.where(num >= 0, pred, -pred)
        blocks = blocks[:bh].copy()
        blocks[:hb, :wb] = work
        out.append(blocks.reshape(-1))
    return out


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


# ---------------------------------------------------------------------------
# arithmetic decoding (jdarith.c: the QM decoder of ITU T.81 Annex D)

# Table D.2 as (Qe, next index after an MPS, next index after an LPS with
# the MPS switch in bit 7), and the fixed-probability state 113 (jaricom.c)
_QM = [(0x5A1D, 1, 1 | 128), (0x2586, 2, 14), (0x1114, 3, 16),
       (0x080B, 4, 18), (0x03D8, 5, 20), (0x01DA, 6, 23), (0x00E5, 7, 25),
       (0x006F, 8, 28), (0x0036, 9, 30), (0x001A, 10, 33), (0x000D, 11, 35),
       (0x0006, 12, 9), (0x0003, 13, 10), (0x0001, 13, 12),
       (0x5A7F, 15, 15 | 128), (0x3F25, 16, 36), (0x2CF2, 17, 38),
       (0x207C, 18, 39), (0x17B9, 19, 40), (0x1182, 20, 42),
       (0x0CEF, 21, 43), (0x09A1, 22, 45), (0x072F, 23, 46),
       (0x055C, 24, 48), (0x0406, 25, 49), (0x0303, 26, 51),
       (0x0240, 27, 52), (0x01B1, 28, 54), (0x0144, 29, 56),
       (0x00F5, 30, 57), (0x00B7, 31, 59), (0x008A, 32, 60),
       (0x0068, 33, 62), (0x004E, 34, 63), (0x003B, 35, 32),
       (0x002C, 9, 33), (0x5AE1, 37, 37 | 128), (0x484C, 38, 64),
       (0x3A0D, 39, 65), (0x2EF1, 40, 67), (0x261F, 41, 68),
       (0x1F33, 42, 69), (0x19A8, 43, 70), (0x1518, 44, 72),
       (0x1177, 45, 73), (0x0E74, 46, 74), (0x0BFB, 47, 75),
       (0x09F8, 48, 77), (0x0861, 49, 78), (0x0706, 50, 79),
       (0x05CD, 51, 48), (0x04DE, 52, 50), (0x040F, 53, 50),
       (0x0363, 54, 51), (0x02D4, 55, 52), (0x025C, 56, 53),
       (0x01F8, 57, 54), (0x01A4, 58, 55), (0x0160, 59, 56),
       (0x0125, 60, 57), (0x00F6, 61, 58), (0x00CB, 62, 59),
       (0x00AB, 63, 61), (0x008F, 32, 61), (0x5B12, 65, 65 | 128),
       (0x4D04, 66, 80), (0x412C, 67, 81), (0x37D8, 68, 82),
       (0x2FE8, 69, 83), (0x293C, 70, 84), (0x2379, 71, 86),
       (0x1EDF, 72, 87), (0x1AA9, 73, 87), (0x174E, 74, 72),
       (0x1424, 75, 72), (0x119C, 76, 74), (0x0F6B, 77, 74),
       (0x0D51, 78, 75), (0x0BB6, 79, 77), (0x0A40, 48, 77),
       (0x5832, 81, 80 | 128), (0x4D1C, 82, 88), (0x438E, 83, 89),
       (0x3BDD, 84, 90), (0x34EE, 85, 91), (0x2EAE, 86, 92),
       (0x299A, 87, 93), (0x2516, 71, 86), (0x5570, 89, 88 | 128),
       (0x4CA9, 90, 95), (0x44D9, 91, 96), (0x3E22, 92, 97),
       (0x3824, 93, 99), (0x32B4, 94, 99), (0x2E17, 86, 93),
       (0x56A8, 96, 95 | 128), (0x4F46, 97, 101), (0x47E5, 98, 102),
       (0x41CF, 99, 103), (0x3C3D, 100, 104), (0x375E, 93, 99),
       (0x5231, 102, 105), (0x4C0F, 103, 106), (0x4639, 104, 107),
       (0x415E, 99, 103), (0x5627, 106, 105 | 128), (0x50E7, 107, 108),
       (0x4B85, 103, 109), (0x5597, 109, 110), (0x504F, 107, 111),
       (0x5A10, 111, 110 | 128), (0x5522, 109, 112),
       (0x59EB, 111, 112 | 128), (0x5A1D, 113, 113)]
_FIXED = 113


class ArithDecoder:
    """jdarith.c's decoder over a scan's bytes: C and A registers, the
    bit counter (-16 until two bytes are in), zero data once a marker is
    reached.  `bit(stats, i)` decodes one binary decision with the
    adaptive state stats[i] (index | MPS << 7) and updates it."""

    __slots__ = ("data", "pos", "c", "a", "ct", "at_marker")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.reset(pos)

    def reset(self, pos: int) -> None:
        self.pos = pos
        self.c = self.a = 0
        self.ct = -16
        self.at_marker = False

    def _byte(self) -> int:
        if self.at_marker:
            return 0
        d, p = self.data, self.pos
        if p >= len(d):
            self.at_marker = True
            return 0
        b = d[p]
        if b != 0xFF:
            self.pos = p + 1
            return b
        q = p + 1
        while q < len(d) and d[q] == 0xFF:
            q += 1
        if q < len(d) and d[q] == 0:
            self.pos = q + 1
            return 0xFF
        self.at_marker = True                # pos stays at the marker
        self.pos = q - 1
        return 0

    def bit(self, stats: List[int], i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | self._byte()
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = stats[i]
        qe, nm, nl = _QM[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                stats[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7

    def restart(self) -> None:
        """Skip to the RSTn marker that ends this interval and past it."""
        d, p = self.data, self.pos
        if not self.at_marker:
            while True:                  # next_marker: discard bytes
                p = d.find(b"\xff", p)
                if p < 0 or p + 1 >= len(d):
                    raise ValueError("JPEG: a restart marker is missing")
                q = p + 1
                while q < len(d) and d[q] == 0xFF:
                    q += 1
                if q < len(d) and d[q] != 0:
                    p = q - 1
                    break
                p = q + 1
        if not 0xD0 <= d[p + 1] <= 0xD7:
            raise ValueError("JPEG: expected a restart marker, found "
                             f"0x{d[p + 1]:02x}")
        self.reset(p + 2)


def _arith_dc_diff(dec, stats, ctx, cond):
    """Figures F.19 and F.21 to F.24 (Decode_DC_DIFF) for one block, the
    statistics S0 at `ctx`: (difference, next conditioning category)."""
    bit = dec.bit
    if not bit(stats, ctx):
        return 0, 0
    sign = bit(stats, ctx + 1)
    st = ctx + 2 + sign
    m = bit(stats, st)
    if m:
        st = 20                                          # X1
        while bit(stats, st):
            m <<= 1
            if m == 0x8000:
                raise ValueError("JPEG: arithmetic magnitude overflow")
            st += 1
    lo, hi = cond
    if m < (1 << lo) >> 1:
        ctx = 0
    elif m > (1 << hi) >> 1:
        ctx = 12 + sign * 4
    else:
        ctx = 4 + sign * 4
    v = m
    st += 14
    m >>= 1
    while m:
        if bit(stats, st):
            v |= m
        m >>= 1
    v += 1
    return (-v if sign else v), ctx


def _arith_ac_value(dec, stats, st, k, kx, fixed):
    """Figures F.21 to F.24 for one AC coefficient at zigzag index k whose
    nonzero decision was at bin `st` + 1: its signed value."""
    bit = dec.bit
    sign = bit(fixed, 0)
    st += 2
    m = bit(stats, st)
    if m and bit(stats, st):
        m = 2
        st = 189 if k <= kx else 217
        while bit(stats, st):
            m <<= 1
            if m == 0x8000:
                raise ValueError("JPEG: arithmetic magnitude overflow")
            st += 1
    v = m
    st += 14
    m >>= 1
    while m:
        if bit(stats, st):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _scan_arith(data, seg, pos, frame, cond, restart, coefs) -> int:
    """One arithmetic-coded scan (jdarith.c: decode_mcu for sequential
    frames; decode_mcu_DC_first, _DC_refine, _AC_first and _AC_refine for
    progressive ones) into the frame's coefficient buffers."""
    sel, ss, se, ah, al = _scan_header(seg, frame)
    prog = frame["progressive"]
    if prog:
        if ss == 0 and se != 0:
            raise ValueError("JPEG: a progressive DC scan with AC terms")
        if ss and (len(sel) != 1 or se < ss or se > 63):
            raise ValueError(f"JPEG: a bad progressive AC scan ({ss}..{se})")
        if al > 13 or (ah and ah != al + 1):
            raise ValueError(f"JPEG: bad successive approximation {ah}/{al}")
    elif ss != 0 or se != 63:
        raise NotImplementedError("JPEG: a spectral-selection scan "
                                  f"({ss}..{se}) in a sequential frame")
    for ci, _, _ in sel:
        bits = frame["coef_bits"][ci]
        for k in range(ss, se + 1):
            bits[k] = al
    units = _scan_units(frame, sel)
    _, end = _segments(data, pos)
    dec = ArithDecoder(data, pos)
    fixed = [_FIXED]
    dc_first = not prog or (ss == 0 and ah == 0)
    ac_used = not prog or ss != 0
    bufs = [coefs[ci] for ci, _, _ in sel]
    zz = ZIGZAG.tolist()

    def fresh():
        dcs = {td: [0] * 64 for _, td, _ in sel} if dc_first else {}
        acs = {ta: [0] * 256 for _, _, ta in sel} if ac_used else {}
        return dcs, acs, [0] * len(sel), [0] * len(sel)

    dcs, acs, last, ctx = fresh()
    p1, m1 = 1 << al, -1 << al
    for n, mcu in enumerate(units):
        if restart and n and n % restart == 0:
            dec.restart()
            dcs, acs, last, ctx = fresh()
        for slot, base in mcu:
            ci, td, ta = sel[slot]
            buf = bufs[slot]
            if not prog or (ss == 0 and ah == 0):        # DC (first)
                diff, ctx[slot] = _arith_dc_diff(dec, dcs[td], ctx[slot],
                                                 cond["dc"][td])
                last[slot] = (last[slot] + diff) & 0xFFFF
                v = last[slot] - 0x10000 if last[slot] & 0x8000 else \
                    last[slot]
                buf[base] = v << al if prog else v
                if prog:
                    continue
            elif ss == 0:                                # DC refine
                if dec.bit(fixed, 0):
                    buf[base] |= p1
                continue
            stats, kx = acs[ta], cond["ac"][ta]
            if not prog:                                 # sequential AC
                k = 0
                while k < 63:
                    st = 3 * k
                    if dec.bit(stats, st):
                        break
                    while True:
                        k += 1
                        if dec.bit(stats, st + 1):
                            break
                        st += 3
                        if k >= 63:
                            raise ValueError("JPEG: arithmetic spectral "
                                             "overflow")
                    buf[base + zz[k]] = _arith_ac_value(dec, stats, st, k,
                                                        kx, fixed)
            elif ah == 0:                                # AC first
                k = ss
                while k <= se:
                    st = 3 * (k - 1)
                    if dec.bit(stats, st):
                        break
                    while not dec.bit(stats, st + 1):
                        st += 3
                        k += 1
                        if k > se:
                            raise ValueError("JPEG: arithmetic spectral "
                                             "overflow")
                    v = _arith_ac_value(dec, stats, st, k, kx, fixed)
                    buf[base + zz[k]] = v * p1
                    k += 1
            else:                                        # AC refine
                kex = se
                while kex > 0 and not buf[base + zz[kex]]:
                    kex -= 1
                k = ss
                while k <= se:
                    st = 3 * (k - 1)
                    if k > kex and dec.bit(stats, st):
                        break
                    while True:
                        i = base + zz[k]
                        c = buf[i]
                        if c:
                            if dec.bit(stats, st + 2):
                                buf[i] = c + (m1 if c < 0 else p1)
                            break
                        if dec.bit(stats, st + 1):
                            buf[i] = m1 if dec.bit(fixed, 0) else p1
                            break
                        st += 3
                        k += 1
                        if k > se:
                            raise ValueError("JPEG: arithmetic spectral "
                                             "overflow")
                    k += 1
    return end


# ---------------------------------------------------------------------------
# lossless frames (jdlhuff.c, jdlossls.c, jddiffct.c)

def _undifference(diff: np.ndarray, psv: int, initial: int,
                  first_rows) -> np.ndarray:
    """Sample differences [h, w] -> samples (mod 2^16): the first row of the
    image and of each restart interval (`first_rows`) from its left
    neighbour (the first sample from `initial`), the first column from
    the sample above, the rest by predictor `psv`."""
    h, w = diff.shape
    out = np.zeros((h, w), np.int64)
    for r in range(h):
        d = diff[r]
        if r in first_rows:
            row = np.cumsum(d) + initial
        else:
            up = out[r - 1]
            if psv == 1:
                row = np.cumsum(np.concatenate([[d[0] + up[0]], d[1:]]))
            elif psv == 2:
                row = d + up
            elif psv == 3:
                row = d + np.concatenate([up[:1], up[:-1]])
            elif psv in (4, 5):
                # Ra + (Rb - Rc) or Ra + ((Rb - Rc) >> 1): a running sum
                grad = np.diff(up)
                step = grad if psv == 4 else grad >> 1
                row = np.cumsum(np.concatenate([[d[0] + up[0]],
                                                d[1:] + step]))
            else:
                row = np.empty(w, np.int64)
                ra = (int(d[0]) + int(up[0])) & 0xFFFF
                row[0] = ra
                ul, dl = up.tolist(), d.tolist()
                for x in range(1, w):
                    rb, rc = ul[x], ul[x - 1]
                    pred = rb + ((ra - rc) >> 1) if psv == 6 else \
                        (ra + rb) >> 1
                    ra = (dl[x] + pred) & 0xFFFF
                    row[x] = ra
        out[r] = row & 0xFFFF
    return out


def _scan_lossless(data, seg, pos, frame, huff, restart, planes) -> int:
    """One lossless scan: the Huffman-coded differences (a DC-style
    category and its bits; category 16 is 32768 with no bits) of each
    component's samples, undifferenced by the scan's predictor and scaled
    by its point transform into `planes`."""
    sel, psv, _, _, pt = _scan_header(seg, frame)
    if not 1 <= psv <= 7:
        raise ValueError(f"JPEG: lossless predictor {psv}")
    comps = frame["comps"]
    if len(sel) == 1:
        c = comps[sel[0][0]]
        mcus_per_row, rows_per_mcu = c["w"], [1]
        hs, vs = [1], [1]
        grid = [(c["h_px"], c["w"])]
    else:
        mcus_per_row = frame["mcux"]
        hs = [comps[ci]["h"] for ci, _, _ in sel]
        vs = [comps[ci]["v"] for ci, _, _ in sel]
        grid = [(frame["mcuy"] * v, frame["mcux"] * h) for h, v in
                zip(hs, vs)]
    nmcu = (grid[0][0] // vs[0]) * mcus_per_row
    if restart and restart % mcus_per_row:
        raise NotImplementedError("JPEG: a lossless restart interval that "
                                  "is not whole MCU rows")
    segs, end = _segments(data, pos)
    per = restart or nmcu
    if len(segs) < -(-nmcu // per):
        raise ValueError("JPEG: fewer restart intervals than MCUs need")
    luts = [huff.get((0, td)) for _, td, _ in sel]
    if any(t is None for t in luts):
        raise ValueError("JPEG: a scan uses an undefined Huffman table")
    diffs = [np.zeros(g, np.int64) for g in grid]
    ys = [np.repeat(np.arange(v), h) for h, v in zip(hs, vs)]
    xs = [np.tile(np.arange(h), v) for h, v in zip(hs, vs)]
    for k in range(0, nmcu, per):
        n = min(per, nmcu - k)
        slots = [s for s in range(len(sel)) for _ in range(hs[s] * vs[s])]
        vals = _lossless_diffs(segs[k // per], slots * n, luts)
        vals = np.asarray(vals, np.int64).reshape(n, -1)
        col = 0
        for s in range(len(sel)):
            nb = hs[s] * vs[s]
            v = vals[:, col:col + nb]
            col += nb
            m = np.arange(k, k + n)
            my, mx = m // mcus_per_row, m % mcus_per_row
            diffs[s][(my[:, None] * vs[s] + ys[s][None]),
                     (mx[:, None] * hs[s] + xs[s][None])] = v
    initial = 1 << (8 - pt - 1)
    for s, (ci, _, _) in enumerate(sel):
        c = comps[ci]
        rows_per_interval = (per // mcus_per_row) * vs[s]
        first = set(range(0, grid[s][0], rows_per_interval))
        d = diffs[s][:c["h_px"], :c["w"]]
        samples = _undifference(d, psv, initial, first)
        planes[ci][:c["h_px"], :c["w"]] = ((samples << pt) & 0xFF)
    return end


def _lossless_diffs(seg: bytes, slots, luts) -> List[int]:
    """The sample differences of one restart interval, a table per slot."""
    a = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.int64)
    win = ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist()
    out = []
    p = 0
    for slot in slots:
        look = luts[slot][(win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        if not look:
            raise ValueError("JPEG: bad Huffman code")
        p += look >> 8
        s = look & 0xFF
        diff = 0
        if s == 16:
            diff = 32768
        elif s:
            diff = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
            p += s
            if diff < 1 << (s - 1):
                diff -= (1 << s) - 1
        out.append(diff)
    return out


def _planes(frame, coefs, qt) -> List[np.ndarray]:
    """Dense quantised coefficients a component -> its uint8 plane at the
    image's size (ISLOW IDCT, fancy upsampling)."""
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
    return planes


def _colour(frame, planes, adobe_transform, jfif) -> ModeImage:
    """The colour space libjpeg's default_decompress_parms picks, converted
    as PIL asks: "L", "RGB", or "CMYK" inverted (PIL's "CMYK;I")."""
    if frame["lossless"]:
        # no fancy upsampling in lossless mode (DCT scaled size 1)
        h, w = frame["h"], frame["w"]
        planes = [np.repeat(np.repeat(
            p, frame["vmax"] // c["v"], axis=0), frame["hmax"] // c["h"],
            axis=1)[:h, :w] for c, p in zip(frame["comps"], planes)]
    if len(planes) == 1:
        return ModeImage("L", np.ascontiguousarray(planes[0]))
    if frame["lossless"] and (jfif or adobe_transform not in (None, 0)):
        # libjpeg-turbo converts no colour in lossless mode: a YCbCr or
        # YCCK frame (JFIF, or an Adobe transform) fails as it fails there
        raise NotImplementedError(
            "JPEG: a lossless YCbCr or YCCK frame (JFIF or Adobe transform "
            f"{adobe_transform}): libjpeg-turbo converts no colour in "
            "lossless mode")
    if len(planes) == 4:
        if adobe_transform not in (None, 0):             # YCCK
            cmy = 255 - ycc_to_rgb(*planes[:3])
            cmyk = np.concatenate([cmy, planes[3][..., None]], -1)
        else:
            cmyk = np.stack(planes, -1)
        return ModeImage("CMYK", 255 - cmyk)
    ids = [c["id"] for c in frame["comps"]]
    if frame["lossless"]:
        rgb = True                   # any component ids: RGB, unconverted
    elif jfif:
        rgb = False
    elif adobe_transform is not None:
        rgb = adobe_transform == 0
    else:
        rgb = ids == [82, 71, 66]
    if rgb:
        return ModeImage("RGB", np.stack(planes, -1))
    return ModeImage("RGB", ycc_to_rgb(*planes))


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
