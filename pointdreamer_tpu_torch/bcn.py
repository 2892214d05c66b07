"""Block-compressed texture decoding (BC1-BC7) in numpy, as PIL 12.1's
"bcn" decoder (BcnDecode.c) decodes it, vectorised over 4x4 blocks.

- BC1 (DXT1): two 5-6-5 colours widened by bit replication; where the
  first is not above the second, index 2 is their mean and index 3
  transparent black;
- BC2 (DXT3): BC1 colours always in 4-colour mode, 4-bit alpha x 17;
- BC3 (DXT5), BC4 and BC5: the 8-value (a0 > a1) or 6-value + 0 / 255
  interpolation of two 8-bit ends, a 3-bit index a texel; BC5 signed ends
  are shifted by 128 first, and its blue is 128 (0 unsigned);
- BC6H: the 14 modes, endpoint deltas, sign extension, unquantisation and
  the 31/64 (31/32 signed) half-float scaling of BcnDecode.c, each channel
  then clamped to [0, 1] and truncated to 8 bits;
- BC7: the 8 modes, the 2- and 3-subset partitions with their anchor
  texels, p-bits, rotation and the index selector; a block whose first
  byte is 0 (no mode bit) decodes as PIL decodes it.

`decode(data, width, height, n, pixel_format)` returns uint8 [H, W, C]
(C 4 for BC1/2/3/7, 1 for BC4, 3 for BC5/BC6H): the blocks run row-major,
(width + 3) // 4 a row, and the texels past the image's edge are dropped.
BLP's own DXT decoders (plain shifts, not bit replication) are
`decode_blp_dxt`.
"""
from __future__ import annotations

import numpy as np

# bytes a block, by BCn number
_BLOCK = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}


def _blocks(data: bytes, offset: int, width: int, height: int, n: int):
    bw, bh = (width + 3) // 4, (height + 3) // 4
    need = bw * bh * _BLOCK[n]
    if width <= 0 or height <= 0:
        raise ValueError("BCn: bad image size")
    if len(data) - offset < need:
        raise ValueError(f"BC{n}: image file is truncated "
                         f"({len(data) - offset} of {need} bytes)")
    return np.frombuffer(data, np.uint8, need, offset).reshape(
        bh * bw, _BLOCK[n]), bw, bh


def _place(texels: np.ndarray, bw: int, bh: int, width: int,
           height: int) -> np.ndarray:
    """[blocks, 16, C] texels (row-major in each block) -> [H, W, C]."""
    c = texels.shape[-1]
    img = texels.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, c)[:height,
                                                                :width])


def _u16(b: np.ndarray, i: int) -> np.ndarray:
    return b[:, i].astype(np.int64) | (b[:, i + 1].astype(np.int64) << 8)


def _u32(b: np.ndarray, i: int) -> np.ndarray:
    return _u16(b, i) | (_u16(b, i + 2) << 16)


def _rgb565(v: np.ndarray) -> np.ndarray:
    r = (v & 0xF800) >> 8
    g = (v & 0x7E0) >> 3
    b = (v & 0x1F) << 3
    return np.stack([r | (r >> 5), g | (g >> 6), b | (b >> 5)], -1)


def _bc1_colors(b: np.ndarray, four: bool) -> np.ndarray:
    """8-byte BC1 colour blocks [N, 8] -> RGBA texels [N, 16, 4]."""
    c0, c1 = _u16(b, 0), _u16(b, 2)
    e0, e1 = _rgb565(c0), _rgb565(c1)
    opaque = np.full(len(b), 255, np.int64)
    four_mode = (c0 > c1) | four
    p2 = np.where(four_mode[:, None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p3 = np.where(four_mode[:, None], (e0 + 2 * e1) // 3, 0)
    a3 = np.where(four_mode, 255, 0)
    pal = np.stack([np.concatenate([e0, opaque[:, None]], 1),
                    np.concatenate([e1, opaque[:, None]], 1),
                    np.concatenate([p2, opaque[:, None]], 1),
                    np.concatenate([p3, a3[:, None]], 1)], 1)   # [N, 4, 4]
    lut = _u32(b, 4)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _bc3_alpha(b: np.ndarray, signed: bool = False) -> np.ndarray:
    """8-byte BC3/BC4 alpha blocks [N, 8] -> values [N, 16]."""
    a0 = b[:, 0].astype(np.int64)
    a1 = b[:, 1].astype(np.int64)
    if signed:
        a0 = (a0 ^ 0x80)
        a1 = (a1 ^ 0x80)
    big = (a0 > a1)[:, None]
    k = np.arange(1, 7)
    eight = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    k5 = np.arange(1, 5)
    six = ((5 - k5) * a0[:, None] + k5 * a1[:, None]) // 5
    six = np.concatenate([six, np.zeros((len(b), 1), np.int64),
                          np.full((len(b), 1), 255, np.int64)], 1)
    pal = np.concatenate([a0[:, None], a1[:, None],
                          np.where(big, eight, six)], 1)
    lo = b[:, 2].astype(np.int64) | (b[:, 3].astype(np.int64) << 8) | (
        b[:, 4].astype(np.int64) << 16)
    hi = b[:, 5].astype(np.int64) | (b[:, 6].astype(np.int64) << 8) | (
        b[:, 7].astype(np.int64) << 16)
    sh = 3 * np.arange(8)
    idx = np.concatenate([(lo[:, None] >> sh) & 7, (hi[:, None] >> sh) & 7],
                         1)
    return np.take_along_axis(pal, idx, 1)


# ---------------------------------------------------------------------------
# BC7

# (subsets, partition bits, rotation bits, index selection bits, colour
# bits, alpha bits, endpoint p-bits, shared p-bits, index bits, second
# index bits) of modes 0-7
_BC7_MODES = (
    (3, 4, 0, 0, 4, 0, 1, 0, 3, 0),
    (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
    (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
    (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
    (1, 0, 2, 1, 5, 6, 0, 0, 2, 3),
    (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
    (1, 0, 0, 0, 7, 7, 1, 0, 4, 0),
    (2, 6, 0, 0, 5, 5, 1, 0, 2, 0),
)
# the 2-subset partitions, a bit a texel
_P2 = np.array([
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22],
    np.int64)
# the 3-subset partitions, texel by texel
_P3 = np.array([[int(c) for c in s] for s in (
    "0011001102212222", "0001001122112221", "0000200122112211",
    "0222002200110111", "0000000011221122", "0011001100220022",
    "0022002211111111", "0011001122112211", "0000000011112222",
    "0000111111112222", "0000111122222222", "0012001200120012",
    "0112011201120112", "0122012201220122", "0011011211221222",
    "0011200122002220", "0001001101121122", "0111001120012200",
    "0000112211221122", "0022002200221111", "0111011102220222",
    "0001000122212221", "0000001101220122", "0000110022102210",
    "0122012200110000", "0012001211222222", "0110122112210110",
    "0000011012211221", "0022110211020022", "0110011020022222",
    "0011012201220011", "0000200022112221", "0000000211221222",
    "0222002200120011", "0011001200220222", "0120012001200120",
    "0000111122220000", "0120120120120120", "0120201212010120",
    "0011220011220011", "0011112222000011", "0101010122222222",
    "0000000021212121", "0022112200221122", "0022001100220011",
    "0220122102201221", "0101222222220101", "0000212121212121",
    "0101010101012222", "0222011102220111", "0002111200021112",
    "0000211221122112", "0222011101110222", "0002111211120002",
    "0110011001102222", "0000000021122112", "0110011022222222",
    "0022001100110022", "0022112211220022", "0000000000002112",
    "0002000100020001", "0222122202221222", "0101222222222222",
    "0111201122012220")], np.int64)
# the anchor texel of subset 1 (2 subsets), of subsets 1 and 2 (3 subsets)
_A2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15], np.int64)
_A3A = np.array([
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3], np.int64)
_A3B = np.array([
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8], np.int64)
_WEIGHTS = {2: np.array([0, 21, 43, 64]),
            3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
            4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                         60, 64])}


def _subsets(ns: int, part: np.ndarray) -> np.ndarray:
    """Subset of each texel [N, 16] for `ns` subsets and partitions."""
    if ns == 1:
        return np.zeros((len(part), 16), np.int64)
    if ns == 2:
        return (_P2[part][:, None] >> np.arange(16)) & 1
    return _P3[part]


def _anchor_bits(ns: int, part: np.ndarray, sub: np.ndarray) -> np.ndarray:
    """1 where a texel is its subset's anchor (its index one bit short)."""
    n = len(part)
    anchor = np.zeros((n, 16), np.int64)
    anchor[:, 0] = 1
    t = np.arange(16)
    if ns == 2:
        anchor |= (t == _A2[part][:, None]) & (sub == 1)
    elif ns == 3:
        anchor |= (t == _A3A[part][:, None]) & (sub == 1)
        anchor |= (t == _A3B[part][:, None]) & (sub == 2)
    return anchor


class _Bits:
    """A stream of little-endian bits over [N, bytes] blocks."""

    def __init__(self, blocks: np.ndarray):
        self.bits = np.unpackbits(blocks, axis=1, bitorder="little").astype(
            np.int64)
        self.n = len(blocks)

    def at(self, pos: int, count: int) -> np.ndarray:
        """`count` bits from bit `pos` of every block -> [N]."""
        return (self.bits[:, pos:pos + count] << np.arange(count)).sum(1)

    def var(self, pos: np.ndarray, count: np.ndarray, most: int):
        """Per-texel fields of `count` [N, 16] bits at `pos` [N, 16]."""
        k = np.arange(most)
        take = np.minimum(pos[..., None] + k, 127)
        rows = np.arange(self.n)[:, None, None]
        v = (self.bits[rows, take] << k) * (k < count[..., None])
        return v.sum(-1)


def _expand(v: np.ndarray, bits: int) -> np.ndarray:
    v = (v << (8 - bits)) & 0xFF
    return v | (v >> bits)


def _bc7_mode(blocks: np.ndarray, mode: int) -> np.ndarray:
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    s = _Bits(blocks)
    n = len(blocks)
    bit = mode + 1
    part = s.at(bit, pb)
    bit += pb
    rot = s.at(bit, rb)
    bit += rb
    sel = s.at(bit, isb)
    bit += isb
    numep = 2 * ns
    ep = np.zeros((n, numep, 4), np.int64)
    for ch in range(3):
        for i in range(numep):
            ep[:, i, ch] = s.at(bit, cb)
            bit += cb
    for i in range(numep):
        if ab:
            ep[:, i, 3] = s.at(bit, ab)
            bit += ab
        else:
            ep[:, i, 3] = 255
    nch = 4 if ab else 3
    if epb:
        for i in range(numep):
            p = s.at(bit, 1)
            bit += 1
            ep[:, i, :nch] = (ep[:, i, :nch] << 1) | p[:, None]
    if spb:
        for i in range(0, numep, 2):
            p = s.at(bit, 1)
            bit += 1
            ep[:, i:i + 2, :nch] = (ep[:, i:i + 2, :nch] << 1) | p[:, None,
                                                                   None]
    cbits = cb + (1 if epb or spb else 0)
    abits = ab + (1 if ab and (epb or spb) else 0)
    ep[..., :3] = _expand(ep[..., :3], cbits)
    if ab:
        ep[..., 3] = _expand(ep[..., 3], abits)
    sub = _subsets(ns, part)
    anchor = _anchor_bits(ns, part, sub)
    width = ib - anchor
    pos = bit + np.concatenate([np.zeros((n, 1), np.int64),
                                np.cumsum(width, 1)[:, :-1]], 1)
    i0 = s.var(pos, width, ib)
    cw = _WEIGHTS[ib][i0]
    if ab and ib2:
        width2 = np.full((n, 16), ib2)
        width2[:, 0] -= 1
        abit = bit + 16 * ib - ns
        pos2 = abit + np.concatenate([np.zeros((n, 1), np.int64),
                                      np.cumsum(width2, 1)[:, :-1]], 1)
        i1 = s.var(pos2, width2, ib2)
        aw = _WEIGHTS[ib2][i1]
        sel1 = sel[:, None] == 1
        wc = np.where(sel1, aw, cw)
        wa = np.where(sel1, cw, aw)
    else:
        wc = wa = cw
    e0 = np.take_along_axis(ep, (2 * sub)[..., None], 1)       # [N, 16, 4]
    e1 = np.take_along_axis(ep, (2 * sub + 1)[..., None], 1)
    w = np.concatenate([np.repeat(wc[..., None], 3, -1), wa[..., None]], -1)
    out = ((64 - w) * e0 + w * e1 + 32) >> 6
    for r, ch in ((1, 0), (2, 1), (3, 2)):
        m = rot == r
        out[m, :, ch], out[m, :, 3] = out[m, :, 3], out[m, :, ch].copy()
    return out


def _bc7(blocks: np.ndarray) -> np.ndarray:
    out = np.zeros((len(blocks), 16, 4), np.int64)
    first = blocks[:, 0]
    out[first == 0, :, 3] = 255             # no mode bit: opaque black
    low = first & (-first.astype(np.int16)).astype(np.uint8)
    mode = np.full(len(blocks), -1)
    for m in range(8):
        mode[low == (1 << m)] = m
    for m in range(8):
        sel = mode == m
        if sel.any():
            out[sel] = _bc7_mode(blocks[sel], m)
    return out


# ---------------------------------------------------------------------------
# BC6H

# (subsets, transformed, partition bits, endpoint bits, r/g/b delta bits)
# by BcnDecode.c's mode number (0-1: 2-bit mode codes; 2-9: 5-bit codes
# xxx10; 10-13: 5-bit codes xxx11)
_BC6_MODES = (
    (2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
    (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
    (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
    (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
    (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# the endpoint bits after the mode bits, in stream order: fields
# "<channel><endpoint>[hi:lo]" (lo first; [lo:hi] runs from hi down)
_BC6_LAYOUT = (
    "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] "
    "g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] "
    "b3[3]",
    "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] "
    "g2[4] b0[6:0] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] "
    "b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] "
    "g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] "
    "g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] "
    "g2[4] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] "
    "b3[0] g3[3:0] b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] "
    "b3[4] b3[3]",
    "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] "
    "g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] "
    "b3[3]",
    "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] "
    "g2[3:0] g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]",
    "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] "
    "g3[4] g2[3:0] g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] "
    "r3[4:0] b3[3]",
    "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] "
    "g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] "
    "r3[4:0] b3[3]",
    "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] "
    "b0[5:0] g3[5] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] "
    "b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]",
    "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] "
    "b0[10:11]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] "
    "b0[10:15]",
)


def _bc6_packing(layout: str):
    """(endpoint word, bit) of each stream bit; words r0 g0 b0 r1 ... b3."""
    out = []
    for field in layout.split():
        name, rng = field[:2], field[3:-1]
        word = 3 * int(name[1]) + "rgb".index(name[0])
        if ":" in rng:
            a, b = (int(x) for x in rng.split(":"))
            step = 1 if a >= b else -1
            out += [(word, k) for k in range(b, a + step, step)]
        else:
            out.append((word, int(rng)))
    return out


_BC6_PACKINGS = tuple(_bc6_packing(s) for s in _BC6_LAYOUT)


def _sext(v: np.ndarray, bits: int) -> np.ndarray:
    """bc6_sign_extend, kept to 16 bits as BcnDecode.c's UINT16 keeps it."""
    v = np.where(v & (1 << (bits - 1)), v | (-1 << bits), v)
    return v & 0xFFFF


def _unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    if not signed:
        if prec >= 15:
            return v
        mid = ((v << 15) + 0x4000) >> (prec - 1)
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF,
                                            mid))
    x = np.where(v >= 0x8000, v - 0x10000, v)
    if prec >= 16:
        return x
    neg = x < 0
    a = np.abs(x)
    a = np.where(a == 0, 0, np.where(a >= (1 << (prec - 1)) - 1, 0x7FFF,
                                     ((a << 15) + 0x4000) >> (prec - 1)))
    return np.where(neg, -a, a)


def _half_to_u8(h: np.ndarray) -> np.ndarray:
    """The half floats [0, 0x7bff] (sign bit apart) to bc6_clamp's 8 bits:
    0 below 0, 255 above 1, else (uint8)(f * 255.0f)."""
    f = h.astype(np.uint16).view(np.float16).astype(np.float32)
    v = (f * np.float32(255.0)).astype(np.float32)
    out = np.where(f < 0, 0, np.where(f > 1, 255, np.floor(v)))
    return out.astype(np.uint8)


def _bc6_finalize(v: np.ndarray, signed: bool) -> np.ndarray:
    if signed:
        h = np.where(v < 0, 0x8000 | (((-v) * 31) // 32), (v * 31) // 32)
    else:
        h = (v * 31) // 64
    return _half_to_u8(h & 0xFFFF)


def _bc6_mode(blocks: np.ndarray, mode: int, bit: int, epbits: int,
              signed: bool) -> np.ndarray:
    ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[mode]
    s = _Bits(blocks)
    n = len(blocks)
    ib = 4 if ns == 1 else 3
    numep = 12 if ns == 2 else 6
    ep = np.zeros((n, 12), np.int64)
    packing = _BC6_PACKINGS[mode]
    assert len(packing) == epbits, (mode, len(packing))
    for i, (word, k) in enumerate(packing):
        ep[:, word] |= s.bits[:, bit + i] << k
    bit += epbits
    part = s.at(bit, pb)
    bit += pb
    mask = (1 << epb) - 1
    if signed:
        for c in range(3):
            ep[:, c] = _sext(ep[:, c], epb)
    if signed or tr:
        for i in range(3, numep, 3):
            for c, dbits in enumerate((rb, gb, bb)):
                ep[:, i + c] = _sext(ep[:, i + c], dbits)
    if tr:
        # the sums are masked and, unlike the base endpoint, not sign
        # extended again, signed or not (BcnDecode.c)
        for i in range(3, numep, 3):
            for c in range(3):
                ep[:, i + c] = (ep[:, i + c] + ep[:, c]) & mask
    ueps = _unquantize(ep[:, :numep], epb, signed)
    sub = _subsets(ns, part)
    t = np.arange(16)
    short = (t == 0)[None, :].repeat(n, 0)
    if ns == 2:
        short = short | (t == _A2[part][:, None])
    width = ib - short.astype(np.int64)
    pos = bit + np.concatenate([np.zeros((n, 1), np.int64),
                                np.cumsum(width, 1)[:, :-1]], 1)
    i0 = s.var(pos, width, ib)
    w = _WEIGHTS[ib][i0]
    e = ueps.reshape(n, -1, 2, 3)                        # subset, end, rgb
    e0 = np.take_along_axis(e[:, :, 0], sub[..., None], 1)
    e1 = np.take_along_axis(e[:, :, 1], sub[..., None], 1)
    v = (e0 * (64 - w[..., None]) + e1 * w[..., None]) >> 6
    return _bc6_finalize(v, signed)


def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    out = np.zeros((len(blocks), 16, 3), np.uint8)
    m5 = (blocks[:, 0] & 0x1F).astype(np.int64)
    low = m5 & 3
    mode = np.where(low < 2, low, np.where(low == 2, 2 + (m5 >> 2),
                                           10 + (m5 >> 2)))
    for m in range(14):
        sel = mode == m
        if not sel.any():
            continue
        if m < 2:
            bit, epbits = 2, 75
        elif m < 10:
            bit, epbits = 5, 72
        else:
            bit, epbits = 5, 60
        out[sel] = _bc6_mode(blocks[sel], m, bit, epbits, signed)
    return out                               # modes 14-17: zeros


def decode(data: bytes, width: int, height: int, n: int,
           pixel_format: str = "", offset: int = 0) -> np.ndarray:
    """BCn blocks at `offset` -> uint8 [H, W, C] (see the module
    docstring); `pixel_format` "BC5S" / "BC6HS" selects the signed
    variants."""
    if n not in _BLOCK:
        raise NotImplementedError(f"BC{n}: no such block format")
    b, bw, bh = _blocks(data, offset, width, height, n)
    if n == 1:
        tex = _bc1_colors(b, False)
    elif n in (2, 3):
        tex = _bc1_colors(b[:, 8:], True)
        if n == 2:
            a = ((b[:, :8].astype(np.int64)[:, :, None] >> np.array([0, 4]))
                 & 15).reshape(-1, 16)
            tex[..., 3] = a * 17
        else:
            tex[..., 3] = _bc3_alpha(b[:, :8])
    elif n == 4:
        tex = _bc3_alpha(b)[..., None]
    elif n == 5:
        signed = pixel_format == "BC5S"
        tex = np.stack([_bc3_alpha(b[:, :8], signed),
                        _bc3_alpha(b[:, 8:], signed),
                        np.full((len(b), 16), 128 if signed else 0)], -1)
    elif n == 6:
        tex = _bc6(b, pixel_format == "BC6HS")
    else:
        tex = _bc7(b)
    return _place(tex.astype(np.uint8), bw, bh, width, height)


# ---------------------------------------------------------------------------
# BLP's DXT decoders (BlpImagePlugin.py): 5-6-5 widened by shifts alone

def _blp565(v: np.ndarray) -> np.ndarray:
    return np.stack([((v >> 11) & 0x1F) << 3, ((v >> 5) & 0x3F) << 2,
                     (v & 0x1F) << 3], -1)


def _blp_colors(b: np.ndarray, four: bool) -> np.ndarray:
    c0, c1 = _u16(b, 0), _u16(b, 2)
    e0, e1 = _blp565(c0), _blp565(c1)
    big = ((c0 > c1) | four)[:, None]
    p2 = np.where(big, (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p3 = np.where(big, (2 * e1 + e0) // 3, 0)
    a3 = np.where(big[:, 0], 255, 0)
    one = np.full((len(b), 1), 255)
    pal = np.stack([np.concatenate([e0, one], 1),
                    np.concatenate([e1, one], 1),
                    np.concatenate([p2, one], 1),
                    np.concatenate([p3, a3[:, None]], 1)], 1)
    idx = (_u32(b, 4)[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def decode_blp_dxt(data: bytes, offset: int, width: int, height: int,
                   encoding: int, alpha: bool) -> bytes:
    """BlpImagePlugin's decode_dxt1 / 3 / 5 (alpha encoding 0 / 1 / 7) over
    whole block rows: the raw RGBA (RGB for DXT1 without alpha) bytes it
    hands to its raw decoder, rows of (width + 3) // 4 * 4 texels."""
    n = {0: 1, 1: 2, 7: 3}[encoding]
    b, bw, bh = _blocks(data, offset, width, height, n)
    if n == 1:
        tex = _blp_colors(b, False)
    else:
        tex = _blp_colors(b[:, 8:], True)
        if n == 2:
            a = ((b[:, :8].astype(np.int64)[:, :, None] >> np.array([0, 4]))
                 & 15).reshape(-1, 16)
            tex[..., 3] = a * 17
        else:
            tex[..., 3] = _bc3_alpha(b[:, :8])
    if n == 1 and not alpha:
        tex = tex[..., :3]
    img = tex.astype(np.uint8).reshape(bh, bw, 4, 4, -1).transpose(
        0, 2, 1, 3, 4)
    return img.tobytes()
