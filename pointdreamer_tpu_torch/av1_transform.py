"""AV1 inverse transforms (specification section 7.13): DCT 4-64, ADST 4/8/16
and their flips, identity 4-32, the Walsh-Hadamard transform of lossless
blocks, and the 2-D process with the rectangular 2896 scaling, the row and
column shifts and the intermediate clamps.  Each 1-D transform runs on all
rows of a block at once (numpy int64, the last axis).
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T


def _round2(x, n):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _b(t, a, b, angle, flip):
    """The butterfly rotation B(a, b, angle, flip)."""
    c, s = T.cos128(angle), T.sin128(angle)
    x = t[..., a] * c - t[..., b] * s
    y = t[..., a] * s + t[..., b] * c
    x = (x + 2048) >> 12
    y = (y + 2048) >> 12
    if flip:
        t[..., a], t[..., b] = y, x
    else:
        t[..., a], t[..., b] = x, y


def _h(t, a, b, flip):
    """The Hadamard rotation H(a, b, flip)."""
    if flip:
        a, b = b, a
    x = t[..., a].copy()
    y = t[..., b]
    t[..., a] = x + y
    t[..., b] = x - y


_DCT_PERM = {n: np.array([T.brev(n, i) for i in range(1 << n)])
             for n in range(2, 7)}


def idct(x: np.ndarray, n: int) -> np.ndarray:
    """The inverse DCT of size 1 << n along the last axis."""
    t = x[..., _DCT_PERM[n]].copy()
    B, H = _b, _h
    if n == 6:
        for i in range(16):
            B(t, 32 + i, 63 - i, 63 - 4 * T.brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            B(t, 16 + i, 31 - i, 6 + (T.brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            H(t, 32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            B(t, 8 + i, 15 - i, 12 + (T.brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            H(t, 16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                B(t, 62 - i * 4 - j, 33 + i * 4 + j,
                  60 - 16 * T.brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            B(t, 4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            H(t, 8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(t, 30 - 4 * i - j, 17 + 4 * i + j,
                  24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                H(t, 32 + i * 4 + j, 35 + i * 4 - j, i & 1)
    for i in range(2):
        B(t, 2 * i, 2 * i + 1, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            H(t, 4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            B(t, 14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                H(t, 16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                B(t, 61 - i * 8 - j, 34 + i * 8 + j,
                  56 - i * 32 + (j >> 1) * 64, 1)
    for i in range(2):
        H(t, i, 3 - i, 0)
    if n >= 3:
        B(t, 6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                H(t, 8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(t, 29 - 2 * i - j, 18 + 2 * i + j, 48 + (i << 6), 1)
    if n == 6:
        for i in range(4):
            for j in range(4):
                H(t, 32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            H(t, i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            B(t, 13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                H(t, 16 + i * 8 + j, 23 + i * 8 - j, i)
    if n == 6:
        for i in range(2):
            for j in range(4):
                B(t, 59 - i * 4 - j, 36 + i * 4 + j, 48 + (i << 6), 1)
    if n >= 4:
        for i in range(8):
            H(t, i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            B(t, 27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(2):
            for j in range(8):
                H(t, 32 + i * 16 + j, 47 + i * 16 - j, i)
    if n >= 5:
        for i in range(16):
            H(t, i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            B(t, 55 - i, 40 + i, 32, 1)
    if n == 6:
        for i in range(32):
            H(t, i, 63 - i, 0)
    return t


def iadst4(x: np.ndarray) -> np.ndarray:
    s1_9, s2_9, s3_9, s4_9 = T.SINPI
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0 = s1_9 * x0
    s1 = s2_9 * x0
    s2 = s3_9 * x1
    s3 = s4_9 * x2
    s4 = s1_9 * x2
    s5 = s2_9 * x3
    s6 = s4_9 * x3
    b7 = x0 - x2 + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = s3_9 * b7
    s0 = s0 + s5
    s1 = s1 - s6
    out = np.empty_like(x)
    out[..., 0] = _round2(s0 + s3, 12)
    out[..., 1] = _round2(s1 + s3, 12)
    out[..., 2] = _round2(s2, 12)
    out[..., 3] = _round2(s0 + s1 - s3, 12)
    return out


def _btf(w0, a, w1, b):
    return (w0 * a + w1 * b + 2048) >> 12


def iadst(x: np.ndarray, n: int) -> np.ndarray:
    """The inverse ADST of size 8 or 16 along the last axis (the stages of
    the specification's ADST8 / ADST16 processes)."""
    size = 1 << n
    c = T.Cos128_Lookup
    b = [None] * size
    for k in range(size // 2):
        b[2 * k] = x[..., size - 1 - 2 * k]
        b[2 * k + 1] = x[..., 2 * k]
    step = 128 // size
    o = [None] * size
    for k in range(size // 2):
        a = step // 4 + step * k
        o[2 * k] = _btf(c[a], b[2 * k], c[64 - a], b[2 * k + 1])
        o[2 * k + 1] = _btf(c[64 - a], b[2 * k], -c[a], b[2 * k + 1])
    b = o

    def adds(b, span):
        o = list(b)
        for base in range(0, size, 2 * span):
            for i in range(span):
                o[base + i] = b[base + i] + b[base + span + i]
                o[base + span + i] = b[base + i] - b[base + span + i]
        return o

    def rot(b, p, a1, a2):
        """(p, p + 1) <- rotation by (a1, a2); negative form if a1 < 0."""
        o0, o1 = b[p], b[p + 1]
        if a1 > 0:
            return _btf(c[a1], o0, c[a2], o1), _btf(c[a2], o0, -c[a1], o1)
        a1 = -a1
        return _btf(-c[a2], o0, c[a1], o1), _btf(c[a1], o0, c[a2], o1)

    if size == 16:
        b = adds(b, 8)
        b[8], b[9] = rot(b, 8, 8, 56)
        b[10], b[11] = rot(b, 10, 40, 24)
        b[12], b[13] = rot(b, 12, -8, 56)
        b[14], b[15] = rot(b, 14, -40, 24)
    b = adds(b, 4)
    for base in range(0, size, 8):
        b[base + 4], b[base + 5] = rot(b, base + 4, 16, 48)
        b[base + 6], b[base + 7] = rot(b, base + 6, -16, 48)
    b = adds(b, 2)
    for base in range(0, size, 4):
        p = base + 2
        b[p], b[p + 1] = (_btf(c[32], b[p], c[32], b[p + 1]),
                          _btf(c[32], b[p], -c[32], b[p + 1]))
    if size == 8:
        order = [0, -4, 6, -2, 3, -7, 5, -1]
    else:
        order = [0, -8, 12, -4, 6, -14, 10, -2, 3, -11, 15, -7, 5, -13, 9,
                 -1]
    out = np.empty_like(x)
    for i, j in enumerate(order):
        out[..., i] = b[j] if (j > 0 or i == 0) else -b[-j]
    return out


def identity(x: np.ndarray, n: int) -> np.ndarray:
    if n == 2:
        return _round2(x * 5793, 12)
    if n == 3:
        return x * 2
    if n == 4:
        return _round2(x * 11586, 12)
    return x * 4


def iwht(x: np.ndarray, shift: int) -> np.ndarray:
    a = x[..., 0] >> shift
    c = x[..., 1] >> shift
    d = x[..., 2] >> shift
    b = x[..., 3] >> shift
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return np.stack([a, b, c, d], axis=-1)


def _one_d(x, kind, n):
    if kind == 0:
        return idct(x, n)
    if kind in (1, 2):
        return iadst4(x) if n == 2 else iadst(x, n)
    return identity(x, n)


def inverse_transform_2d(coef: np.ndarray, tx_size: int, tx_type: int,
                         lossless: bool, bit_depth: int) -> np.ndarray:
    """The 2-D inverse transform process: Dequant [h, w] (zero outside the
    coded 32 x 32) -> Residual [h, w] (int64)."""
    w, h = T.Tx_Width[tx_size], T.Tx_Height[tx_size]
    lw, lh = T.Tx_Width_Log2[tx_size], T.Tx_Height_Log2[tx_size]
    t = np.zeros((h, w), np.int64)
    t[:min(h, 32), :min(w, 32)] = coef[:min(h, 32), :min(w, 32)]
    if lossless:
        t = iwht(t, 2)
        t = iwht(t.T, 0).T
        return t
    col_kind, row_kind = T.TX_1D[tx_type]
    row_shift = T.Transform_Row_Shift[tx_size]
    rows = min(h, 32)
    r = t[:rows]
    if abs(lw - lh) == 1:
        r = _round2(r * 2896, 12)
    lim = 1 << (bit_depth + 7)
    r = np.clip(r, -lim, lim - 1)
    r = _one_d(r, row_kind, lw)
    if row_kind == 2:
        r = r[:, ::-1]
    r = _round2(r, row_shift)
    res = np.zeros((h, w), np.int64)
    res[:rows] = r
    col_lim = 1 << (max(bit_depth + 6, 16) - 1)
    res = np.clip(res, -col_lim, col_lim - 1)
    c = _one_d(res.T.copy(), col_kind, lh).T
    if col_kind == 2:
        c = c[::-1]
    return _round2(c, 4)
