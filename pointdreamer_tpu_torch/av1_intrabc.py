"""AV1 IntraBC (specification sections 5.11.26, 7.10.2 and 7.11.3): the
part of the motion-vector stack process an intra frame runs (the row,
column and point scans of earlier IntraBC neighbours, weights, sorting,
clamping), the reference DV and its default, the DV's coding
(MV_INTRABC_CONTEXT), and the prediction: a copy from the frame before its
filters, with the bilinear filter where a chroma DV falls on a half
sample.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T

MV_BORDER = 128
INTRABC_DELAY_PIXELS = 256


class _Stack:
    def __init__(self):
        self.mvs = []
        self.weights = []
        self.found = 0

    def add(self, mv, weight):
        self.found = 1
        for i, m in enumerate(self.mvs):
            if m == mv:
                self.weights[i] += weight
                return
        if len(self.mvs) < 8:
            self.mvs.append(mv)
            self.weights.append(weight)


def _candidate(fd, stack, r, c, weight):
    if not fd.is_inside(r, c):
        return False
    idx = fd.block_map[r, c]
    if idx < 0:
        return False
    nb = fd.blocks[idx]
    if nb.is_inter:
        stack.add(nb.mv, weight)
    return True


def _scan_row(fd, stack, b, delta_row):
    bw4 = T.Num_4x4_Blocks_Wide[b.mi_size]
    end4 = min(min(bw4, fd.hdr.MiCols - b.mi_col), 16)
    delta_col = 0
    step16 = bw4 >= 16
    if abs(delta_row) > 1:
        delta_row += b.mi_row & 1
        delta_col = 1 - (b.mi_col & 1)
    i = 0
    while i < end4:
        r = b.mi_row + delta_row
        c = b.mi_col + delta_col + i
        if not fd.is_inside(r, c):
            break
        ln = min(bw4, T.Num_4x4_Blocks_Wide[fd.blk_at(r, c).mi_size])
        if abs(delta_row) > 1:
            ln = max(2, ln)
        if step16:
            ln = max(4, ln)
        _candidate(fd, stack, r, c, ln * 2)
        i += ln


def _scan_col(fd, stack, b, delta_col):
    bh4 = T.Num_4x4_Blocks_High[b.mi_size]
    end4 = min(min(bh4, fd.hdr.MiRows - b.mi_row), 16)
    delta_row = 0
    step16 = bh4 >= 16
    if abs(delta_col) > 1:
        delta_row = 1 - (b.mi_row & 1)
        delta_col += b.mi_col & 1
    i = 0
    while i < end4:
        r = b.mi_row + delta_row + i
        c = b.mi_col + delta_col
        if not fd.is_inside(r, c):
            break
        ln = min(bh4, T.Num_4x4_Blocks_High[fd.blk_at(r, c).mi_size])
        if abs(delta_col) > 1:
            ln = max(2, ln)
        if step16:
            ln = max(4, ln)
        _candidate(fd, stack, r, c, ln * 2)
        i += ln


def _scan_point(fd, stack, b, dr, dc):
    _candidate(fd, stack, b.mi_row + dr, b.mi_col + dc, 4)


def _sort(stack, start, end):
    w, m = stack.weights, stack.mvs
    while end > start:
        new_end = start
        for i in range(start + 1, end):
            if w[i - 1] < w[i]:
                w[i - 1], w[i] = w[i], w[i - 1]
                m[i - 1], m[i] = m[i], m[i - 1]
                new_end = i
        end = new_end


def find_mv_stack(fd, b):
    """RefStackMv[0..1][0] of an IntraBC block (intra frame: no temporal
    candidates, global motion zero)."""
    bw4 = T.Num_4x4_Blocks_Wide[b.mi_size]
    bh4 = T.Num_4x4_Blocks_High[b.mi_size]
    st = _Stack()
    _scan_row(fd, st, b, -1)
    _scan_col(fd, st, b, -1)
    if max(bw4, bh4) <= 16:
        _scan_point(fd, st, b, -1, bw4)
    nearest = len(st.mvs)
    for i in range(nearest):
        st.weights[i] += 640
    _scan_point(fd, st, b, -1, -1)
    _scan_row(fd, st, b, -3)
    _scan_col(fd, st, b, -3)
    if bh4 > 1:
        _scan_row(fd, st, b, -5)
    if bw4 > 1:
        _scan_col(fd, st, b, -5)
    _sort(st, 0, nearest)
    _sort(st, nearest, len(st.mvs))
    hdr = fd.hdr
    top = -((b.mi_row * 4) * 8)
    bottom = ((hdr.MiRows - bh4 - b.mi_row) * 4) * 8
    left = -((b.mi_col * 4) * 8)
    right = ((hdr.MiCols - bw4 - b.mi_col) * 4) * 8
    brow = MV_BORDER + bh4 * 4 * 8
    bcol = MV_BORDER + bw4 * 4 * 8
    out = []
    for mv in st.mvs:
        out.append((max(top - brow, min(bottom + brow, mv[0])),
                    max(left - bcol, min(right + bcol, mv[1]))))
    while len(out) < 2:
        out.append((0, 0))
    return out


def _read_component(fd, comp):
    sd, cdf = fd.sd, fd.cdf
    sign = sd.read_symbol(cdf["mv_sign"][comp])
    cls = sd.read_symbol(cdf["mv_class"][comp])
    if cls == 0:
        bit = sd.read_symbol(cdf["mv_class0_bit"][comp])
        mag = ((bit << 3) | (3 << 1) | 1) + 1
    else:
        d = 0
        for i in range(cls):
            d |= sd.read_symbol(cdf["mv_bit"][comp][i]) << i
        mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1
    return -mag if sign else mag


def read_dv(fd, b, r, c, bw4, bh4):
    """find_mv_stack(0), assign_mv(0) of an IntraBC block."""
    stack = find_mv_stack(fd, b)
    pred = stack[0]
    if pred == (0, 0):
        pred = stack[1]
    if pred == (0, 0):
        sb4 = 32 if fd.sb128 else 16
        if b.mi_row - sb4 < fd.mi_row_start:
            pred = (0, -(sb4 * 4 + INTRABC_DELAY_PIXELS) * 8)
        else:
            pred = (-(sb4 * 4 * 8), 0)
    joint = fd.sd.read_symbol(fd.cdf["mv_joint"])
    d0 = _read_component(fd, 0) if joint in (2, 3) else 0
    d1 = _read_component(fd, 1) if joint in (1, 3) else 0
    b.mv = (pred[0] + d0, pred[1] + d1)


def _bilinear(pos):
    return [0, 0, 0, 128 - pos * 8, pos * 8, 0, 0, 0]


def predict(fd, b, r, c, bsize):
    """predict_inter of an IntraBC block on each plane (every block of an
    intra frame is INTRA_FRAME, so chroma takes the block's own DV)."""
    hdr = fd.hdr
    bd = fd.bit_depth
    r0 = 5 if bd == 12 else 3
    r1 = 9 if bd == 12 else 11
    for p in range(1 + 2 * b.has_chroma):
        sx = fd.ssx if p else 0
        sy = fd.ssy if p else 0
        psz = T.subsampled_size(bsize, sx, sy)
        w = T.Num_4x4_Blocks_Wide[psz] * 4
        h = T.Num_4x4_Blocks_High[psz] * 4
        x = (c >> sx) * 4
        y = (r >> sy) * 4
        # motion vector scaling without scaling, positions in 1/1024
        orig_x = (x << 4) + ((2 * b.mv[1]) >> sx) + 8
        orig_y = (y << 4) + ((2 * b.mv[0]) >> sy) + 8
        start_x = ((orig_x << 14) - (8 << 14))
        start_y = ((orig_y << 14) - (8 << 14))
        start_x = _round2s(start_x, 14 + 4 - 10) + 32
        start_y = _round2s(start_y, 14 + 4 - 10) + 32
        ref = fd.frame[p]
        last_x = ((hdr.UpscaledWidth + sx) >> sx) - 1
        last_y = ((hdr.FrameHeight + sy) >> sy) - 1
        inter_h = (((h - 1) * 1024 + 1023) >> 10) + 8
        rows = np.clip((start_y >> 10) + np.arange(inter_h) - 3, 0, last_y)
        px = start_x + 1024 * np.arange(w)
        fx = (px >> 6) & 15
        taps = np.array([_bilinear(int(f)) for f in fx])        # [w, 8]
        inter = np.zeros((inter_h, w), np.int64)
        src = ref.astype(np.int64)
        for t in range(8):
            cols = np.clip((px >> 10) + t - 3, 0, last_x)
            inter += taps[None, :, t] * src[rows[:, None], cols[None, :]]
        inter = (inter + (1 << (r0 - 1))) >> r0
        py = (start_y & 1023) + 1024 * np.arange(h)
        fy = (py >> 6) & 15
        vt = np.array([_bilinear(int(f)) for f in fy])           # [h, 8]
        out = np.zeros((h, w), np.int64)
        for t in range(8):
            out += vt[:, t:t + 1] * inter[(py >> 10) + t]
        out = (out + (1 << (r1 - 1))) >> r1
        ref[y:y + h, x:x + w] = np.clip(out, 0, (1 << bd) - 1)


def _round2s(x, n):
    if x >= 0:
        return (x + (1 << (n - 1))) >> n
    return -((-x + (1 << (n - 1))) >> n)
