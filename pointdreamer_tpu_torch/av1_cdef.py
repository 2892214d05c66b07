"""AV1 CDEF (specification section 7.15): the direction search on each
8x8 luma block, primary and secondary taps with their constraint and
damping, the skip rules (an unsignalled 64x64 filter block, an 8x8 whose
four 4x4s are all skipped), and the frame edges.  All 8x8 blocks of a
frame are filtered at once with numpy.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T

# pixel (i, j) of an 8x8 -> index into partial[d] (the direction search)
_PART = np.zeros((8, 64, 15), np.int64)
for _i in range(8):
    for _j in range(8):
        _k = _i * 8 + _j
        for _d, _idx in enumerate((_i + _j, _i + _j // 2, _i,
                                   3 + _i - _j // 2, 7 + _i - _j,
                                   3 - _i // 2 + _j, _j, _i // 2 + _j)):
            _PART[_d, _k, _idx] = 1


def _directions(luma8, bit_depth):
    """cdef_direction_process on [n, 8, 8] luma blocks -> (dir, var)."""
    x = (luma8.reshape(len(luma8), 64).astype(np.int64) >>
         (bit_depth - 8)) - 128
    partial = np.einsum("nk,dkp->ndp", x, _PART)
    div = T.Div_Table
    cost = np.zeros((len(x), 8), np.int64)
    sq = partial * partial
    cost[:, 2] = sq[:, 2, :8].sum(1) * div[8]
    cost[:, 6] = sq[:, 6, :8].sum(1) * div[8]
    for d in (0, 4):
        for i in range(7):
            cost[:, d] += (sq[:, d, i] + sq[:, d, 14 - i]) * div[i + 1]
        cost[:, d] += sq[:, d, 7] * div[8]
    for d in (1, 3, 5, 7):
        cost[:, d] = sq[:, d, 3:8].sum(1) * div[8]
        for j in range(3):
            cost[:, d] += (sq[:, d, j] + sq[:, d, 10 - j]) * div[2 * j + 2]
    best = np.argmax(cost, axis=1)              # first of equal maxima
    bc = cost[np.arange(len(x)), best]
    var = (bc - cost[np.arange(len(x)), (best + 4) & 7]) >> 10
    return best, var


def _constrain(diff, thr, damping):
    with np.errstate(divide="ignore"):
        lg = np.where(thr > 0, np.floor(np.log2(np.maximum(thr, 1))), 0)
    adj = np.maximum(0, damping - lg.astype(np.int64))
    a = np.abs(diff)
    val = np.minimum(a, np.maximum(0, thr - (a >> adj)))
    return np.where(thr > 0, np.sign(diff) * val, 0)


def cdef_frame(fd):
    hdr, seq = fd.hdr, fd.seq
    if hdr.CodedLossless or hdr.allow_intrabc or not seq.enable_cdef:
        return
    rows8, cols8 = hdr.MiRows // 2, hdr.MiCols // 2
    r = np.arange(rows8)[:, None] * 2
    c = np.arange(cols8)[None, :] * 2
    idx = np.full((rows8, cols8), -1, np.int64)
    for (fr, fc), v in fd.cdef_idx.items():
        if v == -1:
            continue
        r0, c0 = fr * 8, fc * 8
        idx[r0:r0 + 8, c0:c0 + 8] = v
    skips = np.array([b.skip for b in fd.blocks], bool)[fd.block_map[
        :hdr.MiRows, :hdr.MiCols]]
    skip8 = skips[0::2, 0::2] & skips[1::2, 0::2] & skips[0::2, 1::2] & \
        skips[1::2, 1::2]
    active = (idx >= 0) & ~skip8
    if not active.any():
        return
    fd.stats.hit("cdef")
    bd = fd.bit_depth
    shift = bd - 8
    luma = fd.frame[0][:rows8 * 8, :cols8 * 8]
    blocks = luma.reshape(rows8, 8, cols8, 8).transpose(0, 2, 1, 3)
    ydir = np.zeros((rows8, cols8), np.int64)
    var = np.zeros((rows8, cols8), np.int64)
    ar, ac = np.nonzero(active)
    d, v = _directions(blocks[ar, ac], bd)
    ydir[ar, ac] = d
    var[ar, ac] = v
    safe = np.maximum(idx, 0)
    ypri = np.array(hdr.cdef_y_pri_strength)[safe] << shift
    ysec = np.array(hdr.cdef_y_sec_strength)[safe] << shift
    vs = np.where((var >> 6) > 0,
                  np.minimum(np.floor(np.log2(np.maximum(var >> 6, 1))), 12),
                  0).astype(np.int64)
    ypri_adj = np.where(var > 0, (ypri * (4 + vs) + 8) >> 4, 0)
    y_dir = np.where(ypri == 0, 0, ydir)
    out = [None] * fd.num_planes
    out[0] = _filter_plane(fd, 0, active, ypri_adj, ysec,
                           hdr.cdef_damping + shift, y_dir)
    if fd.num_planes > 1:
        upri = np.array(hdr.cdef_uv_pri_strength)[safe] << shift
        usec = np.array(hdr.cdef_uv_sec_strength)[safe] << shift
        uv_dir_tab = np.array(T.Cdef_Uv_Dir[fd.ssx][fd.ssy])
        u_dir = np.where(upri == 0, 0, uv_dir_tab[ydir])
        for p in (1, 2):
            out[p] = _filter_plane(fd, p, active, upri, usec,
                                   hdr.cdef_damping + shift - 1, u_dir)
    for p in range(fd.num_planes):
        if out[p] is not None:
            fd.frame[p][:out[p].shape[0], :out[p].shape[1]] = out[p]


def _filter_plane(fd, plane, active, pri, sec, damping, dirs):
    """cdef_filter on every active 8x8 (in its plane's size)."""
    hdr = fd.hdr
    sx = fd.ssx if plane else 0
    sy = fd.ssy if plane else 0
    bw, bh = 8 >> sx, 8 >> sy
    rows8, cols8 = active.shape
    H, W = rows8 * bh, cols8 * bw
    frame = fd.frame[plane]
    cur = frame[:H, :W].astype(np.int64)
    pad = 3
    src = np.zeros((H + 2 * pad, W + 2 * pad), np.int64)
    src[pad:pad + H, pad:pad + W] = cur
    avail = np.zeros_like(src, dtype=bool)
    # inside the frame in 4x4 units (is_inside_filter_region)
    ph = (hdr.MiRows * 4) >> sy
    pw = (hdr.MiCols * 4) >> sx
    avail[pad:pad + min(H, ph), pad:pad + min(W, pw)] = True
    # per-pixel parameters
    expand = lambda a: np.repeat(np.repeat(a, bh, 0), bw, 1)
    act = expand(active)
    P = expand(pri)
    coef_sel = expand((pri >> (fd.bit_depth - 8)) & 1)
    S = expand(sec)
    Dd = expand(dirs)
    yy, xx = np.mgrid[0:H, 0:W]
    x = cur
    total = np.zeros_like(cur)
    mx = x.copy()
    mn = x.copy()
    dirs_tab = np.array(T.Cdef_Directions)        # [8][2][2]
    pri_taps = np.array(T.Cdef_Pri_Taps)
    sec_taps = np.array(T.Cdef_Sec_Taps)
    for k in range(2):
        for sign in (-1, 1):
            for off, is_pri in ((0, True), (-2, False), (2, False)):
                dd = (Dd + off) & 7
                oy = sign * dirs_tab[dd, k, 0]
                ox = sign * dirs_tab[dd, k, 1]
                ry = yy + oy + pad
                rx = xx + ox + pad
                p = src[ry, rx]
                av = avail[ry, rx]
                if is_pri:
                    tap = pri_taps[coef_sel, k]
                    c = _constrain(p - x, P, damping)
                else:
                    tap = sec_taps[coef_sel, k]
                    c = _constrain(p - x, S, damping)
                total += np.where(av, tap * c, 0)
                mx = np.where(av, np.maximum(mx, p), mx)
                mn = np.where(av, np.minimum(mn, p), mn)
    res = np.clip(x + ((8 + total - (total < 0)) >> 4), mn, mx)
    return np.where(act, res, cur).astype(frame.dtype)
