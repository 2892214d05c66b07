"""AV1 intra prediction (specification section 7.11.2): the edge arrays,
DC, directional (with the edge filter, corner filter and upsampling),
smooth, SMOOTH_V / SMOOTH_H, Paeth, the recursive filter intra, chroma from
luma and palette prediction.  Each predictor works on a whole block with
numpy (int64).
"""
from __future__ import annotations

import numpy as np

from . import av1_data as D
from . import av1_tables as T


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def sm_weights(n: int) -> np.ndarray:
    o = T.SM_WEIGHT_OFFSET[n]
    return D.Sm_Weights[o:o + n].astype(np.int64)


def edges(frame, x, y, w, h, have_left, have_above, have_above_right,
          have_below_left, max_x, max_y, bit_depth):
    """AboveRow[-1 .. w + h - 1] and LeftCol[-1 .. w + h - 1] (index 0 of
    each array is position -1)."""
    n = w + h
    above = np.empty(n + 1, np.int64)
    left = np.empty(n + 1, np.int64)
    base = 1 << (bit_depth - 1)
    if not have_above and have_left:
        above[1:] = frame[y, x - 1]
    elif not have_above and not have_left:
        above[1:] = base - 1
    else:
        lim = min(max_x, x + (2 * w if have_above_right else w) - 1)
        idx = np.minimum(lim, x + np.arange(n))
        above[1:] = frame[y - 1, idx]
    if not have_left and have_above:
        left[1:] = frame[y - 1, x]
    elif not have_left and not have_above:
        left[1:] = base + 1
    else:
        lim = min(max_y, y + (2 * h if have_below_left else h) - 1)
        idx = np.minimum(lim, y + np.arange(n))
        left[1:] = frame[idx, x - 1]
    if have_above and have_left:
        corner = frame[y - 1, x - 1]
    elif have_above:
        corner = frame[y - 1, x]
    elif have_left:
        corner = frame[y, x - 1]
    else:
        corner = base
    above[0] = left[0] = corner
    return above, left


def dc_pred(above, left, w, h, have_left, have_above, bit_depth):
    if have_left and have_above:
        s = int(left[1:h + 1].sum() + above[1:w + 1].sum())
        v = (s + ((w + h) >> 1)) // (w + h)
    elif have_left:
        s = int(left[1:h + 1].sum())
        v = min((s + (h >> 1)) >> (h.bit_length() - 1), (1 << bit_depth) - 1)
    elif have_above:
        s = int(above[1:w + 1].sum())
        v = min((s + (w >> 1)) >> (w.bit_length() - 1), (1 << bit_depth) - 1)
    else:
        v = 1 << (bit_depth - 1)
    return np.full((h, w), v, np.int64)


def smooth_pred(above, left, w, h, mode):
    a = above[1:w + 1][None, :]
    lc = left[1:h + 1][:, None]
    if mode == T.SMOOTH_PRED:
        wy = sm_weights(h)[:, None]
        wx = sm_weights(w)[None, :]
        p = wy * a + (256 - wy) * left[h] + wx * lc + (256 - wx) * above[w]
        return _round2(p, 9)
    if mode == T.SMOOTH_V_PRED:
        wy = sm_weights(h)[:, None]
        return _round2(wy * a + (256 - wy) * left[h], 8) + 0 * lc
    wx = sm_weights(w)[None, :]
    return _round2(wx * lc + (256 - wx) * above[w], 8) + 0 * a


def paeth_pred(above, left, w, h):
    a = above[1:w + 1][None, :]
    lc = left[1:h + 1][:, None]
    tl = above[0]
    base = a + lc - tl
    p_left = np.abs(base - lc)
    p_top = np.abs(base - a)
    p_tl = np.abs(base - tl)
    return np.where((p_left <= p_top) & (p_left <= p_tl), lc,
                    np.where(p_top <= p_tl, a, tl))


def _filter_strength(w, h, filter_type, delta):
    d = abs(delta)
    wh = w + h
    s = 0
    if filter_type == 0:
        if wh <= 8:
            s = 1 if d >= 56 else 0
        elif wh <= 16:
            s = 1 if d >= 40 else 0
        elif wh <= 24:
            s = 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        elif wh <= 32:
            s = 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        else:
            s = 3 if d >= 1 else 0
    else:
        if wh <= 8:
            s = 2 if d >= 64 else 1 if d >= 40 else 0
        elif wh <= 16:
            s = 2 if d >= 48 else 1 if d >= 20 else 0
        elif wh <= 24:
            s = 3 if d >= 4 else 0
        else:
            s = 3 if d >= 1 else 0
    return s


def _edge_filter(buf, sz, strength):
    """The intra edge filter on buf[0 .. sz - 1] (buf[0] is position -1):
    writes positions 0 .. sz - 2."""
    if strength == 0 or sz <= 1:
        return
    edge = buf[:sz].copy()
    k = T.Intra_Edge_Kernel[strength - 1]
    i = np.arange(1, sz)
    s = np.zeros(sz - 1, np.int64)
    for j in range(5):
        s += k[j] * edge[np.clip(i - 2 + j, 0, sz - 1)]
    buf[1:sz] = (s + 8) >> 4


def _upsample(buf, num_px, bit_depth):
    """The intra edge upsample process: returns the doubled array whose
    index 0 is position -2."""
    dup = np.empty(num_px + 3, np.int64)
    dup[0] = buf[0]
    dup[1:num_px + 2] = buf[0:num_px + 1]
    dup[num_px + 2] = buf[num_px]
    out = np.zeros(2 * num_px + 2 + 64, np.int64)
    out[0] = dup[0]
    i = np.arange(num_px)
    s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
    s = np.clip(_round2(s, 4), 0, (1 << bit_depth) - 1)
    out[2 * i + 1] = s          # position 2i - 1 (index + 2)
    out[2 * i + 2] = dup[i + 2]  # position 2i
    return out


def directional_pred(above, left, w, h, p_angle, have_left, have_above,
                     enable_edge_filter, filter_type, max_x_avail,
                     max_y_avail, bit_depth):
    """The directional intra prediction process.  `max_x_avail` is
    maxX - x + 1 and `max_y_avail` maxY - y + 1."""
    above = above.copy()
    left = left.copy()
    n = w + h
    # pad so positions up to 2 * (w + h) read the last value
    above = np.concatenate([above, np.full(n + 64, above[-1])])
    left = np.concatenate([left, np.full(n + 64, left[-1])])
    up_above = up_left = 0
    if enable_edge_filter:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and (w + h) >= 24:
                c = _round2(left[1] * 5 + above[0] * 6 + above[1] * 5, 4)
                above[0] = left[0] = c
            if have_above:
                st = _filter_strength(w, h, filter_type, p_angle - 90)
                num = min(w, max_x_avail) + (h if p_angle < 90 else 0) + 1
                _edge_filter(above, num, st)
            if have_left:
                st = _filter_strength(w, h, filter_type, p_angle - 180)
                num = min(h, max_y_avail) + (w if p_angle > 180 else 0) + 1
                _edge_filter(left, num, st)
        up_above = _use_upsample(w, h, filter_type, p_angle - 90)
        if up_above:
            num = w + (h if p_angle < 90 else 0)
            above = _upsample(above, num, bit_depth)
        up_left = _use_upsample(w, h, filter_type, p_angle - 180)
        if up_left:
            num = h + (w if p_angle > 180 else 0)
            left = _upsample(left, num, bit_depth)
    # offset of position 0 in each array
    oa = 2 if up_above else 1
    ol = 2 if up_left else 1
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if p_angle == 90:
        return np.broadcast_to(above[oa:oa + w][None, :], (h, w)).copy()
    if p_angle == 180:
        return np.broadcast_to(left[ol:ol + h][:, None], (h, w)).copy()
    if p_angle < 90:
        dx = int(D.Dr_Intra_Derivative[p_angle])
        idx = (i + 1) * dx
        base = (idx >> (6 - up_above)) + (j << up_above)
        shift = ((idx << up_above) >> 1) & 0x1F
        max_base = (w + h - 1) << up_above
        b = np.minimum(base, max_base)
        v = _round2(above[oa + b] * (32 - shift) + above[oa + b + 1] * shift,
                    5)
        return np.where(base < max_base, v, above[oa + max_base])
    if p_angle > 180:
        dy = int(D.Dr_Intra_Derivative[270 - p_angle])
        idx = (j + 1) * dy
        base = (idx >> (6 - up_left)) + (i << up_left)
        shift = ((idx << up_left) >> 1) & 0x1F
        max_base = (w + h - 1) << up_left
        b = np.minimum(base, max_base)
        v = _round2(left[ol + b] * (32 - shift) + left[ol + b + 1] * shift, 5)
        return np.where(base < max_base, v, left[ol + max_base])
    dx = int(D.Dr_Intra_Derivative[180 - p_angle])
    dy = int(D.Dr_Intra_Derivative[p_angle - 90])
    idx = (j << 6) - (i + 1) * dx
    base = idx >> (6 - up_above)
    use_above = base >= -(1 << up_above)
    shift = ((idx << up_above) >> 1) & 0x1F
    b = np.maximum(base, -(1 << up_above))
    va = _round2(above[oa + b] * (32 - shift) + above[oa + b + 1] * shift, 5)
    idx2 = (i << 6) - (j + 1) * dy
    base2 = idx2 >> (6 - up_left)
    shift2 = ((idx2 << up_left) >> 1) & 0x1F
    b2 = np.maximum(base2, -(1 << up_left))
    vl = _round2(left[ol + b2] * (32 - shift2) + left[ol + b2 + 1] * shift2,
                 5)
    return np.where(use_above, va, vl)


def _use_upsample(w, h, filter_type, delta):
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int((w + h) <= (16 if filter_type == 0 else 8))


def filter_intra_pred(above, left, w, h, mode, bit_depth):
    """The recursive intra prediction process (filter intra)."""
    taps = D.Intra_Filter_Taps[mode].astype(np.int64)    # [8][7]
    pred = np.zeros((h, w), np.int64)
    hi = (1 << bit_depth) - 1
    for i2 in range(h >> 1):
        for j4 in range(w >> 2):
            p = np.empty(7, np.int64)
            r0, c0 = i2 << 1, j4 << 2
            for k in range(5):
                if i2 == 0:
                    p[k] = above[c0 + k]            # position c0 + k - 1
                elif j4 == 0 and k == 0:
                    p[k] = left[r0]                 # position r0 - 1
                else:
                    p[k] = pred[r0 - 1, c0 + k - 1]
            for k in (5, 6):
                if j4 == 0:
                    p[k] = left[r0 + k - 5 + 1]
                else:
                    p[k] = pred[r0 + k - 5, c0 - 1]
            pr = taps @ p
            v = np.where(pr >= 0, (pr + 8) >> 4, -((-pr + 8) >> 4))
            pred[r0:r0 + 2, c0:c0 + 4] = np.clip(v, 0, hi).reshape(2, 4)
    return pred


def cfl_pred(luma, chroma, sx, sy, w, h, ssx, ssy, max_luma_w, max_luma_h,
             alpha, bit_depth):
    """predict_chroma_from_luma on chroma block (sx, sy, w, h), in place."""
    i = np.arange(h)
    j = np.arange(w)
    ly = np.minimum(sy + i, (max_luma_h >> ssy) - 1) << ssy
    lx = np.minimum(sx + j, (max_luma_w >> ssx) - 1) << ssx
    t = np.zeros((h, w), np.int64)
    for dy in range(ssy + 1):
        for dx in range(ssx + 1):
            t += luma[(ly + dy)[:, None], (lx + dx)[None, :]]
    L = t << (3 - ssx - ssy)
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    avg = _round2(int(L.sum()), lw + lh)
    dc = chroma[sy:sy + h, sx:sx + w].astype(np.int64)
    d = alpha * (L - avg)
    scaled = np.where(d >= 0, (d + 32) >> 6, -((-d + 32) >> 6))
    chroma[sy:sy + h, sx:sx + w] = np.clip(dc + scaled, 0,
                                           (1 << bit_depth) - 1)
