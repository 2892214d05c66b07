"""AV1 deblocking (specification section 7.14): edges of transform and
block boundaries, filter levels by segment, delta lf and the reference
deltas, the 4-tap narrow filter and the 6 / 8 / 14-tap wide filters.

Edges of one pass (all vertical edges, then all horizontal ones, of a
plane) never read what another edge of the same pass writes, so each pass
is filtered at once: every 4-sample edge segment is gathered into a row
of taps, the masks and filters run on all rows with numpy, and the rows
are scattered back.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T


def _levels(fd, plane, pss):
    """Filter level of each block for (plane, pass)."""
    hdr = fd.hdr
    i = pss if plane == 0 else plane + 1
    out = np.zeros(len(fd.blocks), np.int64)
    for k, b in enumerate(fd.blocks):
        d = b.delta_lf[i] if hdr.delta_lf_multi else b.delta_lf[0]
        lvl = max(0, min(63, d + hdr.loop_filter_level[i]))
        feat = T.SEG_LVL_ALT_LF_Y_V + i
        if hdr.segmentation_enabled and \
                hdr.FeatureEnabled[b.segment_id][feat]:
            lvl = max(0, min(63, lvl + hdr.FeatureData[b.segment_id][feat]))
        if hdr.loop_filter_delta_enabled:
            lvl += hdr.loop_filter_ref_deltas[0] << (lvl >> 5)
            lvl = max(0, min(63, lvl))
        out[k] = lvl
    return out


def loop_filter_frame(fd):
    hdr = fd.hdr
    if not (hdr.loop_filter_level[0] or hdr.loop_filter_level[1]):
        return
    fd.stats.hit("deblock")
    for plane in range(fd.num_planes):
        if plane > 0 and not hdr.loop_filter_level[plane + 1]:
            continue
        for pss in (0, 1):
            _pass(fd, plane, pss)


def _pass(fd, plane, pss):
    hdr = fd.hdr
    bd = fd.bit_depth
    sx = fd.ssx if plane else 0
    sy = fd.ssy if plane else 0
    rows4 = hdr.MiRows >> sy
    cols4 = hdr.MiCols >> sx
    i4 = np.arange(rows4)[:, None]
    j4 = np.arange(cols4)[None, :]
    x = (j4 << sx) * 4
    y = (i4 << sy) * 4
    on = (x < hdr.FrameWidth) & (y < hdr.FrameHeight)
    on = on & ((x > 0) if pss == 0 else (y > 0))
    mi_r = np.minimum((i4 << sy) | sy, hdr.MiRows - 1)
    mi_c = np.minimum((j4 << sx) | sx, hdr.MiCols - 1)
    dy, dx = (1, 0) if pss == 1 else (0, 1)
    lf = fd.lf_tx_size[plane][:rows4 + 1, :cols4 + 1].astype(np.int64)
    tx = lf[:rows4, :cols4]
    pi = np.maximum(i4 - dy, 0)
    pj = np.maximum(j4 - dx, 0)
    prev_tx = lf[pi, pj]
    tw = np.array(T.Tx_Width)
    th = np.array(T.Tx_Height)
    if pss == 0:
        edge = ((4 * j4) % tw[tx]) == 0
        base = np.minimum(tw[prev_tx], tw[tx])
    else:
        edge = ((4 * i4) % th[tx]) == 0
        base = np.minimum(th[prev_tx], th[tx])
    size = np.minimum(base, 16 if plane == 0 else 8)
    levels = _levels(fd, plane, pss)
    bidx = fd.block_map[mi_r, mi_c]
    lvl = levels[bidx]
    p_mi_r = np.minimum((pi << sy) | sy, hdr.MiRows - 1)
    p_mi_c = np.minimum((pj << sx) | sx, hdr.MiCols - 1)
    lvl = np.where(lvl == 0, levels[fd.block_map[p_mi_r, p_mi_c]], lvl)
    sel = on & edge & (lvl > 0)
    ys, xs = np.nonzero(sel)
    if len(ys) == 0:
        return
    lv = lvl[ys, xs]
    fs = size[ys, xs]
    sharp = hdr.loop_filter_sharpness
    shift = 2 if sharp > 4 else (1 if sharp > 0 else 0)
    if sharp > 0:
        limit = np.clip(lv >> shift, 1, 9 - sharp)
    else:
        limit = np.maximum(1, lv >> shift)
    blimit = 2 * (lv + 2) + limit
    thresh = lv >> 4
    # four sample lines per edge segment
    k = np.arange(4)
    if pss == 0:
        ly = (4 * ys)[:, None] + k[None, :]
        lx = np.broadcast_to((4 * xs)[:, None], ly.shape)
    else:
        lx = (4 * xs)[:, None] + k[None, :]
        ly = np.broadcast_to((4 * ys)[:, None], lx.shape)
    ly, lx = ly.reshape(-1), lx.reshape(-1)
    rep = lambda a: np.repeat(a, 4)
    fs, limit, blimit, thresh = rep(fs), rep(limit), rep(blimit), \
        rep(thresh)
    frame = fd.frame[plane]
    taps = np.arange(-7, 7)
    if pss == 0:
        rr = ly[:, None] + 0 * taps[None, :]
        cc = lx[:, None] + taps[None, :]
    else:
        rr = ly[:, None] + taps[None, :]
        cc = lx[:, None] + 0 * taps[None, :]
    valid = (rr >= 0) & (cc >= 0)
    F = frame[np.maximum(rr, 0), np.maximum(cc, 0)].astype(np.int64)
    F = np.where(valid, F, 0)
    out = _filter(F, fs, limit, blimit, thresh, plane, bd)
    # only the samples a filter changed: the taps an edge reads but keeps
    # may be samples the next edge of the pass writes
    keep = valid & (out != F)
    frame[rr[keep], cc[keep]] = out[keep]


def _filter(F, fs, limit, blimit, thresh, plane, bd):
    """Sample filtering of each row of taps F[:, k + 7], k = -7 .. 6."""
    def s(k):
        return F[:, k + 7]
    p = [s(-1 - i) for i in range(7)]
    q = [s(i) for i in range(7)]
    sh = bd - 8
    a = np.abs
    hev = (a(p[1] - p[0]) > (thresh << sh)) | (a(q[1] - q[0]) > (thresh << sh))
    flen = np.where(fs == 4, 4, 6 if plane else np.where(fs == 8, 8, 16))
    lim = limit << sh
    blim = blimit << sh
    mask = (a(p[1] - p[0]) > lim) | (a(q[1] - q[0]) > lim) | \
        (a(p[0] - q[0]) * 2 + a(p[1] - q[1]) // 2 > blim)
    m6 = flen >= 6
    mask |= m6 & ((a(p[2] - p[1]) > lim) | (a(q[2] - q[1]) > lim))
    m8 = flen >= 8
    mask |= m8 & ((a(p[3] - p[2]) > lim) | (a(q[3] - q[2]) > lim))
    filt = ~mask
    one = 1 << sh
    fm = (a(p[1] - p[0]) > one) | (a(q[1] - q[0]) > one) | \
        (a(p[2] - p[0]) > one) | (a(q[2] - q[0]) > one)
    fm |= m8 & ((a(p[3] - p[0]) > one) | (a(q[3] - q[0]) > one))
    flat = (fs >= 8) & ~fm
    fm2 = (a(p[6] - p[0]) > one) | (a(q[6] - q[0]) > one) | \
        (a(p[5] - p[0]) > one) | (a(q[5] - q[0]) > one) | \
        (a(p[4] - p[0]) > one) | (a(q[4] - q[0]) > one)
    flat2 = (fs >= 16) & ~fm2
    out = F.copy()
    narrow = filt & ((fs == 4) | ~flat)
    wide3 = filt & ~narrow & ((fs == 8) | ~flat2)
    wide4 = filt & ~narrow & ~wide3
    if narrow.any():
        _narrow(F, out, narrow, hev, bd)
    if wide3.any():
        _wide(F, out, wide3, 3, plane)
    if wide4.any():
        _wide(F, out, wide4, 4, plane)
    return out


def _narrow(F, out, sel, hev, bd):
    lo, hi = -(1 << (bd - 1)), (1 << (bd - 1)) - 1
    off = 0x80 << (bd - 8)
    f = F[sel]
    hv = hev[sel]
    ps1, ps0 = f[:, 5] - off, f[:, 6] - off
    qs0, qs1 = f[:, 7] - off, f[:, 8] - off
    c = lambda v: np.clip(v, lo, hi)
    filt = np.where(hv, c(ps1 - qs1), 0)
    filt = c(filt + 3 * (qs0 - ps0))
    f1 = c(filt + 4) >> 3
    f2 = c(filt + 3) >> 3
    f[:, 7] = c(qs0 - f1) + off
    f[:, 6] = c(ps0 + f2) + off
    f3 = (f1 + 1) >> 1
    f[:, 8] = np.where(hv, f[:, 8], c(qs1 - f3) + off)
    f[:, 5] = np.where(hv, f[:, 5], c(ps1 + f3) + off)
    out[sel] = f


def _wide(F, out, sel, log2, plane):
    if log2 == 4:
        n = 6
    elif plane == 0:
        n = 3
    else:
        n = 2
    n2 = 0 if (log2 == 3 and plane == 0) else 1
    f = F[sel]
    res = f.copy()
    for i in range(-n, n):
        t = 0
        for j in range(-n, n + 1):
            pidx = max(-(n + 1), min(n, i + j))
            tap = 2 if abs(j) <= n2 else 1
            t = t + f[:, pidx + 7] * tap
        res[:, i + 7] = (t + (1 << (log2 - 1))) >> log2
    out[sel] = res
