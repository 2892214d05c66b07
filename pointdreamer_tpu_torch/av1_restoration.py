"""AV1 superres upscaling (specification section 7.16, `Upscale_Filter`)
and loop restoration (section 7.17): Wiener and self-guided filters on
64-row stripes offset by 8 rows, reading the rows above and below a stripe
from the deblocked frame before CDEF (upscaled), two rows at most.

Each (stripe, restoration unit) rectangle is filtered at once with numpy:
its source rows are gathered by the specification's get_source_sample
rule, then the filter runs on the whole rectangle.
"""
from __future__ import annotations

import numpy as np

from . import av1_data as D
from . import av1_tables as T


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def upscale(plane_arr, src_w, in_w, out_w, bit_depth):
    """Upscale every row of plane_arr[:, :src_w] to out_w samples."""
    step = ((in_w << 14) + (out_w >> 1)) // out_w
    err = out_w * step - (in_w << 14)
    x0 = _cdiv(-((out_w - in_w) << 13) + (out_w >> 1), out_w) + 128 - \
        _cdiv(err, 2)
    x0 &= 0x3FFF
    pos = -(1 << 14) + x0 + np.arange(out_w, dtype=np.int64) * step
    src_x = pos >> 14
    phase = (pos & 0x3FFF) >> 8
    filt = D.Upscale_Filter.astype(np.int64)[phase]          # [out_w, 8]
    src = plane_arr[:, :src_w].astype(np.int64)
    acc = np.zeros((src.shape[0], out_w), np.int64)
    for k in range(8):
        idx = np.clip(src_x - 3 + k, 0, src_w - 1)
        acc += src[:, idx] * filt[None, :, k]
    return np.clip((acc + 64) >> 7, 0, (1 << bit_depth) - 1)


def superres_and_restore(fd, pre_cdef):
    hdr, seq = fd.hdr, fd.seq
    bd = fd.bit_depth
    planes = [p.astype(np.int64) for p in fd.frame]
    pre = [p.astype(np.int64) for p in pre_cdef]
    if hdr.use_superres:
        fd.stats.hit("superres")
        for p in range(fd.num_planes):
            sx = seq.subsampling_x if p else 0
            in_w = (hdr.FrameWidth + sx) >> sx
            out_w = (hdr.UpscaledWidth + sx) >> sx
            src_w = (hdr.MiCols * 4) >> sx
            planes[p] = upscale(planes[p], src_w, in_w, out_w, bd)
            pre[p] = upscale(pre[p], src_w, in_w, out_w, bd)
    if not hdr.UsesLr:
        return planes
    out = [p.copy() for p in planes]
    for p in range(fd.num_planes):
        if hdr.FrameRestorationType[p] == T.RESTORE_NONE:
            continue
        _restore_plane(fd, p, planes[p], pre[p], out[p])
    return out


def _count_units(unit, size):
    return max((size + (unit >> 1)) // unit, 1)


def _restore_plane(fd, p, cdef, pre, out):
    hdr, seq = fd.hdr, fd.seq
    sx = seq.subsampling_x if p else 0
    sy = seq.subsampling_y if p else 0
    unit = hdr.LoopRestorationSize[p]
    plane_w = (hdr.UpscaledWidth + sx) >> sx
    plane_h = (hdr.FrameHeight + sy) >> sy
    unit_rows = _count_units(unit, plane_h)
    unit_cols = _count_units(unit, plane_w)
    end_x, end_y = plane_w - 1, plane_h - 1
    n_stripes = (hdr.FrameHeight + 8 + 63) // 64
    for s in range(n_stripes):
        start = (-8 + 64 * s) >> sy
        stop = start + (64 >> sy) - 1
        y0, y1 = max(0, start), min(end_y + 1, stop + 1)
        if y0 >= y1:
            continue
        luma_y = max(0, 64 * s - 8)
        ur = min(unit_rows - 1, ((luma_y + 8) >> sy) // unit)
        for uc in range(unit_cols):
            x0 = uc * unit
            x1 = end_x + 1 if uc == unit_cols - 1 else (uc + 1) * unit
            u = fd.lr[p].get((ur, uc))
            if u is None or u["type"] == T.RESTORE_NONE:
                continue
            src = _gather(cdef, pre, y0, y1, x0, x1, start, stop, end_x,
                          end_y, 4)
            if u["type"] == T.RESTORE_WIENER:
                res = _wiener(src, u["wiener"], y1 - y0, x1 - x0,
                              fd.bit_depth)
            else:
                res = _sgr(src, cdef[y0:y1, x0:x1], u["set"], u["xqd"],
                           y1 - y0, x1 - x0, fd.bit_depth)
            out[y0:y1, x0:x1] = res


def _gather(cdef, pre, y0, y1, x0, x1, start, stop, end_x, end_y, m):
    """get_source_sample over rows y0 - m .. y1 + m - 1 and columns
    x0 - m .. x1 + m - 1."""
    ys = np.arange(y0 - m, y1 + m)
    xs = np.clip(np.arange(x0 - m, x1 + m), 0, end_x)
    yc = np.clip(ys, 0, end_y)
    rows = []
    for y in yc:
        if y < start:
            rows.append(pre[max(start - 2, y), xs])
        elif y > stop:
            rows.append(pre[min(stop + 2, y), xs])
        else:
            rows.append(cdef[y, xs])
    return np.stack(rows)


def _wiener(src, coef, h, w, bd):
    """src has a margin of 4 on each side."""
    def taps(c):
        f = [c[0], c[1], c[2], 128, c[2], c[1], c[0]]
        f[3] -= 2 * (c[0] + c[1] + c[2])
        return f
    vf, hf = taps(coef[0]), taps(coef[1])
    r0 = 5 if bd == 12 else 3
    r1 = 9 if bd == 12 else 11
    m = 4
    inter = np.zeros((h + 6, w), np.int64)
    rows = src[m - 3:m + h + 3]
    for t in range(7):
        inter += hf[t] * rows[:, m + t - 3:m + t - 3 + w]
    inter = (inter + (1 << (r0 - 1))) >> r0
    lo = -(1 << (bd + 6 - r0))
    hi = (1 << (bd + 8 - r0)) - 1 - (1 << (bd + 6 - r0))
    inter = np.clip(inter, lo, hi)
    acc = np.zeros((h, w), np.int64)
    for t in range(7):
        acc += vf[t] * inter[t:t + h]
    return np.clip((acc + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1)


def _box_sum(a, r):
    """Sums over (2r + 1)^2 windows, valid region."""
    c = np.cumsum(np.cumsum(a, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0)))
    k = 2 * r + 1
    return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]


def _sgr(src, cdef_blk, s, xqd, h, w, bd):
    params = D.Sgr_Params[s]
    m = 4
    u = cdef_blk.astype(np.int64) << 4
    w0, w1 = xqd
    w2 = (1 << 7) - w0 - w1
    v = w1 * u
    flts = []
    for pss in range(2):
        r = int(params[pss * 2])
        if not r:
            flts.append(None)
            continue
        sc = int(params[pss * 2 + 1])
        n = (2 * r + 1) ** 2
        # A, B on rows -1 .. h and columns -1 .. w
        win = src[m - 1 - r:m + h + 1 + r, m - 1 - r:m + w + 1 + r]
        a = _box_sum(win * win, r)
        b = _box_sum(win, r)
        if bd > 8:
            a = (a + (1 << (2 * (bd - 8) - 1))) >> (2 * (bd - 8))
            d = (b + (1 << (bd - 9))) >> (bd - 8)
        else:
            d = b
        pp = np.maximum(0, a * n - d * d)
        z = (pp * sc + (1 << 19)) >> 20
        a2 = np.where(z >= 255, 256, np.where(
            z == 0, 1, ((z << 8) + (z >> 1)) // np.maximum(z + 1, 1)))
        one_over_n = ((1 << 12) + (n >> 1)) // n
        b2 = ((1 << 8) - a2) * b * one_over_n
        A = a2
        B = (b2 + (1 << 11)) >> 12
        ii = np.arange(h)[:, None]
        fa = np.zeros((h, w), np.int64)
        fb = np.zeros((h, w), np.int64)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if pss == 0:
                    wt = np.where(((ii + dy) & 1) == 1, 6 if dx == 0 else 5,
                                  0)
                else:
                    wt = 4 if (dx == 0 or dy == 0) else 3
                fa = fa + wt * A[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                fb = fb + wt * B[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        shift = np.where((pss == 0) & ((ii & 1) == 1), 4, 5)
        vv = fa * cdef_blk.astype(np.int64) + fb
        sh = 8 + shift - 4
        flts.append((vv + (1 << (sh - 1))) >> sh)
    v = v + (w0 * flts[0] if flts[0] is not None else w0 * u)
    v = v + (w2 * flts[1] if flts[1] is not None else w2 * u)
    res = (v + (1 << 10)) >> 11
    return np.clip(res, 0, (1 << bd) - 1)
