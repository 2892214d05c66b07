"""AV1 film-grain synthesis (specification section 7.18.3): the grain
templates from the Gaussian sequence with their auto-regressive filters,
the scaling lookups, the 32x32 noise stripes with their random offsets
and overlaps, and the blending into the output planes.  libavif 1.3 has
dav1d apply the grain (dav1d's default), so PIL's pixels carry it.
"""
from __future__ import annotations

import numpy as np

from . import av1_data as D


class _Rng:
    def __init__(self, seed):
        self.r = seed & 0xFFFF

    def get(self, bits):
        r = self.r
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.r = r
        return (r >> (16 - bits)) & ((1 << bits) - 1)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def _templates(g, seq):
    bd = seq.BitDepth
    ssx, ssy = seq.subsampling_x, seq.subsampling_y
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    gauss = D.Gaussian_Sequence
    shift = 12 - bd + g.grain_scale_shift
    rng = _Rng(g.grain_seed)
    luma = [[0] * 82 for _ in range(73)]
    ny = len(g.point_y_value)
    for y in range(73):
        for x in range(82):
            v = int(gauss[rng.get(11)]) if ny else 0
            luma[y][x] = _round2(v, shift)
    lag = g.ar_coeff_lag
    ar_shift = g.ar_coeff_shift_minus_6 + 6
    if ny:
        cy = [c - 128 for c in g.ar_coeffs_y_plus_128]
        for y in range(3, 73):
            for x in range(3, 82 - 3):
                s = 0
                pos = 0
                for dr in range(-lag, 1):
                    for dc in range(-lag, lag + 1):
                        if dr == 0 and dc == 0:
                            break
                        s += luma[y + dr][x + dc] * cy[pos]
                        pos += 1
                luma[y][x] = max(gmin, min(gmax, luma[y][x] +
                                           _round2(s, ar_shift)))
    cw = 44 if ssx else 82
    ch = 38 if ssy else 73
    chroma = []
    for seed_x, pts, coefs in ((0xB524, g.point_cb_value,
                                g.ar_coeffs_cb_plus_128),
                               (0x49D8, g.point_cr_value,
                                g.ar_coeffs_cr_plus_128)):
        rng = _Rng(g.grain_seed ^ seed_x)
        on = bool(pts) or g.chroma_scaling_from_luma
        c = [[0] * cw for _ in range(ch)]
        for y in range(ch):
            for x in range(cw):
                v = int(gauss[rng.get(11)]) if on else 0
                c[y][x] = _round2(v, shift)
        chroma.append((c, on, [k - 128 for k in coefs]))
    if seq.NumPlanes > 1:
        (cb, cb_on, c0s), (cr, cr_on, c1s) = chroma
        for y in range(3, ch):
            for x in range(3, cw - 3):
                s0 = s1 = 0
                pos = 0
                for dr in range(-lag, 1):
                    for dc in range(-lag, lag + 1):
                        c0 = c0s[pos] if pos < len(c0s) else 0
                        c1 = c1s[pos] if pos < len(c1s) else 0
                        if dr == 0 and dc == 0:
                            if ny:
                                lm = 0
                                lx = ((x - 3) << ssx) + 3
                                ly = ((y - 3) << ssy) + 3
                                for i in range(ssy + 1):
                                    for j in range(ssx + 1):
                                        lm += luma[ly + i][lx + j]
                                lm = _round2(lm, ssx + ssy)
                                s0 += lm * c0
                                s1 += lm * c1
                            break
                        s0 += c0 * cb[y + dr][x + dc]
                        s1 += c1 * cr[y + dr][x + dc]
                        pos += 1
                if cb_on:
                    cb[y][x] = max(gmin, min(gmax, cb[y][x] +
                                             _round2(s0, ar_shift)))
                if cr_on:
                    cr[y][x] = max(gmin, min(gmax, cr[y][x] +
                                             _round2(s1, ar_shift)))
        return [np.array(luma), np.array(cb), np.array(cr)]
    return [np.array(luma)]


def _scaling_lut(values, scalings):
    lut = np.zeros(256, np.int64)
    n = len(values)
    if n == 0:
        return lut
    lut[:values[0]] = scalings[0]
    for p in range(n - 1):
        dy = scalings[p + 1] - scalings[p]
        dx = values[p + 1] - values[p]
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for x in range(dx):
            lut[values[p] + x] = scalings[p] + ((x * delta + 32768) >> 16)
    lut[values[n - 1]:] = scalings[n - 1]
    return lut


def _scale(lut, idx, bd):
    if bd == 8:
        return lut[idx]
    shift = bd - 8
    x = idx >> shift
    rem = idx - (x << shift)
    start = lut[x]
    end = lut[np.minimum(x + 1, 255)]
    v = start + _round2((end - start) * rem, shift)
    return np.where(x == 255, start, v)


def apply_film_grain(planes, seq, hdr):
    g = hdr.film_grain
    bd = seq.BitDepth
    ssx, ssy = seq.subsampling_x, seq.subsampling_y
    w, h = hdr.UpscaledWidth, hdr.FrameHeight
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    grains = _templates(g, seq)
    nplanes = len(planes)
    # noise stripes
    stripes = []
    luma_num = 0
    for y in range(0, (h + 1) // 2, 16):
        rng = _Rng(g.grain_seed ^ (((luma_num * 37 + 178) & 255) << 8) ^
                   ((luma_num * 173 + 105) & 255))
        st = []
        for p in range(nplanes):
            sx = ssx if p else 0
            sy = ssy if p else 0
            st.append(np.zeros((34 >> sy, ((w + 1) // 2 + 16) * 2 + 34),
                               np.int64))
        for x in range(0, (w + 1) // 2, 16):
            rand = rng.get(8)
            ox, oy = rand >> 4, rand & 15
            for p in range(nplanes):
                sx = ssx if p else 0
                sy = ssy if p else 0
                pox = 6 + ox if sx else 9 + ox * 2
                poy = 6 + oy if sy else 9 + oy * 2
                tmpl = grains[p]
                blk = tmpl[poy:poy + (34 >> sy), pox:pox + (34 >> sx)].copy()
                base = x * 2 if not sx else x
                if g.overlap_flag and x > 0:
                    if not sx:
                        old = st[p][:, base:base + 2]
                        blk[:, 0] = np.clip(_round2(old[:, 0] * 27 +
                                                    blk[:, 0] * 17, 5),
                                            gmin, gmax)
                        blk[:, 1] = np.clip(_round2(old[:, 1] * 17 +
                                                    blk[:, 1] * 27, 5),
                                            gmin, gmax)
                    else:
                        old = st[p][:, base]
                        blk[:, 0] = np.clip(_round2(old * 23 + blk[:, 0] * 22,
                                                    5), gmin, gmax)
                st[p][:, base:base + blk.shape[1]] = blk
        stripes.append(st)
        luma_num += 1
    # noise images
    noise = []
    for p in range(nplanes):
        sx = ssx if p else 0
        sy = ssy if p else 0
        ph, pw = (h + sy) >> sy, (w + sx) >> sx
        img = np.zeros((ph, pw), np.int64)
        for y in range(ph):
            ln = y >> (5 - sy)
            i = y - (ln << (5 - sy))
            row = stripes[ln][p][i, :pw].copy()
            if g.overlap_flag and ln > 0:
                if not sy and i < 2:
                    old = stripes[ln - 1][p][i + 32, :pw]
                    row = old * 27 + row * 17 if i == 0 else \
                        old * 17 + row * 27
                    row = np.clip(_round2(row, 5), gmin, gmax)
                elif sy and i < 1:
                    old = stripes[ln - 1][p][i + 16, :pw]
                    row = np.clip(_round2(old * 23 + row * 22, 5), gmin,
                                  gmax)
            img[y] = row
        noise.append(img)
    # blending
    if g.clip_to_restricted_range:
        mn = 16 << (bd - 8)
        max_luma = 235 << (bd - 8)
        max_chroma = max_luma if seq.matrix_coefficients == 0 else \
            240 << (bd - 8)
    else:
        mn = 0
        max_luma = max_chroma = (256 << (bd - 8)) - 1
    sshift = g.grain_scaling_minus_8 + 8
    y_plane = planes[0].astype(np.int64)
    out = [p.astype(np.int64) for p in planes]
    if nplanes > 1:
        ph, pw = out[1].shape
        yy = (np.arange(ph) << ssy)[:, None]
        xx = (np.arange(pw) << ssx)[None, :]
        xn = np.minimum(xx + 1, w - 1)
        if ssx:
            avg = _round2(y_plane[yy, xx] + y_plane[yy, xn], 1)
        else:
            avg = y_plane[yy, xx]
        for p, pts, scl, mult, lmult, off in (
                (1, g.point_cb_value, g.point_cb_scaling, g.cb_mult,
                 g.cb_luma_mult, g.cb_offset),
                (2, g.point_cr_value, g.point_cr_scaling, g.cr_mult,
                 g.cr_luma_mult, g.cr_offset)):
            if not (pts or g.chroma_scaling_from_luma):
                continue
            if g.chroma_scaling_from_luma:
                lut = _scaling_lut(g.point_y_value, g.point_y_scaling)
                merged = avg
            else:
                lut = _scaling_lut(pts, scl)
                comb = avg * (lmult - 128) + out[p] * (mult - 128)
                merged = np.clip((comb >> 6) + ((off - 256) << (bd - 8)), 0,
                                 (1 << bd) - 1)
            n = _round2(_scale(lut, merged, bd) * noise[p], sshift)
            out[p] = np.clip(out[p] + n, mn, max_chroma)
    if g.point_y_value:
        lut = _scaling_lut(g.point_y_value, g.point_y_scaling)
        n = _round2(_scale(lut, y_plane, bd) * noise[0], sshift)
        out[0] = np.clip(y_plane + n, mn, max_luma)
    return [o.astype(np.uint16) for o in out]
