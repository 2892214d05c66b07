"""YUV to 8-bit RGB / RGBA as PIL 12.1 asks libavif 1.3.0 for it
(`avifImageYUVToRGB` into an 8-bit RGB or RGBA `avifRGBImage`, automatic
chroma upsampling, alpha not premultiplied).

8-bit images in the matrices libyuv has take libyuv 1909's route: its
fixed-point YuvConstants (kYuvI601, kYuvJPEG, kYuvH709, kYuvF709,
kYuv2020, kYuvV2020), the I444 row conversion, and for 4:2:0 / 4:2:2 its
bilinear / linear chroma upsampling (the `...MatrixFilter` functions).
The rest follows libavif's own float path.  Alpha coded in limited range
is expanded to full; a premultiplied image is unpremultiplied.
"""
from __future__ import annotations

import numpy as np

MC_IDENTITY, MC_BT709, MC_UNSPECIFIED, MC_BT470BG, MC_BT601 = 0, 1, 2, 5, 6
MC_BT2020_NCL, MC_CHROMA_DERIVED_NCL, MC_YCGCO = 9, 12, 8

# name -> (YG, YB, UB, UG, VG, VR), libyuv row_common.cc
_LIBYUV = {
    "I601": (18997, -1160, 128, 25, 52, 102),
    "JPEG": (16320, 32, 113, 22, 46, 90),
    "H709": (18997, -1160, 128, 14, 34, 115),
    "F709": (16320, 32, 119, 12, 30, 101),
    "2020": (19003, -1160, 128, 12, 42, 107),
    "V2020": (16320, 32, 120, 11, 37, 94),
}


def _libyuv_constants(mc, cp, full):
    if full:
        table = {MC_BT709: "F709", MC_BT470BG: "JPEG", MC_BT601: "JPEG",
                 MC_UNSPECIFIED: "JPEG", MC_BT2020_NCL: "V2020"}
        derived = {1: "F709", 2: "F709", 5: "JPEG", 6: "JPEG", 9: "V2020"}
    else:
        table = {MC_BT709: "H709", MC_BT470BG: "I601", MC_BT601: "I601",
                 MC_UNSPECIFIED: "I601", MC_BT2020_NCL: "2020"}
        derived = {1: "H709", 2: "H709", 5: "I601", 6: "I601", 9: "2020"}
    if mc == MC_CHROMA_DERIVED_NCL:
        return derived.get(cp)
    return table.get(mc)


def _up_linear(c, width):
    """libyuv ScaleRowUp2_Linear_Any on each row: [h, (w+1)/2] -> [h, w]."""
    h, cw = c.shape
    c = c.astype(np.int64)
    out = np.empty((h, width), np.int64)
    out[:, 0] = c[:, 0]
    work = (width - 1) & ~1
    n = work // 2
    if n:
        a, b = c[:, :n], c[:, 1:n + 1]
        out[:, 1:work + 1:2] = (3 * a + b + 2) >> 2
        out[:, 2:work + 2:2] = (a + 3 * b + 2) >> 2
    out[:, width - 1] = c[:, (width - 1) // 2]
    return out


def _up_bilinear_pair(s, t, width):
    """libyuv ScaleRowUp2_Bilinear_Any: rows s, t -> two output rows."""
    s = s.astype(np.int64)
    t = t.astype(np.int64)
    da = np.empty((s.shape[0], width), np.int64)
    db = np.empty_like(da)
    da[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2
    db[:, 0] = (s[:, 0] + 3 * t[:, 0] + 2) >> 2
    work = (width - 1) & ~1
    n = work // 2
    if n:
        s0, s1 = s[:, :n], s[:, 1:n + 1]
        t0, t1 = t[:, :n], t[:, 1:n + 1]
        da[:, 1:work + 1:2] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
        da[:, 2:work + 2:2] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
        db[:, 1:work + 1:2] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4
        db[:, 2:work + 2:2] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4
    k = (width - 1) // 2
    da[:, width - 1] = (3 * s[:, k] + t[:, k] + 2) >> 2
    db[:, width - 1] = (s[:, k] + 3 * t[:, k] + 2) >> 2
    return da, db


def _upsample_420(c, width, height):
    """I420To*MatrixFilter's chroma rows at full resolution."""
    out = np.empty((height, width), np.int64)
    out[0] = _up_linear(c[:1], width)[0]
    y = 0
    k = 0
    while y < height - 2:
        da, db = _up_bilinear_pair(c[k:k + 1], c[k + 1:k + 2], width)
        out[y + 1] = da[0]
        out[y + 2] = db[0]
        y += 2
        k += 1
    if not height & 1:
        out[height - 1] = _up_linear(c[k:k + 1], width)[0]
    return out


def _to_8(p, depth):
    """libyuv's Convert16To8Plane: x * 2^(24 - depth) >> 16."""
    return np.minimum(p.astype(np.int64) >> (depth - 8), 255)


def _chroma_444(planes, seq, w, h, nearest=False):
    """U and V at full resolution as libyuv's Matrix / MatrixFilter
    functions see them (bilinear rows for 4:2:0, linear for 4:2:2)."""
    if not (seq.subsampling_x or seq.subsampling_y):
        return planes[1], planes[2]
    if nearest:
        return tuple(np.repeat(np.repeat(c, 1 + seq.subsampling_y, 0),
                               1 + seq.subsampling_x, 1)[:h, :w]
                     for c in planes[1:])
    if seq.subsampling_y:
        return (_upsample_420(planes[1], w, h),
                _upsample_420(planes[2], w, h))
    return _up_linear(planes[1], w), _up_linear(planes[2], w)


def libyuv_route(planes, seq, mc, cp, full, rgba=False):
    """RGB uint8 [h, w, 3] the way libavif hands the image to libyuv, or
    None where it does not.  8-bit: the 8-bit functions.  10 and 12 bits
    into 3-channel RGB: each plane cut to 8 bits first (Convert16To8Plane).
    Into RGBA: 10 bits through the 10-bit functions (chroma upsampled at
    10 bits, then YuvPixel10); 12-bit 4:2:0 through I012ToARGBMatrix
    (nearest chroma, YuvPixel12); 12-bit 4:2:2 / 4:4:4 cut to 8 bits."""
    name = _libyuv_constants(mc, cp, full)
    if name is None or len(planes) == 1:
        return None
    depth = seq.BitDepth
    h, w = planes[0].shape
    if depth > 8 and rgba and (depth == 10 or seq.subsampling_y):
        u, v = _chroma_444(planes, seq, w, h, nearest=depth == 12)
        y = planes[0].astype(np.int64)
        y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
        return _yuv_pixel32(y32, _to_8(u, depth), _to_8(v, depth), name)
    if depth > 8:
        planes = [_to_8(p, depth) for p in planes]
    u, v = _chroma_444(planes, seq, w, h)
    return _yuv_pixel32(planes[0].astype(np.int64) * 0x0101, u, v, name)


def _yuv_pixel32(y32, u, v, name):
    """libyuv's YuvPixel on Y widened to 16 bits (y32) and 8-bit U, V."""
    yg, yb, ub, ug, vg, vr = _LIBYUV[name]
    y1 = (y32 * yg) >> 16
    u = u.astype(np.int64) - 128
    v = v.astype(np.int64) - 128
    out = [(y1 + v * vr + yb) >> 6, (y1 - u * ug - v * vg + yb) >> 6,
           (y1 + u * ub + yb) >> 6]
    return np.stack([np.clip(c, 0, 255) for c in out], -1).astype(np.uint8)


# libavif's matrixCoefficientsTables: (kr, kb) as C floats
_KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
          6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}
_F32 = np.float32


def _coefficients(mc, cp):
    kr, kb = _KR_KB.get(mc, (0.299, 0.114))
    if mc == MC_CHROMA_DERIVED_NCL:
        kr, kb = _derived_kr_kb(cp)
    kr, kb = _F32(kr), _F32(kb)
    return kr, _F32(_F32(1.0) - kr - kb), kb


# avifColorPrimariesTables: rX, rY, gX, gY, bX, bY, wX, wY
_PRIMARIES = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    2: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}


def _derived_kr_kb(cp):
    """avifCalcYUVCoefficients for chroma-derived matrices, in C floats."""
    rx, ry, gx, gy, bx, by, wx, wy = (_F32(v) for v in
                                      _PRIMARIES.get(cp, _PRIMARIES[1]))
    rz = _F32(1.0) - (rx + ry)
    gz = _F32(1.0) - (gx + gy)
    bz = _F32(1.0) - (bx + by)
    wz = _F32(1.0) - (wx + wy)
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz) +
                wz * (gx * by - bx * gy))) / \
        (wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) +
               bx * (ry * gz - gy * rz)))
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz) +
                wz * (rx * gy - gx * ry))) / \
        (wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) +
               bx * (ry * gz - gy * rz)))
    return float(kr), float(kb)


def _unorm_tables(depth, full):
    cp = np.arange(1 << depth, dtype=np.float32)
    mx = _F32((1 << depth) - 1)
    bias_y = _F32(0.0) if full else _F32(16 << (depth - 8))
    range_y = mx if full else _F32(219 << (depth - 8))
    bias_uv = _F32(1 << (depth - 1))
    range_uv = mx if full else _F32(224 << (depth - 8))
    return (cp - bias_y) / range_y, (cp - bias_uv) / range_uv


def _bilinear_uv(table, c, w, h, ssx, ssy):
    """avifImageYUVAnyToRGBAnySlow's chroma: the closest sample 9/16, the
    adjacent column and row 3/16 each, the diagonal 1/16 (duplicated at
    the edges; rows not filtered in 4:2:2)."""
    i = np.arange(w)
    j = np.arange(h)
    ui = i >> ssx
    uj = j >> ssy
    adj_c = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), 0,
                     np.where(i % 2 != 0, 1, -1))
    if ssy:
        adj_r = np.where((j == 0) | ((j == h - 1) & (j % 2 != 0)), 0,
                         np.where(j % 2 != 0, 1, -1))
    else:
        adj_r = np.zeros(h, np.int64)
    f = table[c]
    c00 = f[uj[:, None], ui[None, :]]
    c10 = f[uj[:, None], (ui + adj_c)[None, :]]
    c01 = f[(uj + adj_r)[:, None], ui[None, :]]
    c11 = f[(uj + adj_r)[:, None], (ui + adj_c)[None, :]]
    return (c00 * _F32(9.0 / 16.0)) + (c10 * _F32(3.0 / 16.0)) + \
        (c01 * _F32(3.0 / 16.0)) + (c11 * _F32(1.0 / 16.0))


def _slow_path(planes, seq, mc, full):
    """Whether libavif takes avifImageYUVAnyToRGBAnySlow (which also
    unmultiplies alpha itself, in floats) rather than a fast path."""
    if len(planes) == 1:
        return False
    if mc == MC_IDENTITY:
        return not (seq.BitDepth == 8 and full)
    if mc == MC_YCGCO:
        return True
    return bool(seq.subsampling_x or seq.subsampling_y)


def float_route(planes, seq, mc, cp, full, unmultiply_by=None):
    """libavif's own conversion (its fast paths and
    avifImageYUVAnyToRGBAnySlow agree where both apply): C floats.
    `unmultiply_by`: the full-range alpha plane the slow path divides
    by."""
    depth = seq.BitDepth
    mx = (1 << depth) - 1
    ty, tuv = _unorm_tables(depth, full)
    y = np.minimum(planes[0], mx)
    h, w = y.shape
    Y = ty[y]
    if len(planes) == 1:
        R = G = B = Y
    else:
        u = np.minimum(planes[1], mx)
        v = np.minimum(planes[2], mx)
        if seq.subsampling_x or seq.subsampling_y:
            Cb = _bilinear_uv(tuv, u, w, h, seq.subsampling_x,
                              seq.subsampling_y)
            Cr = _bilinear_uv(tuv, v, w, h, seq.subsampling_x,
                              seq.subsampling_y)
        else:
            Cb, Cr = tuv[u], tuv[v]
        if mc == MC_IDENTITY:
            # U and V are samples of B and R, biased and ranged as Y
            G, B, R = Y, ty[u], ty[v]
        elif mc == MC_YCGCO:
            t = Y - Cb
            G = Y + Cb
            B = t - Cr
            R = t + Cr
        else:
            kr, kg, kb = _coefficients(mc, cp)
            one = _F32(1.0)
            R = Y + (_F32(2) * (one - kr)) * Cr
            B = Y + (_F32(2) * (one - kb)) * Cb
            G = Y - ((_F32(2) * ((kr * (one - kr) * Cr) +
                                  (kb * (one - kb) * Cb))) / kg)
    chans = [np.clip(c, _F32(0.0), _F32(1.0)).astype(np.float32)
             for c in (R, G, B)]
    if unmultiply_by is not None:
        A = np.clip(unmultiply_by.astype(np.float32) / _F32(mx), _F32(0.0),
                    _F32(1.0))
        part = (A > 0) & (A < 1)
        safe = np.where(part, A, _F32(1.0))
        chans = [np.where(A == 0, _F32(0.0), np.where(
            part, np.minimum(c / safe, _F32(1.0)), c)) for c in chans]
    out = [(_F32(0.5) + c * _F32(255.0)).astype(np.uint8) for c in chans]
    return np.stack(out, axis=-1)


def to_rgb(planes, seq, nclx, alpha, premultiplied):
    """The image PIL gives: uint8 [h, w, 3], or [h, w, 4] with alpha."""
    if nclx is not None:
        cp, tc, mc, full = nclx
    else:
        cp, tc, mc = (seq.color_primaries, seq.transfer_characteristics,
                      seq.matrix_coefficients)
        full = seq.color_range
    if mc in (10, 11, 13, 14) or (mc == MC_YCGCO and not full) or (
            mc == MC_IDENTITY and len(planes) > 1 and
            (seq.subsampling_x or seq.subsampling_y)):
        raise RuntimeError(
            "AVIF: Conversion from YUV failed: Reformat failed (libavif 1.3 "
            "does not convert matrix_coefficients %d%s, as PIL reports)"
            % (mc, "" if full else " in limited range"))
    rgb = libyuv_route(planes, seq, mc, cp, full, alpha is not None)
    via_libyuv = rgb is not None
    slow = False
    if rgb is None:
        slow = premultiplied and alpha is not None and _slow_path(
            planes, seq, mc, full)
        rgb = float_route(planes, seq, mc, cp, full,
                          _alpha_full(*alpha) if slow else None)
    if alpha is None:
        return rgb
    # libyuv's alpha functions cut alpha as the colour (10 bits, and 12
    # bits cut to 8); elsewhere libavif reformats alpha itself
    depth = seq.BitDepth
    cut = via_libyuv and depth > 8 and (depth == 10 or
                                        not seq.subsampling_y)
    a = alpha_8bit(*alpha, cut=cut)
    if premultiplied and not slow:
        rgb = unattenuate(rgb, a)
    return np.concatenate([rgb, a[..., None]], axis=-1)


def _cdiv(a, b):
    """C's integer division (truncating toward zero), elementwise."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


def _alpha_full(plane, aseq):
    """The alpha plane in full range at its depth (avifLimitedToFullY)."""
    bd = aseq.BitDepth
    a = plane.astype(np.int64)
    mx = (1 << bd) - 1
    if not aseq.color_range:
        lo, hi = 16 << (bd - 8), 235 << (bd - 8)
        a = np.clip(_cdiv((a - lo) * mx + (hi - lo) // 2, hi - lo), 0, mx)
    return a


def alpha_8bit(plane, aseq, cut=False):
    """The alpha item's plane as PIL's 8-bit alpha: limited range expanded
    to full (libavif's avifLimitedToFullY), then the depth brought to 8
    bits (by a shift where libyuv takes it, else as libavif's
    avifReformatAlpha rounds)."""
    bd = aseq.BitDepth
    mx = (1 << bd) - 1
    a = _alpha_full(plane, aseq)
    if bd > 8 and cut:
        a = np.minimum(a >> (bd - 8), 255)
    elif bd > 8:
        a = (np.float32(0.5) + (a.astype(np.float32) / np.float32(mx)) *
             np.float32(255.0)).astype(np.int64)
    return a.astype(np.uint8)


# libyuv's fixed_invtbl8: 8.8 fixed-point 1 / a (1.0 exactly at 255)
_INV = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] +
                [0x100], np.int64)


def unattenuate(rgb, a):
    """libyuv ARGBUnattenuate as its x86 rows run it (each byte widened to
    c * 257, times the 8.8 reciprocal, high 16 bits, packed with signed
    saturation: past 32767 a word reads as negative), which libavif 1.3
    runs on 8-bit RGBA."""
    ia = _INV[a.astype(np.int64)][..., None]
    v = (rgb.astype(np.int64) * 257 * ia) >> 16
    return np.where(v > 32767, 0, np.minimum(v, 255)).astype(np.uint8)
