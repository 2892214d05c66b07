"""JPEG 2000 decoding (ITU-T T.800: a JP2 file or a raw codestream), as
PIL 12.1 decodes it through OpenJPEG 2.5 (`Jpeg2KDecode.c`): every layer
at full resolution, tile by tile.

Each tile: tier 2 (`j2k_t2`), tier 1 per code-block (`j2k_t1`), the
dequantisation and inverse wavelet transform per component
(`j2k_dwt`), then OpenJPEG's `opj_tcd_mct_decode` (the inverse RCT in
integers, or the ICT in float32, when the tile's MCT is on and the first
three components have one size) and `opj_tcd_dc_level_shift_decode`
(irreversible samples rounded half to even, as `lrintf`; the DC level
shift; the clamp to each component's precision).  OpenJPEG hands the
tile over as 1, 2 or 4 bytes a sample, component after component, and
PIL's unpackers (`j2ku_*`) take it into the mode `jp2.py` chose: a
precision other than 8 (16 for "I;16") moved by a shift with rounding,
kept to the mode's width; a signed component offset by half its range;
subsampled components read with PIL's own (integer-divided) strides; an
sYCC image through PIL's YCbCr -> RGB.  The unpacker is picked as PIL
picks it, by the colour space (a raw codestream's, or an unknown one,
guessed from its component count and which component is subsampled),
the component count and the mode; where PIL has none the file raises
OSError, as PIL does.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import j2k_dwt, j2k_t1, j2k_t2, jp2
from .imagemode import ModeImage, ycbcr_to_rgb
from .j2k_codestream import Codestream, TileComponent, parse, tile_bounds, \
    tile_layout

_GRAY_L, _GRAY_I, _GRAYA_LA, _GRAY_RGB, _SRGB, _SYCC, _SRGBA, _SYCCA = \
    range(8)
# PIL's j2k_unpackers (but "I;16B", a mode PIL's header parse never
# gives): (mode, colour space, components, takes subsampled components,
# unpacker)
_UNPACKERS = (
    ("L", jp2.GRAY, 1, False, _GRAY_L),
    ("P", jp2.SRGB, 1, False, _GRAY_L),
    ("PA", jp2.SRGB, 2, False, _GRAYA_LA),
    ("I;16", jp2.GRAY, 1, False, _GRAY_I),
    ("LA", jp2.GRAY, 2, False, _GRAYA_LA),
    ("RGB", jp2.GRAY, 1, False, _GRAY_RGB),
    ("RGB", jp2.GRAY, 2, False, _GRAY_RGB),
    ("RGB", jp2.SRGB, 3, True, _SRGB),
    ("RGB", jp2.SYCC, 3, True, _SYCC),
    ("RGB", jp2.SRGB, 4, True, _SRGB),
    ("RGB", jp2.SYCC, 4, True, _SYCC),
    ("RGBA", jp2.GRAY, 1, False, _GRAY_RGB),
    ("RGBA", jp2.GRAY, 2, False, _GRAYA_LA),
    ("RGBA", jp2.SRGB, 3, True, _SRGB),
    ("RGBA", jp2.SYCC, 3, True, _SYCC),
    ("RGBA", jp2.SRGB, 4, True, _SRGBA),
    ("RGBA", jp2.SYCC, 4, True, _SYCCA),
    ("CMYK", jp2.CMYK, 4, True, _SRGBA),
)
_INT_MAX, _INT_MIN = 2 ** 31 - 1, -2 ** 31


def _component_samples(cs: Codestream, t: int, c: int,
                       tc: TileComponent) -> np.ndarray:
    """One tile-component after tier 1, dequantisation and the inverse
    wavelet transform: int64 (5/3) or float32 (9/7)."""
    params = cs.tiles[t].params
    cod = params.cod[c]
    prec = cs.comps[c].prec
    roi = params.roi[c]
    image: Optional[np.ndarray] = None
    for r, res in enumerate(tc.resolutions):
        bands = []
        for band in res.bands:
            h, w = band.y1 - band.y0, band.x1 - band.x0
            vals = np.zeros((max(h, 0), max(w, 0)), np.int64)
            if not band.empty:
                for prc in band.precincts:
                    for cb in prc.blocks:
                        segs = [(s[1], s[2]) for s in cb.segs if s[1]]
                        if not segs:
                            continue
                        bw, bh = cb.x1 - cb.x0, cb.y1 - cb.y0
                        out = j2k_t1.decode_block(
                            cb.data, segs, bw, bh, band.index, cb.numbps,
                            roi, cod.style)
                        vals[cb.y0 - band.y0:cb.y1 - band.y0,
                             cb.x0 - band.x0:cb.x1 - band.x0] = \
                            np.asarray(out, np.int64).reshape(bh, bw)
            half = None if cod.reversible else j2k_dwt.step_size(
                *band.step, prec)
            bands.append(j2k_dwt.dequantize(vals, cod.reversible, half))
        if r == 0:
            image = bands[0]
        else:
            image = j2k_dwt.inverse(image, *bands, res.x0, res.y0,
                                    cod.reversible)
    return image


def _tile_samples(cs: Codestream, t: int) -> List[np.ndarray]:
    params = cs.tiles[t].params
    layout = tile_layout(cs, t, params)
    j2k_t2.read_packets(cs, t, layout)
    comps = [_component_samples(cs, t, c, tc)
             for c, tc in enumerate(layout)]
    if params.mct and len(comps) >= 3 and \
            comps[0].shape == comps[1].shape == comps[2].shape:
        if params.cod[0].reversible:
            y, u, v = (comps[k].astype(np.int64) for k in range(3))
            g = y - ((u + v) >> 2)
            comps[:3] = [v + g, g, u + g]
        else:
            y, u, v = (comps[k].astype(np.float32) for k in range(3))
            f = np.float32
            comps[:3] = [y + v * f(1.402),
                         (y - u * f(0.34413)) - v * f(0.71414),
                         y + u * f(1.772)]
    out = []
    for c, v in enumerate(comps):
        comp = cs.comps[c]
        lo = -(1 << (comp.prec - 1)) if comp.sgnd else 0
        hi = (1 << (comp.prec - 1)) - 1 if comp.sgnd else \
            (1 << comp.prec) - 1
        shift = 0 if comp.sgnd else 1 << (comp.prec - 1)
        if v.dtype == np.float32:
            r = np.rint(np.clip(v, -2.0 ** 40, 2.0 ** 40)).astype(np.int64)
            r = np.clip(r + shift, lo, hi)
            r = np.where(v > np.float32(_INT_MAX), hi, r)
            v = np.where(v < np.float32(_INT_MIN), lo, r)
        else:
            v = np.clip(v + shift, lo, hi)
        out.append(v.astype(np.int64))
    return out


def _csiz(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _words(comps, cs: Codestream, w: int, h: int, strided: bool):
    """PIL's reading of OpenJPEG's tile buffer: each component's words at
    the tile's w x h positions (PIL's strides w / dx, h / dy)."""
    buf = b"".join(
        (v & ((1 << (8 * _csiz(cs.comps[c].prec))) - 1)).astype(
            {1: "<u1", 2: "<u2", 4: "<u4"}[_csiz(cs.comps[c].prec)]
        ).tobytes() for c, v in enumerate(comps))
    raw = np.frombuffer(buf, np.uint8).astype(np.int64)
    start = 0
    words = []
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    for c, comp in enumerate(cs.comps):
        size = _csiz(comp.prec)
        dx, dy = (comp.dx, comp.dy) if strided else (1, 1)
        idx = start + size * ((ys // dy) * (w // dx) + xs // dx)
        if idx.size and int(idx.max()) + size > raw.size:
            raise NotImplementedError(
                "JPEG 2000: subsampled components PIL 12.1 reads past its "
                "tile buffer")
        word = np.zeros((h, w), np.int64)
        for k in range(size):
            word |= raw[idx + k] << (8 * k)
        words.append(word)
        start += size * (w // dx) * (h // dy)
    return words


def _unpack_one(word: np.ndarray, prec: int, sgnd: bool, bits: int
                ) -> np.ndarray:
    """j2ku_shift(offset + word, shift), kept to the mode's `bits`."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (word + offset) & 0xFFFFFFFF
    v = (v << shift) & 0xFFFFFFFF if shift >= 0 else v >> -shift
    return v & ((1 << bits) - 1)


def decode_jpeg2000(data: bytes) -> ModeImage:
    """JPEG 2000 bytes -> the image in PIL's mode (module docstring)."""
    if data[:4] == jp2.CODESTREAM:
        size, mode = jp2.codestream_mode(data)
        stream, space, palette = data, jp2.UNSPECIFIED, None
    elif data[:12] == jp2.SIGNATURE:
        head = jp2.read_header(data)
        size, mode, stream = head.size, head.mode, head.codestream
        space, palette = head.color_space, head.palette
    else:
        raise SyntaxError("not a JPEG 2000 file")
    cs = parse(stream)
    n = len(cs.comps)
    sub = next((c for c, k in enumerate(cs.comps) if k.dx != 1 or k.dy != 1),
               -1)
    if space in (jp2.UNSPECIFIED, jp2.UNKNOWN):
        if n in (1, 2):
            space = jp2.GRAY
        elif n in (3, 4):
            space = {-1: jp2.SRGB, 0: jp2.SRGB, 1: jp2.SYCC,
                     2: jp2.SYCC}.get(sub, space)
    unpack = next((u for m, s, k, subs, u in _UNPACKERS
                   if s == space and k == n and (subs or sub == -1)
                   and m == mode), None)
    if unpack is None or n > 4:
        raise OSError("broken data stream when reading image file (PIL "
                      f"12.1 has no unpacker for {n} components in "
                      f"colour space {space} as {mode})")
    width, height = size
    wide = mode == "I;16"
    chans = {"L": 1, "P": 1, "I;16": 1}.get(mode, 4)
    img = np.zeros((height, width, chans),
                   np.uint16 if wide else np.uint8)
    if unpack in (_SRGB, _SYCC):
        img[..., 3] = 255
    for t in sorted(cs.tiles):
        tx0, ty0, tx1, ty1 = tile_bounds(cs, t)
        x0, y0 = tx0 - cs.xosiz, ty0 - cs.yosiz
        w, h = tx1 - tx0, ty1 - ty0
        if w <= 0 or h <= 0 or x0 + w > width or y0 + h > height:
            raise OSError("broken data stream when reading image file "
                          "(a tile outside PIL's image)")
        comps = _tile_samples(cs, t)
        words = _words(comps, cs, w, h, unpack not in (
            _GRAY_L, _GRAY_I, _GRAYA_LA, _GRAY_RGB))
        k = cs.comps
        px = [_unpack_one(words[c], k[c].prec, k[c].sgnd,
                          16 if wide else 8) for c in range(n)]
        region = img[y0:y0 + h, x0:x0 + w]
        if unpack in (_GRAY_L, _GRAY_I):
            region[..., 0] = px[0]
        elif unpack == _GRAY_RGB:
            region[..., :3] = px[0][..., None]
            region[..., 3] = 255
        elif unpack == _GRAYA_LA:
            region[..., :3] = px[0][..., None]
            region[..., 3] = px[1]
        else:
            m = 3 if unpack in (_SRGB, _SYCC) else 4
            region[..., :m] = np.stack(px[:m], -1)
            if unpack in (_SYCC, _SYCCA):
                region[..., :3] = ycbcr_to_rgb(
                    region[..., :3].astype(np.uint8))
    if chans == 1:
        return ModeImage(mode, img[..., 0], palette)
    if mode in ("LA", "PA"):
        return ModeImage(mode, np.ascontiguousarray(img[..., [0, 3]]),
                         palette)
    if mode == "RGB":
        return ModeImage(mode, np.ascontiguousarray(img[..., :3]))
    return ModeImage(mode, img)
