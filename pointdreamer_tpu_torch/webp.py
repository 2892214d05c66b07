"""WebP files: the RIFF container, the alpha chunk and the first frame of an
animation, read as PIL 12.1 reads them through libwebp's WebPAnimDecoder
(src/demux/anim_decode.c, src/dec/webp_dec.c, src/dec/alpha_dec.c,
src/dsp/filters.c):

- `RIFF....WEBP` with a `VP8 ` (lossy, `vp8.py`), `VP8L` (lossless,
  `vp8l.py`) or `VP8X` (extended) first chunk.  Under VP8X: `ALPH` before
  the image chunk, or `ANIM` and `ANMF` frames; `ICCP`, `EXIF`, `XMP ` and
  unknown chunks are skipped;
- the mode: RGBA when WebPGetFeatures says the file has alpha (the VP8X
  alpha flag; for a still VP8X + VP8L file the VP8L header's
  alpha_is_used bit instead; an ALPH chunk), else RGB;
- `ALPH`: raw (compression 0) or a headerless VP8L stream whose green
  channel is alpha (compression 1), then the horizontal, vertical or
  gradient unfilter; the pre-processing bits are ignored, as libwebp
  ignores them without alpha dithering (its default);
- an animation: the first frame, decoded into a canvas filled with
  (0, 0, 0, 0) at its ANMF offset (the first frame is a key frame: the
  canvas is cleared and nothing is blended).

`decode_webp(data)` returns uint8 [H, W, 4] (RGBA) or [H, W, 3] (RGB).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from .vp8 import decode_vp8
from .vp8l import decode_alpha_stream, decode_vp8l, read_header

ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02


def riff_chunks(data: bytes, start: int, end: int) -> List[Tuple[bytes,
                                                                  int, int]]:
    """(tag, payload start, payload end) of the chunks in data[start:end]
    (payloads padded to an even size)."""
    out = []
    pos = start
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size, = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if body + size > end:
            raise ValueError(f"WebP: chunk {tag!r} runs past the end")
        out.append((tag, body, body + size))
        pos = body + size + (size & 1)
    return out


def _unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """WebP's alpha unfilters (HorizontalUnfilter, VerticalUnfilter,
    GradientUnfilter) on a uint8 plane."""
    if method == 0:
        return a
    x = a.astype(np.int64)
    h, w = x.shape
    if method == 1:                      # horizontal
        col0 = np.cumsum(x[:, 0])
        out = col0[:, None] + np.concatenate(
            [np.zeros((h, 1), np.int64), np.cumsum(x[:, 1:], axis=1)], 1)
        return (out & 255).astype(np.uint8)
    row0 = np.cumsum(x[0])
    if method == 2:                      # vertical
        out = np.cumsum(np.concatenate([row0[None], x[1:]], 0), axis=0)
        return (out & 255).astype(np.uint8)
    out = np.zeros((h, w), np.int64)     # gradient: over anti-diagonals
    out[0] = row0 & 255
    out[:, 0] = np.cumsum(np.concatenate([row0[:1], x[1:, 0]])) & 255
    for d in range(2, h + w - 1):
        ys = np.arange(max(1, d - w + 1), min(h - 1, d - 1) + 1)
        if not len(ys):
            continue
        xs = d - ys
        pred = np.clip(out[ys, xs - 1] + out[ys - 1, xs]
                       - out[ys - 1, xs - 1], 0, 255)
        out[ys, xs] = (x[ys, xs] + pred) & 255
    return out.astype(np.uint8)


def decode_alpha(chunk: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's payload -> uint8 [height, width]."""
    if not chunk:
        raise ValueError("WebP: empty ALPH chunk")
    method, filt = chunk[0] & 3, (chunk[0] >> 2) & 3
    pre, rsrv = (chunk[0] >> 4) & 3, chunk[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError("WebP: invalid ALPH header")
    if method == 0:
        if len(chunk) - 1 < width * height:
            raise ValueError("WebP: truncated raw alpha")
        plane = np.frombuffer(chunk, np.uint8, width * height, 1).reshape(
            height, width)
    else:
        plane = decode_alpha_stream(chunk[1:], width, height)
    return _unfilter(plane, filt)


def decode_frame(data: bytes, chunks) -> np.ndarray:
    """An image's chunks ([ALPH,] VP8 / VP8L, anything else ignored) ->
    uint8 [h, w, 4] RGBA, as WebPDecode writes it into an RGBA buffer."""
    alph = None
    for tag, s, e in chunks:
        if tag == b"ALPH" and alph is None:
            alph = data[s:e]
        elif tag == b"VP8L":
            return decode_vp8l(data[s:e])
        elif tag == b"VP8 ":
            rgb = decode_vp8(data[s:e])
            h, w, _ = rgb.shape
            a = decode_alpha(alph, w, h) if alph is not None \
                else np.full((h, w), 255, np.uint8)
            return np.concatenate([rgb, a[..., None]], -1)
    raise ValueError("WebP: no VP8 or VP8L image chunk")


def parse(data: bytes) -> Dict:
    """The container's structure: canvas size, has_alpha (the mode PIL
    picks), animated, and the chunks of the image or of the first frame
    with its offset."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file (no RIFF/WEBP header)")
    riff_size, = struct.unpack_from("<I", data, 4)
    if riff_size < 12 or riff_size + 8 > len(data):
        raise ValueError("WebP: truncated RIFF")
    chunks = riff_chunks(data, 12, riff_size + 8)
    if not chunks:
        raise ValueError("WebP: no chunks")
    first = chunks[0][0]
    if first == b"VP8 ":
        w, h = _vp8_size(data[chunks[0][1]:chunks[0][2]])
        return dict(width=w, height=h, has_alpha=False, animated=False,
                    offset=(0, 0), chunks=chunks[:1])
    if first == b"VP8L":
        w, h, alpha = read_header(data[chunks[0][1]:chunks[0][2]])
        return dict(width=w, height=h, has_alpha=alpha, animated=False,
                    offset=(0, 0), chunks=chunks[:1])
    if first != b"VP8X":
        raise ValueError(f"WebP: unknown first chunk {first!r}")
    s = chunks[0][1]
    if chunks[0][2] - s < 10:
        raise ValueError("WebP: short VP8X chunk")
    flags = data[s]
    cw = 1 + int.from_bytes(data[s + 4:s + 7], "little")
    ch = 1 + int.from_bytes(data[s + 7:s + 10], "little")
    has_alpha = bool(flags & ALPHA_FLAG)
    if flags & ANIMATION_FLAG:
        for tag, fs, fe in chunks[1:]:
            if tag != b"ANMF":
                continue
            if fe - fs < 16:
                raise ValueError("WebP: short ANMF chunk")
            x0 = 2 * int.from_bytes(data[fs:fs + 3], "little")
            y0 = 2 * int.from_bytes(data[fs + 3:fs + 6], "little")
            fw = 1 + int.from_bytes(data[fs + 6:fs + 9], "little")
            fh = 1 + int.from_bytes(data[fs + 9:fs + 12], "little")
            if x0 + fw > cw or y0 + fh > ch:
                raise ValueError("WebP: a frame outside the canvas")
            return dict(width=cw, height=ch, has_alpha=has_alpha,
                        animated=True, offset=(x0, y0), frame=(fw, fh),
                        chunks=riff_chunks(data, fs + 16, fe))
        raise ValueError("WebP: an animation without frames")
    image = [c for c in chunks[1:] if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
    first_img = next((i for i, c in enumerate(image) if c[0] != b"ALPH"),
                     None)
    if first_img is None:
        raise ValueError("WebP: no VP8 or VP8L image chunk")
    tag, s, e = image[first_img]
    if tag == b"VP8L":
        w, h, has_alpha = read_header(data[s:e])
    else:
        w, h = _vp8_size(data[s:e])
    # WebPGetFeatures: an ALPH chunk before the image sets has_alpha too
    has_alpha = has_alpha or first_img > 0
    if (w, h) != (cw, ch):
        raise ValueError("WebP: the image size is not the canvas size")
    return dict(width=cw, height=ch, has_alpha=has_alpha, animated=False,
                offset=(0, 0), chunks=image)


def _vp8_size(payload: bytes) -> Tuple[int, int]:
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP: bad VP8 frame header")
    return (payload[6] | (payload[7] << 8)) & 0x3FFF, \
        (payload[8] | (payload[9] << 8)) & 0x3FFF


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> uint8 [H, W, 4] when the file has alpha, else
    [H, W, 3]: `np.asarray(PIL.Image.open(f))` for PIL 12.1."""
    info = parse(data)
    frame = decode_frame(data, info["chunks"])
    if info["animated"]:
        fw, fh = info["frame"]
        if frame.shape[:2] != (fh, fw):
            raise ValueError("WebP: the frame's image is not its ANMF size")
        canvas = np.zeros((info["height"], info["width"], 4), np.uint8)
        x0, y0 = info["offset"]
        canvas[y0:y0 + fh, x0:x0 + fw] = frame
        frame = canvas
    return frame if info["has_alpha"] else np.ascontiguousarray(
        frame[..., :3])
