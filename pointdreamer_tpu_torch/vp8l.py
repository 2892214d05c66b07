"""The VP8L lossless bitstream (WebP lossless), decoded bit for bit as
libwebp 1.6 decodes it (src/dec/vp8l_dec.c, src/utils/huffman_utils.c,
src/dsp/lossless.c):

- the LSB-first bit reader; the image header (size, alpha_is_used,
  version 0);
- prefix codes: simple codes of one or two symbols, and normal codes
  whose lengths are themselves coded with the code-length code (its
  lengths in kCodeLengthCodeOrder), repeat codes 16 / 17 / 18 and the
  optional max_symbol; a code of one symbol takes no bits;
- meta prefix codes (the entropy image), the colour cache (hash
  0x1e35a7bd), LZ77 backward references with the 120-entry distance map;
- the transforms in reverse order of reading: the predictor transform
  (all 14 modes; the rightmost pixel's top-right is the row's first
  pixel, as in libwebp), the cross-colour transform, subtract-green and
  colour indexing with 1-, 2- and 4-bit pixel bundling.

The entropy and LZ77 loop and the predictor transform are Python loops
over pixels (the predictor's left neighbour makes it sequential); the
other transforms are numpy over the whole image.  `decode_vp8l(data)`
takes the payload of a `VP8L` chunk and returns uint8 [H, W, 4] RGBA;
`decode_alpha_stream(data, w, h)` decodes an ALPH chunk's headerless
stream to its green channel.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# the distance map of short distances: (dy << 4) | (8 - dx)
CODE_TO_PLANE = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)

CODE_LENGTH_CODE_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11,
                          12, 13, 14, 15)
NUM_LITERAL_CODES, NUM_LENGTH_CODES, NUM_DISTANCE_CODES = 256, 24, 40
# GREEN (+ lengths, + cache), RED, BLUE, ALPHA, DIST
ALPHABET_SIZE = (NUM_LITERAL_CODES + NUM_LENGTH_CODES, 256, 256, 256,
                 NUM_DISTANCE_CODES)
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
ARGB_BLACK = 0xFF000000


class BitReader:
    """LSB-first bits over a byte string; reads past the end see zeros and
    `check_end` raises once more bits were consumed than the data holds."""

    def __init__(self, data: bytes, pos: int = 0):
        a = np.frombuffer(bytes(data) + b"\x00" * 8, np.uint8).astype(
            np.uint64)
        n = len(data) + 1
        win = np.zeros(n, np.uint64)
        for k in range(8):
            win |= a[k:k + n] << np.uint64(8 * k)
        self.win = win.tolist() + [0] * 8
        self.nbits = 8 * len(data)
        self.p = 8 * pos

    def read(self, n: int) -> int:
        p = self.p
        w = self.win[p >> 3] if (p >> 3) < len(self.win) else 0
        self.p = p + n
        return (w >> (p & 7)) & ((1 << n) - 1)

    def check_end(self) -> None:
        if self.p > self.nbits:
            raise ValueError("VP8L: the bitstream ended early")


def sub_sample_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


# ---------------------------------------------------------------------------
# prefix codes

def build_code(lengths: List[int]):
    """Canonical prefix code from code lengths -> (lookup table indexed by
    the next `width` bits: (symbol << 4) | length, width).  One used
    symbol gives a code of no bits; an incomplete or oversubscribed code
    raises, as in libwebp's BuildHuffmanTable."""
    used = [(n, s) for s, n in enumerate(lengths) if n]
    if not used:
        raise ValueError("VP8L: a prefix code with no symbols")
    if len(used) == 1:
        return [used[0][1] << 4], 0
    used.sort()
    width = used[-1][0]
    if sum(1 << (width - n) for n, _ in used) != 1 << width:
        raise ValueError("VP8L: an incomplete or oversubscribed prefix code")
    table = np.zeros(1 << width, np.int64)
    code, prev = 0, used[0][0]
    for n, s in used:
        code <<= n - prev
        prev = n
        rev = int(format(code, f"0{n}b")[::-1], 2)
        table[rev::1 << n] = (s << 4) | n
        code += 1
    return table.tolist(), width


def read_symbol(br: BitReader, code) -> int:
    table, width = code
    e = table[br.read(width)] if width else table[0]
    br.p -= width - (e & 15)
    return e >> 4


def _read_code_lengths(br, cl_lengths, num_symbols):
    """ReadHuffmanCodeLengths."""
    cl_code = build_code(cl_lengths)
    if br.read(1):
        length_nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(length_nbits)
        if max_symbol > num_symbols:
            raise ValueError("VP8L: max_symbol past the alphabet")
    else:
        max_symbol = num_symbols
    lengths = [0] * num_symbols
    prev_len = 8
    symbol = 0
    while symbol < num_symbols:
        if max_symbol == 0:
            break
        max_symbol -= 1
        code_len = read_symbol(br, cl_code)
        if code_len < 16:
            lengths[symbol] = code_len
            symbol += 1
            if code_len:
                prev_len = code_len
        else:
            slot = code_len - 16
            repeat = br.read((2, 3, 7)[slot]) + (3, 3, 11)[slot]
            if symbol + repeat > num_symbols:
                raise ValueError("VP8L: code-length repeat past the "
                                 "alphabet")
            val = prev_len if code_len == 16 else 0
            lengths[symbol:symbol + repeat] = [val] * repeat
            symbol += repeat
    return lengths


def read_prefix_code(br: BitReader, alphabet_size: int):
    """ReadHuffmanCode: a simple or a normal code."""
    lengths = [0] * alphabet_size
    if br.read(1):                                   # simple code
        num_symbols = br.read(1) + 1
        first_bits = 8 if br.read(1) else 1
        s = br.read(first_bits)
        if s >= alphabet_size:
            raise ValueError("VP8L: simple-code symbol past the alphabet")
        lengths[s] = 1
        if num_symbols == 2:
            s = br.read(8)
            if s >= alphabet_size:
                raise ValueError("VP8L: simple-code symbol past the "
                                 "alphabet")
            lengths[s] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[CODE_LENGTH_CODE_ORDER[i]] = br.read(3)
        lengths = _read_code_lengths(br, cl, alphabet_size)
    br.check_end()
    return build_code(lengths)


def read_prefix_groups(br, xsize, ysize, cache_bits, allow_meta):
    """ReadHuffmanCodes: (entropy image [tiles] or None, its bits,
    tiles per row, the groups of five codes)."""
    himage, hbits, hxsize = None, 0, 1
    num_groups = 1
    if allow_meta and br.read(1):
        hbits = 2 + br.read(3)
        hxsize = sub_sample_size(xsize, hbits)
        hysize = sub_sample_size(ysize, hbits)
        img = decode_image_stream(br, hxsize, hysize, False)
        himage = ((img >> 8) & 0xFFFF).astype(np.int64)
        num_groups = int(himage.max()) + 1
    groups = []
    for _ in range(num_groups):
        codes = []
        for j in range(5):
            size = ALPHABET_SIZE[j]
            if j == 0 and cache_bits:
                size += 1 << cache_bits
            codes.append(read_prefix_code(br, size))
        groups.append(codes)
    return himage, hbits, hxsize, groups


# ---------------------------------------------------------------------------
# the entropy-coded pixels

def _prefix_value(sym: int, br: BitReader) -> int:
    """GetCopyDistance / GetCopyLength."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    offset = (2 + (sym & 1)) << extra
    return offset + br.read(extra) + 1


def plane_code_to_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    dist_code = CODE_TO_PLANE[code - 1]
    dist = (dist_code >> 4) * xsize + 8 - (dist_code & 15)
    return dist if dist >= 1 else 1


def decode_pixels(br, width, height, cache_bits, himage, hbits, hxsize,
                  groups) -> List[int]:
    """DecodeImageData: literals, backward references and colour-cache
    hits -> ARGB ints in raster order."""
    total = width * height
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    tables = groups
    win = br.win
    p = br.p
    hmap = himage.tolist() if himage is not None else None
    mask = (1 << hbits) - 1 if hmap is not None else -1
    g = tables[0]
    i = x = y = 0
    cache_lim = 280 + (1 << cache_bits if cache_bits else 0)
    while i < total:
        if hmap is not None and (x & mask) == 0:
            g = tables[hmap[(y >> hbits) * hxsize + (x >> hbits)]]
        (gt, gw), (rt, rw), (bt, bw), (at, aw), dist_code = g
        e = gt[(win[p >> 3] >> (p & 7)) & ((1 << gw) - 1)] if gw else gt[0]
        p += e & 15
        code = e >> 4
        if code < 256:
            e = rt[(win[p >> 3] >> (p & 7)) & ((1 << rw) - 1)] if rw \
                else rt[0]
            p += e & 15
            red = e >> 4
            e = bt[(win[p >> 3] >> (p & 7)) & ((1 << bw) - 1)] if bw \
                else bt[0]
            p += e & 15
            blue = e >> 4
            e = at[(win[p >> 3] >> (p & 7)) & ((1 << aw) - 1)] if aw \
                else at[0]
            p += e & 15
            px = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            out[i] = px
            if cache is not None:
                cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            i += 1
            x += 1
            if x == width:
                x = 0
                y += 1
        elif code < 280:
            br.p = p
            length = _prefix_value(code - 256, br)
            dsym = read_symbol(br, dist_code)
            dist = plane_code_to_distance(width, _prefix_value(dsym, br))
            p = br.p
            if dist > i or length > total - i:
                raise ValueError("VP8L: a backward reference out of range")
            for k in range(i, i + length):
                px = out[k - dist]
                out[k] = px
                if cache is not None:
                    cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            i += length
            x += length
            while x >= width:
                x -= width
                y += 1
            if hmap is not None and (x & mask):
                g = tables[hmap[(y >> hbits) * hxsize + (x >> hbits)]]
        elif code < cache_lim:
            px = cache[code - 280]
            out[i] = px
            cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            i += 1
            x += 1
            if x == width:
                x = 0
                y += 1
        else:
            raise ValueError("VP8L: a green symbol past the alphabet")
        if p > br.nbits + 64:
            break
    br.p = p
    br.check_end()
    return out


# ---------------------------------------------------------------------------
# transforms (lossless.c), ARGB as uint32

def _add_pixels(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) \
        | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _average2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, left: int, tl: int) -> int:
    pa_minus_pb = 0
    for s in (24, 16, 8, 0):
        a, b, c = (t >> s) & 255, (left >> s) & 255, (tl >> s) & 255
        pa_minus_pb += abs(b - c) - abs(a - c)
    return t if pa_minus_pb <= 0 else left


def _add_sub_full(a: int, b: int, c: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        out |= _clip255(((a >> s) & 255) + ((b >> s) & 255)
                        - ((c >> s) & 255)) << s
    return out


def _add_sub_half(a: int, c: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        x, z = (a >> s) & 255, (c >> s) & 255
        d = x - z
        out |= _clip255(x + ((d + (d < 0)) >> 1)) << s     # C's d / 2
    return out


def _predict(mode: int, left: int, t: int, tr: int, tl: int) -> int:
    if mode == 1:
        return left
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _average2(_average2(left, tr), t)
    if mode == 6:
        return _average2(left, tl)
    if mode == 7:
        return _average2(left, t)
    if mode == 8:
        return _average2(tl, t)
    if mode == 9:
        return _average2(t, tr)
    if mode == 10:
        return _average2(_average2(left, tl), _average2(t, tr))
    if mode == 11:
        return _select(t, left, tl)
    if mode == 12:
        return _add_sub_full(left, t, tl)
    if mode == 13:
        return _add_sub_half(_average2(left, t), tl)
    return ARGB_BLACK                                # 0, 14, 15


def inverse_predictor(res: List[int], width: int, height: int, bits: int,
                      modes: np.ndarray) -> List[int]:
    """PredictorInverseTransform: the first row predicts from the left
    (black for the first pixel), each row's first pixel from the top, the
    rest with their tile's mode."""
    out = list(res)
    out[0] = _add_pixels(res[0], ARGB_BLACK)
    for x in range(1, width):
        out[x] = _add_pixels(res[x], out[x - 1])
    tiles_per_row = sub_sample_size(width, bits)
    mode_list = ((modes >> 8) & 15).tolist()
    for y in range(1, height):
        i = y * width
        out[i] = _add_pixels(res[i], out[i - width])
        row_modes = mode_list[(y >> bits) * tiles_per_row:
                              ((y >> bits) + 1) * tiles_per_row]
        for x in range(1, width):
            i += 1
            mode = row_modes[x >> bits]
            # the rightmost pixel's top-right is this row's first pixel
            pred = _predict(mode, out[i - 1], out[i - width],
                            out[i - width + 1], out[i - width - 1])
            out[i] = _add_pixels(res[i], pred)
    return out


def _tile_expand(data: np.ndarray, width: int, height: int, bits: int):
    """Per-pixel copy of a subsampled tile image."""
    tw = sub_sample_size(width, bits)
    ty = np.arange(height) >> bits
    tx = np.arange(width) >> bits
    return data[ty[:, None] * tw + tx[None, :]].reshape(-1)


def inverse_cross_color(px: np.ndarray, width: int, height: int, bits: int,
                        data: np.ndarray) -> np.ndarray:
    m = _tile_expand(data, width, height, bits)
    g2r = (m & 255).astype(np.int8).astype(np.int64)
    g2b = ((m >> 8) & 255).astype(np.int8).astype(np.int64)
    r2b = ((m >> 16) & 255).astype(np.int8).astype(np.int64)
    green = ((px >> 8) & 255).astype(np.int8).astype(np.int64)
    red = ((px >> 16) & 255).astype(np.int64)
    blue = (px & 255).astype(np.int64)
    red = (red + ((g2r * green) >> 5)) & 255
    blue = blue + ((g2b * green) >> 5)
    blue = (blue + ((r2b * red.astype(np.uint8).astype(np.int8)) >> 5)) \
        & 255
    return (px & 0xFF00FF00) | (red.astype(np.uint64) << 16) \
        | blue.astype(np.uint64)


def add_green(px: np.ndarray) -> np.ndarray:
    g = (px >> 8) & 255
    rb = ((px & 0x00FF00FF) + ((g << 16) | g)) & 0x00FF00FF
    return (px & 0xFF00FF00) | rb


def inverse_color_indexing(px: np.ndarray, width: int, height: int,
                           bits: int, palette: np.ndarray) -> np.ndarray:
    """Indices in the green channel, 1 << bits of them a pixel (the first
    in the low bits) -> palette colours."""
    idx = (px >> 8) & 255
    if bits:
        packed_w = sub_sample_size(width, bits)
        bpp = 8 >> bits
        x = np.arange(width)
        idx = idx.reshape(height, packed_w)[:, x >> bits]
        idx = (idx >> ((x & ((1 << bits) - 1)) * bpp).astype(np.uint64)) \
            & ((1 << bpp) - 1)
    return palette[idx.reshape(-1).astype(np.int64)]


# ---------------------------------------------------------------------------
# the image stream

def decode_image_stream(br: BitReader, xsize: int, ysize: int,
                        is_level0: bool) -> np.ndarray:
    """DecodeImageStream: the transforms (level 0 only), the colour cache,
    the prefix codes and the pixels -> ARGB uint64 [ysize * xsize] with
    the transforms inverted."""
    transforms = []
    seen = set()
    width = xsize
    if is_level0:
        while br.read(1):
            t = br.read(2)
            if t in seen:
                raise ValueError("VP8L: a transform appears twice")
            seen.add(t)
            if t in (PREDICTOR, CROSS_COLOR):
                bits = 2 + br.read(3)
                data = decode_image_stream(
                    br, sub_sample_size(width, bits),
                    sub_sample_size(ysize, bits), False)
                transforms.append((t, width, bits, data))
            elif t == COLOR_INDEXING:
                num_colors = br.read(8) + 1
                bits = 3 if num_colors <= 2 else 2 if num_colors <= 4 \
                    else 1 if num_colors <= 16 else 0
                pal = decode_image_stream(br, num_colors, 1, False)
                # delta-coded colours, padded with transparent black
                pal8 = pal.astype("<u4").view(np.uint8).reshape(-1, 4)
                pal8 = np.cumsum(pal8.astype(np.int64), axis=0) & 255
                full = np.zeros((1 << (8 >> bits), 4), np.int64)
                full[:num_colors] = pal8
                palette = full.astype(np.uint8).reshape(-1).view(
                    "<u4").astype(np.uint64)
                transforms.append((t, width, bits, palette))
                width = sub_sample_size(width, bits)
            else:
                transforms.append((t, width, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("VP8L: invalid colour cache size")
    himage, hbits, hxsize, groups = read_prefix_groups(
        br, width, ysize, cache_bits, is_level0)
    px = decode_pixels(br, width, ysize, cache_bits, himage, hbits, hxsize,
                       groups)
    arr = None
    for t, w, bits, data in reversed(transforms):
        if t == PREDICTOR:
            src = px if arr is None else arr.tolist()
            arr = np.array(inverse_predictor(src, w, ysize, bits, data),
                           np.uint64)
            px = None
            continue
        if arr is None:
            arr = np.array(px, np.uint64)
            px = None
        if t == CROSS_COLOR:
            arr = inverse_cross_color(arr, w, ysize, bits, data)
        elif t == SUBTRACT_GREEN:
            arr = add_green(arr)
        else:
            arr = inverse_color_indexing(arr, w, ysize, bits, data)
    if arr is None:
        arr = np.array(px, np.uint64)
    return arr


def read_header(data: bytes) -> Tuple[int, int, bool]:
    """(width, height, alpha_is_used) of a VP8L payload."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("VP8L: bad signature")
    bits = int.from_bytes(data[1:5], "little")
    if bits >> 29:
        raise ValueError("VP8L: unknown version")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, \
        bool((bits >> 28) & 1)


def argb_to_rgba(argb: np.ndarray, width: int, height: int) -> np.ndarray:
    a = argb.astype(np.uint32)
    return np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255, a >> 24],
                    -1).astype(np.uint8).reshape(height, width, 4)


def decode_vp8l(data: bytes) -> np.ndarray:
    """The payload of a `VP8L` chunk -> uint8 [H, W, 4] RGBA (the alpha
    as decoded, whatever the header's alpha_is_used says)."""
    w, h, _ = read_header(data)
    br = BitReader(data, 5)
    return argb_to_rgba(decode_image_stream(br, w, h, True), w, h)


def decode_alpha_stream(data: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's lossless stream (an image stream with no header)
    -> uint8 [height, width], the green channel."""
    br = BitReader(data, 0)
    argb = decode_image_stream(br, width, height, True)
    return ((argb >> 8) & 255).astype(np.uint8).reshape(height, width)
