"""The VP8 lossy key frame (RFC 6386), decoded in numpy bit for bit as
libwebp 1.6 decodes it (src/dec/vp8_dec.c, tree_dec.c, quant_dec.c,
frame_dec.c; src/dsp/dec.c, upsampling.c, yuv.h):

- the boolean entropy decoder (RFC 6386 section 7) over the first
  partition and the 1, 2, 4 or 8 token partitions;
- the frame header: segments, the simple or normal loop filter with its
  level, sharpness and reference / mode deltas, the quantiser indices
  with libwebp's clamps, the coefficient probability updates;
- per macroblock: segment, skip flag, the 16x16 or ten 4x4 luma modes,
  the chroma mode, and the DCT tokens;
- reconstruction: the inverse WHT of the second-order DC block and the
  integer inverse DCT of every 4x4 block (vectorised over the frame: the
  residuals do not depend on the prediction), then the intra predictors
  macroblock by macroblock on the unfiltered frame (libwebp predicts from
  unfiltered samples);
- the loop filter in libwebp's order (macroblock raster order: left edge,
  inner vertical edges, top edge, inner horizontal edges), vectorised over
  the wavefronts of macroblocks with equal x + 2y, which touch disjoint
  pixels;
- the output: libwebp's "fancy" chroma upsampling and its 14-bit
  fixed-point YUV -> RGB conversion.

The entropy decoding is a Python loop over the boolean decoder's bits;
everything else is numpy.  `decode_vp8(data)` takes the payload of a
`VP8 ` chunk and returns uint8 [H, W, 3] RGB.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# tables of RFC 6386 (sections 13.4, 13.5, 14.1, 11.5), as libwebp holds
# them

# [type 4][band 8][context 3][11]
_COEFF_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffff"
    "fffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffff"
    "fffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffff"
    "fffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffee"
    "fdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffff"
    "fffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff"
    "fffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff"
    "fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe"
    "fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefe"
    "fffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff"
    "fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffff"
    "fffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff"
    "fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdff"
    "fffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffffffff"
    "fdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_COEFF_PROBA0 = bytes.fromhex(
    "8080808080808080808080808080808080808080808080808080808080808080"
    "80fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff80"
    "80800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680"
    "808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ff"
    "ffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff"
    "c2e080808080800101ff8080808080808080f601ff8080808080808080ff8080"
    "8080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc780808051"
    "63b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff80"
    "80801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080"
    "808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff80"
    "80808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1"
    "b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db"
    "ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5"
    "f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff8080808080"
    "80d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0"
    "f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff7"
    "9fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db"
    "f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fc"
    "cccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179"
    "ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd80808001"
    "01ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabda"
    "bd110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa"
    "2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b"
    "1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330f"
    "ba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a62"
    "40221674ce17222ba6496b36201a3301512b1f44196a1640ab24e17222131566"
    "84bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b43"
    "2d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e"
    "16188001361125412049731c801780cd2803097333c01206df572509733b4d40"
    "152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b"
    "33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58"
    "685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a55"
    "8065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c045"
    "3c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f"
    "069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404"
    "f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b"
    "769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc3"
    "80300418")
_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c"
    "1d1e1f20212223242525262728292a2b2c2d2e2e2f303132333435363738393a"
    "3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859"
    "5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
    173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225,
    229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)

COEFF_UPDATE_PROBA = np.frombuffer(_COEFF_UPDATE_PROBA, np.uint8).reshape(
    4, 8, 3, 11)
COEFF_PROBA0 = np.frombuffer(_COEFF_PROBA0, np.uint8).reshape(4, 8, 3, 11)
# key-frame 4x4 mode probabilities, [top mode][left mode][9]
BMODES_PROBA = np.frombuffer(_BMODES_PROBA, np.uint8).reshape(10, 10, 9)
DC_TABLE = np.frombuffer(_DC_TABLE, np.uint8).astype(np.int64)
AC_TABLE = np.array(_AC_TABLE, np.int64)

# coefficient scan order and the band of each position (the 17th entry is
# the band of the position after the last)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135),
           (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))

# intra modes (libwebp's enum): the 16x16 and chroma modes use the first
# four values
B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, \
    B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED = range(10)
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC_PRED, B_TM_PRED, B_VE_PRED, \
    B_HE_PRED

# the renormalisation shift that brings a range below 128 back to 128..255
_NORM = [0] * 256
for _r in range(1, 128):
    _NORM[_r] = 8 - _r.bit_length()


# ---------------------------------------------------------------------------
# the boolean decoder

class BoolDecoder:
    """RFC 6386's boolean decoder (libwebp's VP8GetBit: the same split and
    renormalisation).  Reading past the end feeds zeros.  With `trace` a
    list, every decoded bool is appended to it as (bit, probability)."""

    __slots__ = ("data", "pos", "end", "value", "bits", "range", "trace")

    def __init__(self, data: bytes, start: int = 0,
                 end: Optional[int] = None, trace: Optional[list] = None):
        self.data = data
        self.pos = start
        self.end = len(data) if end is None else end
        self.value = 0
        self.bits = -8          # lookahead bits below the top 8
        self.range = 255
        self.trace = trace

    def _load(self) -> None:
        p, e = self.pos, self.end
        b0 = self.data[p] if p < e else 0
        b1 = self.data[p + 1] if p + 1 < e else 0
        self.pos = p + 2
        self.value = (self.value << 16) | (b0 << 8) | b1
        self.bits += 16

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = 1 + (((self.range - 1) * prob) >> 8)
        bits = self.bits
        if (self.value >> bits) >= split:
            self.value -= split << bits
            r = self.range - split
            b = 1
        else:
            r = split
            b = 0
        if r < 128:
            s = _NORM[r]
            r <<= s
            self.bits = bits - s
        self.range = r
        if self.trace is not None:
            self.trace.append((b, prob))
        return b

    def value_bits(self, n: int) -> int:
        """n bits at probability 128, most significant first
        (VP8GetValue)."""
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        """VP8GetSignedValue: n bits, then a sign bit."""
        v = self.value_bits(n)
        return -v if self.bit(128) else v


# ---------------------------------------------------------------------------
# headers

class FrameHeader:
    """The key frame's header fields (libwebp's VP8FrameHeader,
    VP8SegmentHeader, VP8FilterHeader, VP8Proba and the dequantisation
    matrices)."""

    def __init__(self):
        self.width = self.height = 0
        self.first_part_size = 0
        self.colorspace = self.clamp_type = 0
        self.use_segment = self.update_map = 0
        self.absolute_delta = 1
        self.seg_quant = [0] * 4
        self.seg_filter = [0] * 4
        self.seg_proba = [255] * 3
        self.simple = self.level = self.sharpness = 0
        self.use_lf_delta = 0
        self.ref_lf_delta = [0] * 4
        self.mode_lf_delta = [0] * 4
        self.num_parts = 1
        # [segment] -> (y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac)
        self.quant = None
        self.coeff_proba = None
        self.use_skip_proba = 0
        self.skip_proba = 0
        # trace positions (with a tracing decoder): where the filter header
        # and the partition count start and end
        self.marks = {}


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


def parse_header(data: bytes, trace: Optional[list] = None):
    """The frame tag, the key frame's start code and size, and the first
    partition's header.  Returns (FrameHeader, the first partition's
    BoolDecoder positioned after the header, the token partitions as
    (start, end) byte ranges)."""
    if len(data) < 10:
        raise ValueError("VP8: truncated frame header")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    key_frame = not (bits & 1)
    profile = (bits >> 1) & 7
    show = (bits >> 4) & 1
    hdr = FrameHeader()
    hdr.first_part_size = bits >> 5
    if not key_frame:
        raise ValueError("VP8: not a key frame")
    if profile > 3:
        raise ValueError("VP8: incorrect keyframe parameters")
    if not show:
        raise ValueError("VP8: frame not displayable")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8: bad start code")
    hdr.width = (data[6] | (data[7] << 8)) & 0x3FFF
    hdr.height = (data[8] | (data[9] << 8)) & 0x3FFF
    if hdr.width == 0 or hdr.height == 0:
        raise ValueError("VP8: zero-sized frame")
    start = 10
    if hdr.first_part_size > len(data) - start:
        raise ValueError("VP8: bad partition length")
    br = BoolDecoder(data, start, start + hdr.first_part_size, trace)
    hdr.colorspace = br.bit(128)
    hdr.clamp_type = br.bit(128)
    # segment header
    hdr.use_segment = br.bit(128)
    if hdr.use_segment:
        hdr.update_map = br.bit(128)
        if br.bit(128):                         # update segment data
            hdr.absolute_delta = br.bit(128)
            hdr.seg_quant = [br.signed(7) if br.bit(128) else 0
                             for _ in range(4)]
            hdr.seg_filter = [br.signed(6) if br.bit(128) else 0
                              for _ in range(4)]
        if hdr.update_map:
            hdr.seg_proba = [br.value_bits(8) if br.bit(128) else 255
                             for _ in range(3)]
    # filter header
    hdr.marks["filter"] = len(trace) if trace is not None else 0
    hdr.simple = br.bit(128)
    hdr.level = br.value_bits(6)
    hdr.sharpness = br.value_bits(3)
    hdr.use_lf_delta = br.bit(128)
    if hdr.use_lf_delta and br.bit(128):        # update the deltas
        for i in range(4):
            if br.bit(128):
                hdr.ref_lf_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(128):
                hdr.mode_lf_delta[i] = br.signed(6)
    hdr.marks["partitions"] = len(trace) if trace is not None else 0
    # token partitions
    last = (1 << br.value_bits(2)) - 1
    hdr.marks["quant"] = len(trace) if trace is not None else 0
    hdr.num_parts = last + 1
    sizes = start + hdr.first_part_size
    part_start = sizes + 3 * last
    if part_start > len(data):
        raise ValueError("VP8: cannot parse partitions")
    size_left = len(data) - part_start
    parts = []
    for p in range(last):
        psize = data[sizes + 3 * p] | (data[sizes + 3 * p + 1] << 8) \
            | (data[sizes + 3 * p + 2] << 16)
        psize = min(psize, size_left)
        parts.append((part_start, part_start + psize))
        part_start += psize
        size_left -= psize
    parts.append((part_start, len(data)))
    if part_start >= len(data):
        # an empty last partition: libwebp refuses it outside streaming
        raise ValueError("VP8: cannot parse partitions")
    # quantiser
    base_q0 = br.value_bits(7)
    deltas = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
    dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = deltas
    quant = []
    for i in range(4):
        if hdr.use_segment:
            q = hdr.seg_quant[i]
            if not hdr.absolute_delta:
                q += base_q0
        elif i > 0:
            quant.append(quant[0])
            continue
        else:
            q = base_q0
        y2_ac = (int(AC_TABLE[_clip(q + dqy2_ac, 127)]) * 101581) >> 16
        quant.append((
            int(DC_TABLE[_clip(q + dqy1_dc, 127)]),
            int(AC_TABLE[_clip(q, 127)]),
            int(DC_TABLE[_clip(q + dqy2_dc, 127)]) * 2,
            max(y2_ac, 8),
            int(DC_TABLE[_clip(q + dquv_dc, 117)]),
            int(AC_TABLE[_clip(q + dquv_ac, 127)])))
    hdr.quant = quant
    br.bit(128)                                  # update_proba: ignored
    proba = COEFF_PROBA0.astype(np.int64).copy()
    upd = COEFF_UPDATE_PROBA.tolist()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(upd[t][b][c][p]):
                        proba[t, b, c, p] = br.value_bits(8)
    hdr.coeff_proba = proba
    hdr.use_skip_proba = br.bit(128)
    if hdr.use_skip_proba:
        hdr.skip_proba = br.value_bits(8)
    return hdr, br, parts


# ---------------------------------------------------------------------------
# per-macroblock data

def _parse_intra_mode(br, hdr, top, left, mbx):
    """(segment, skip, is_i4x4, 16 luma modes or [mode], chroma mode) of
    one macroblock (libwebp's ParseIntraMode); updates the mode
    contexts."""
    bit = br.bit
    if hdr.update_map:
        sp = hdr.seg_proba
        seg = bit(sp[1]) if not bit(sp[0]) else bit(sp[2]) + 2
    else:
        seg = 0
    skip = bit(hdr.skip_proba) if hdr.use_skip_proba else 0
    is_i4 = not bit(145)
    t = top[mbx]
    if not is_i4:
        if bit(156):
            ymode = TM_PRED if bit(128) else H_PRED
        else:
            ymode = V_PRED if bit(163) else DC_PRED
        modes = [ymode]
        t[:] = [ymode] * 4
        left[:] = [ymode] * 4
    else:
        modes = [0] * 16
        for y in range(4):
            ymode = left[y]
            for x in range(4):
                p = _BMODES[t[x]][ymode]
                if not bit(p[0]):
                    ymode = B_DC_PRED
                elif not bit(p[1]):
                    ymode = B_TM_PRED
                elif not bit(p[2]):
                    ymode = B_VE_PRED
                elif not bit(p[3]):
                    if not bit(p[4]):
                        ymode = B_HE_PRED
                    else:
                        ymode = B_VR_PRED if bit(p[5]) else B_RD_PRED
                elif not bit(p[6]):
                    ymode = B_LD_PRED
                elif not bit(p[7]):
                    ymode = B_VL_PRED
                else:
                    ymode = B_HU_PRED if bit(p[8]) else B_HD_PRED
                t[x] = ymode
                modes[4 * y + x] = ymode
            left[y] = ymode
    if not bit(142):
        uvmode = DC_PRED
    elif not bit(114):
        uvmode = V_PRED
    else:
        uvmode = TM_PRED if bit(183) else H_PRED
    return seg, skip, is_i4, modes, uvmode


_BMODES = BMODES_PROBA.tolist()


def _get_coeffs(bit, prob, ctx, dc_q, ac_q, n, out, base):
    """libwebp's GetCoeffs: the tokens of one 4x4 block from position n,
    dequantised into out[base + natural index]; returns the position
    after the last token (0..16)."""
    p = prob[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n                     # end of block
        while not bit(p[1]):             # a zero coefficient
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        if not bit(p[2]):
            v = 1
            p = prob[n + 1][1]
        else:
            if not bit(p[3]):
                if not bit(p[4]):
                    v = 2
                else:
                    v = 3 + bit(p[5])
            elif not bit(p[6]):
                if not bit(p[7]):
                    v = 5 + bit(159)
                else:
                    v = 7 + 2 * bit(165)
                    v += bit(145)
            else:
                bit1 = bit(p[8])
                bit0 = bit(p[9 + bit1])
                cat = 2 * bit1 + bit0
                v = 0
                for t in CAT3456[cat]:
                    v += v + bit(t)
                v += 3 + (8 << cat)
            p = prob[n + 1][2]
        if bit(128):
            v = -v
        out[base + ZIGZAG[n]] = v * (ac_q if n else dc_q)
        n += 1
    return 16


class Frame:
    """Everything the entropy decoding of a key frame yields."""

    def __init__(self, hdr, mbw, mbh):
        n = mbw * mbh
        self.hdr = hdr
        self.mbw, self.mbh = mbw, mbh
        self.segment = np.zeros(n, np.int64)
        self.is_i4 = np.zeros(n, bool)
        self.ymodes = np.zeros((n, 16), np.int64)
        self.uvmode = np.zeros(n, np.int64)
        self.skip = np.zeros(n, bool)   # skipped by the skip flag
        # coefficients: 16 luma, 4 U, 4 V blocks of 16 (natural order),
        # the second-order DC block apart; nz: libwebp's nz per block
        self.coeffs = [0] * (n * 384)
        self.y2 = [0] * (n * 16)
        self.nz = [0] * (n * 24)


def parse_frame(data: bytes, trace: bool = False):
    """Entropy-decode a key frame.  With `trace`, also returns the
    decoder's record: the first partition's (bit, probability) pairs and
    those of each macroblock row's tokens."""
    first_trace = [] if trace else None
    hdr, br, parts = parse_header(data, first_trace)
    mbw, mbh = (hdr.width + 15) >> 4, (hdr.height + 15) >> 4
    fr = Frame(hdr, mbw, mbh)
    row_traces = [] if trace else None
    part_br = [BoolDecoder(data, s, e) for s, e in parts]
    probs = []
    for t in range(4):
        pt = hdr.coeff_proba[t].tolist()
        probs.append([pt[BANDS[n]] for n in range(17)])
    intra_t = [[B_DC_PRED] * 4 for _ in range(mbw)]
    # non-zero contexts: top per column (4 luma, 2 U, 2 V, DC) and left
    top_nz = [[0] * 9 for _ in range(mbw)]
    coeffs, y2, nzs = fr.coeffs, fr.y2, fr.nz
    for mby in range(mbh):
        intra_l = [B_DC_PRED] * 4
        rows = [_parse_intra_mode(br, hdr, intra_t, intra_l, mbx)
                for mbx in range(mbw)]
        tbr = part_br[mby & (hdr.num_parts - 1)]
        if trace:
            tbr.trace = []
            row_traces.append(tbr.trace)
        bit = tbr.bit
        left = [0] * 9
        for mbx, (seg, skip, is_i4, modes, uvmode) in enumerate(rows):
            m = mby * mbw + mbx
            fr.segment[m] = seg
            fr.is_i4[m] = is_i4
            fr.ymodes[m] = modes if is_i4 else modes * 16
            fr.uvmode[m] = uvmode
            top = top_nz[mbx]
            if hdr.use_skip_proba and skip:
                fr.skip[m] = True
                top[:8] = [0] * 8
                left[:8] = [0] * 8
                if not is_i4:
                    top[8] = left[8] = 0
                continue
            q = hdr.quant[seg]
            base = m * 384
            if not is_i4:
                nz = _get_coeffs(bit, probs[1], top[8] + left[8], q[2],
                                 q[3], 0, y2, m * 16)
                top[8] = left[8] = int(nz > 0)
                first, ac = 1, probs[0]
            else:
                first, ac = 0, probs[3]
            for y in range(4):
                lf = left[y]
                for x in range(4):
                    blk = 4 * y + x
                    nz = _get_coeffs(bit, ac, lf + top[x], q[0], q[1],
                                     first, coeffs, base + 16 * blk)
                    nzs[m * 24 + blk] = nz
                    lf = int(nz > first)
                    top[x] = lf
                left[y] = lf
            for ch in (4, 6):                      # U then V
                for y in range(2):
                    lf = left[ch + y]
                    for x in range(2):
                        blk = 16 + 2 * (ch - 4) + 2 * y + x
                        nz = _get_coeffs(bit, probs[2], lf + top[ch + x],
                                         q[4], q[5], 0, coeffs,
                                         base + 16 * blk)
                        nzs[m * 24 + blk] = nz
                        lf = int(nz > 0)
                        top[ch + x] = lf
                    left[ch + y] = lf
    if trace:
        return fr, first_trace, row_traces
    return fr


# ---------------------------------------------------------------------------
# transforms (src/dsp/dec.c), vectorised over blocks

def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def inverse_wht(dc: np.ndarray) -> np.ndarray:
    """TransformWHT: [N, 16] second-order coefficients (natural order) ->
    [N, 16] DC values of the 16 luma blocks (raster order)."""
    i = dc.astype(np.int64).reshape(-1, 4, 4)
    a0 = i[:, 0] + i[:, 3]
    a1 = i[:, 1] + i[:, 2]
    a2 = i[:, 1] - i[:, 2]
    a3 = i[:, 0] - i[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)   # [N, 4, 4]
    dcv = t[:, :, 0] + 3
    b0 = dcv + t[:, :, 3]
    b1 = t[:, :, 1] + t[:, :, 2]
    b2 = t[:, :, 1] - t[:, :, 2]
    b3 = dcv - t[:, :, 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3,
                    (b3 - b2) >> 3], 2)                      # [N, row, col]
    return out.reshape(-1, 16)


def inverse_dct(coef: np.ndarray) -> np.ndarray:
    """TransformOne without the prediction: [N, 16] dequantised
    coefficients (natural order) -> [N, 4, 4] residuals, the values libwebp
    adds to the prediction before clipping.  Its DC-only and AC3
    shortcuts give the same values."""
    c = coef.astype(np.int64).reshape(-1, 4, 4)
    a = c[:, 0] + c[:, 2]
    b = c[:, 0] - c[:, 2]
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], 1)        # [N, row, col]
    dcv = t[:, :, 0] + 4
    a = dcv + t[:, :, 2]
    b = dcv - t[:, :, 2]
    cc = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3])
    d = _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    return np.stack([(a + d) >> 3, (b + cc) >> 3, (b - cc) >> 3,
                     (a - d) >> 3], 2)


# ---------------------------------------------------------------------------
# intra prediction

# A 4x4 block's edge: e = [L, L, K, J, I, X, A, B, C, D, E, F, G, H, H]
# (left column bottom-up, corner, top row with the top-right; the ends
# repeated), then the averages of neighbours: AVG2 of e[i], e[i + 1] at
# 15 + i and AVG3 centred on e[c] at 28 + c.
_E = dict(L=1, K=2, J=3, I=4, X=5, A=6, B=7, C=8, D=9, E=10, F=11, G=12,
          H=13)


def _a2(p, q):
    return 15 + min(_E[p], _E[q])


def _a3(c):
    return 28 + _E[c]


def _mode_index(spec):
    """A 4x4 predictor given as {(x, y): edge index} -> 16 indices in
    raster order."""
    return [spec[x, y] for y in range(4) for x in range(4)]


def _build_modes():
    m = {}
    m[B_VE_PRED] = _mode_index({(x, y): _a3("ABCD"[x]) for x in range(4)
                                for y in range(4)})
    m[B_HE_PRED] = _mode_index({(x, y): _a3("IJKL"[y]) for x in range(4)
                                for y in range(4)})
    rd = "KJIXABC"
    m[B_RD_PRED] = _mode_index({(x, y): _a3(rd[3 + x - y]) for x in range(4)
                                for y in range(4)})
    ld = "BCDEFGH"
    m[B_LD_PRED] = _mode_index({(x, y): _a3(ld[x + y]) for x in range(4)
                                for y in range(4)})
    vr = {(0, 0): _a2("X", "A"), (1, 2): _a2("X", "A"),
          (1, 0): _a2("A", "B"), (2, 2): _a2("A", "B"),
          (2, 0): _a2("B", "C"), (3, 2): _a2("B", "C"),
          (3, 0): _a2("C", "D"),
          (0, 3): _a3("J"), (0, 2): _a3("I"),
          (0, 1): _a3("X"), (1, 3): _a3("X"),
          (1, 1): _a3("A"), (2, 3): _a3("A"),
          (2, 1): _a3("B"), (3, 3): _a3("B"),
          (3, 1): _a3("C")}
    m[B_VR_PRED] = _mode_index(vr)
    vl = {(0, 0): _a2("A", "B"),
          (1, 0): _a2("B", "C"), (0, 2): _a2("B", "C"),
          (2, 0): _a2("C", "D"), (1, 2): _a2("C", "D"),
          (3, 0): _a2("D", "E"), (2, 2): _a2("D", "E"),
          (0, 1): _a3("B"),
          (1, 1): _a3("C"), (0, 3): _a3("C"),
          (2, 1): _a3("D"), (1, 3): _a3("D"),
          (3, 1): _a3("E"), (2, 3): _a3("E"),
          (3, 2): _a3("F"), (3, 3): _a3("G")}
    m[B_VL_PRED] = _mode_index(vl)
    hu = {(0, 0): _a2("I", "J"),
          (2, 0): _a2("J", "K"), (0, 1): _a2("J", "K"),
          (2, 1): _a2("K", "L"), (0, 2): _a2("K", "L"),
          (1, 0): _a3("J"),
          (3, 0): _a3("K"), (1, 1): _a3("K"),
          (3, 1): _a3("L"), (1, 2): _a3("L")}
    for xy in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
        hu[xy] = _E["L"]
    m[B_HU_PRED] = _mode_index(hu)
    hd = {(0, 0): _a2("I", "X"), (2, 1): _a2("I", "X"),
          (0, 1): _a2("J", "I"), (2, 2): _a2("J", "I"),
          (0, 2): _a2("K", "J"), (2, 3): _a2("K", "J"),
          (0, 3): _a2("L", "K"),
          (3, 0): _a3("B"), (2, 0): _a3("A"),
          (1, 0): _a3("X"), (3, 1): _a3("X"),
          (1, 1): _a3("I"), (3, 2): _a3("I"),
          (1, 2): _a3("J"), (3, 3): _a3("J"),
          (1, 3): _a3("K")}
    m[B_HD_PRED] = _mode_index(hd)
    return m


MODE4_INDEX = _build_modes()
_CLIP = [0] * 512 + list(range(256)) + [255] * 512     # index v + 512


def predict4(mode: int, top: List[int], left: List[int]) -> List[int]:
    """A 4x4 luma prediction in raster order from the corner and the top
    row with its top-right (`top`, 9 samples: X, A..H) and the left column
    (`left`, 4 samples: I..L)."""
    if mode == B_DC_PRED:
        dc = (sum(top[1:5]) + sum(left) + 4) >> 3
        return [dc] * 16
    if mode == B_TM_PRED:
        x0 = top[0]
        return [_CLIP[512 + t + lv - x0] for lv in left for t in top[1:5]]
    i0, i1, i2, i3 = left
    e = [i3, i3, i2, i1, i0] + top + [top[8]]
    ext = e + [(e[i] + e[i + 1] + 1) >> 1 for i in range(14)] \
        + [(e[i - 1] + 2 * e[i] + e[i + 1] + 2) >> 2 for i in range(1, 14)]
    return [ext[i] for i in MODE4_INDEX[mode]]


def _predict_block(mode: int, top: np.ndarray, left: np.ndarray,
                   corner: int, has_top: bool, has_left: bool,
                   size: int) -> np.ndarray:
    """The 16x16 luma or 8x8 chroma prediction (DC with libwebp's edge
    variants, TM, V, H)."""
    if mode == DC_PRED:
        shift = 4 if size == 16 else 3
        if has_top and has_left:
            dc = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_left:
            dc = (int(left.sum()) + size // 2) >> shift
        elif has_top:
            dc = (int(top.sum()) + size // 2) >> shift
        else:
            dc = 128
        return np.full((size, size), dc, np.int64)
    if mode == V_PRED:
        return np.broadcast_to(top[None, :], (size, size))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size))
    return np.clip(top[None, :] + left[:, None] - corner, 0, 255)


def reconstruct(fr: Frame):
    """Prediction plus residual for every macroblock, in raster order, on
    the unfiltered frame.  Returns the Y, U, V planes at the macroblock-
    aligned size (int64)."""
    mbw, mbh = fr.mbw, fr.mbh
    n = mbw * mbh
    coef = np.array(fr.coeffs, np.int64).astype(np.int16).reshape(n, 24, 16)
    y2 = np.array(fr.y2, np.int64).astype(np.int16).reshape(n, 16)
    i16 = ~fr.is_i4
    if i16.any():
        coef[i16, :16, 0] = inverse_wht(y2[i16]).astype(np.int16)
    res = inverse_dct(coef.reshape(-1, 16)).reshape(n, 24, 4, 4)
    ry = res[:, :16].reshape(mbh, mbw, 4, 4, 4, 4).transpose(
        0, 2, 4, 1, 3, 5).reshape(16 * mbh, 16 * mbw)
    ruv = [res[:, 16 + 4 * c:20 + 4 * c].reshape(mbh, mbw, 2, 2, 4, 4)
           .transpose(0, 2, 4, 1, 3, 5).reshape(8 * mbh, 8 * mbw)
           for c in range(2)]
    # planes with a top border row (127) and a left border column (129);
    # luma has four more columns for the last column's top-right samples
    Y = np.empty((16 * mbh + 1, 16 * mbw + 5), np.int64)
    Y[0] = 127
    Y[1:, 0] = 129
    UV = []
    for _ in range(2):
        P = np.empty((8 * mbh + 1, 8 * mbw + 1), np.int64)
        P[0] = 127
        P[1:, 0] = 129
        UV.append(P)
    clip = _CLIP
    ymodes = fr.ymodes.tolist()
    for mby in range(mbh):
        y0 = 16 * mby + 1
        if mby > 0:      # the last column's top-right: its top sample 15
            Y[y0 - 1, 16 * mbw + 1:] = Y[y0 - 1, 16 * mbw]
        for mbx in range(mbw):
            m = mby * mbw + mbx
            x0 = 16 * mbx + 1
            if fr.is_i4[m]:
                tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
                modes = ymodes[m]
                for sy in range(4):
                    py = y0 + 4 * sy
                    for sx in range(4):
                        px = x0 + 4 * sx
                        if sx == 3:
                            top = Y[py - 1, px - 1:px + 4].tolist() + tr
                        else:
                            top = Y[py - 1, px - 1:px + 8].tolist()
                        left = Y[py:py + 4, px - 1].tolist()
                        pred = predict4(modes[4 * sy + sx], top, left)
                        r = ry[py - 1:py + 3, px - 1:px + 3].ravel().tolist()
                        Y[py:py + 4, px:px + 4] = np.array(
                            [clip[512 + p + q] for p, q in zip(pred, r)],
                            np.int64).reshape(4, 4)
            else:
                pred = _predict_block(
                    ymodes[m][0], Y[y0 - 1, x0:x0 + 16],
                    Y[y0:y0 + 16, x0 - 1], int(Y[y0 - 1, x0 - 1]),
                    mby > 0, mbx > 0, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(
                    pred + ry[y0 - 1:y0 + 15, x0 - 1:x0 + 15], 0, 255)
            c0, cx0 = 8 * mby + 1, 8 * mbx + 1
            for P, R in zip(UV, ruv):
                pred = _predict_block(
                    int(fr.uvmode[m]), P[c0 - 1, cx0:cx0 + 8],
                    P[c0:c0 + 8, cx0 - 1], int(P[c0 - 1, cx0 - 1]),
                    mby > 0, mbx > 0, 8)
                P[c0:c0 + 8, cx0:cx0 + 8] = np.clip(
                    pred + R[c0 - 1:c0 + 7, cx0 - 1:cx0 + 7], 0, 255)
    # libwebp's non-zero bits (NzCodeBits): a block with tokens past its
    # first position or a nonzero DC
    nz = np.array(fr.nz, np.int64).reshape(n, 24)
    nonzero = ((nz > 1) | (coef[:, :, 0] != 0)).any(1)
    return (np.ascontiguousarray(Y[1:, 1:16 * mbw + 1]),
            np.ascontiguousarray(UV[0][1:, 1:]),
            np.ascontiguousarray(UV[1][1:, 1:]), nonzero & ~fr.skip)


# ---------------------------------------------------------------------------
# the loop filter

def filter_strengths(hdr: FrameHeader):
    """PrecomputeFilterStrengths: (limit, ilevel, hev threshold) for
    [segment][i4x4]."""
    out = [[None, None] for _ in range(4)]
    for s in range(4):
        if hdr.use_segment:
            base = hdr.seg_filter[s]
            if not hdr.absolute_delta:
                base += hdr.level
        else:
            base = hdr.level
        for i4 in range(2):
            level = base
            if hdr.use_lf_delta:
                level += hdr.ref_lf_delta[0]
                if i4:
                    level += hdr.mode_lf_delta[0]
            level = _clip(level, 63)
            if level > 0:
                ilevel = level
                if hdr.sharpness > 0:
                    ilevel >>= 2 if hdr.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - hdr.sharpness)
                ilevel = max(ilevel, 1)
                hev = 2 if level >= 40 else 1 if level >= 15 else 0
                out[s][i4] = (2 * level + ilevel, ilevel, hev)
            else:
                out[s][i4] = (0, 0, 0)
    return out


def _edge_lines(stride: int, size: int, vertical_edge: bool, off: int):
    """Flat offsets [size lines, 8 samples p3..q3] of one edge relative to
    its block's origin: a vertical edge at column `off` (filtered along
    rows) or a horizontal edge at row `off`."""
    k = np.arange(-4, 4)
    i = np.arange(size)
    if vertical_edge:
        return i[:, None] * stride + off + k[None, :]
    return (off + k[None, :]) * stride + i[:, None]


def _filter_lines(v, thresh2, ilevel, hev_t, mode):
    """One edge's filter on lines v [n, 8] (p3..q3): mode 'simple'
    (DoFilter2 where NeedsFilter), 'mb' (FilterLoop26) or 'inner'
    (FilterLoop24).  Returns the filtered lines."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (v[:, i] for i in range(8))
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    out = v.copy()
    if mode == "simple":
        f2 = need
    else:
        it = ilevel
        need &= (np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) \
            & (np.abs(p1 - p0) <= it) & (np.abs(q3 - q2) <= it) \
            & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it)
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        f2 = need & hev
        rest = need & ~hev
        if mode == "mb":
            a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127),
                        -128, 127)
            a1 = (27 * a + 63) >> 7
            a2 = (18 * a + 63) >> 7
            a3 = (9 * a + 63) >> 7
            upd = [(1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1),
                   (5, q1 - a2), (6, q2 - a3)]
        else:
            a = 3 * (q0 - p0)
            a1 = np.clip((a + 4) >> 3, -16, 15)
            a2 = np.clip((a + 3) >> 3, -16, 15)
            a3 = (a1 + 1) >> 1
            upd = [(2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)]
        for col, val in upd:
            out[:, col] = np.where(rest, np.clip(val, 0, 255), out[:, col])
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    out[:, 3] = np.where(f2, np.clip(p0 + a2, 0, 255), out[:, 3])
    out[:, 4] = np.where(f2, np.clip(q0 - a1, 0, 255), out[:, 4])
    return out


def loop_filter(fr: Frame, Y, U, V, nonzero) -> None:
    """libwebp's DoFilter for every macroblock in raster order, in place
    (simple: luma only), vectorised over the wavefronts mbx + 2 * mby."""
    hdr = fr.hdr
    filter_type = 0 if hdr.level == 0 else 1 if hdr.simple else 2
    if filter_type == 0:
        return
    mbw, mbh = fr.mbw, fr.mbh
    strengths = filter_strengths(hdr)
    n = mbw * mbh
    params = np.array([strengths[s][int(i4)] for s, i4 in
                       zip(fr.segment.tolist(), fr.is_i4.tolist())],
                      np.int64).reshape(n, 3)
    limit, ilevel, hev = params[:, 0], params[:, 1], params[:, 2]
    inner = fr.is_i4 | nonzero
    mbx = np.tile(np.arange(mbw), mbh)
    mby = np.repeat(np.arange(mbh), mbw)
    planes = [(Y, 16)] if filter_type == 1 else [(Y, 16), (U, 8), (V, 8)]
    wave = mbx + 2 * mby
    for P, size in planes:
        stride = P.shape[1]
        flat = P.reshape(-1)
        origin = mby * size * stride + mbx * size
        inner_offs = (4, 8, 12) if size == 16 else (4,)
        # (vertical edge?, offset, MB edge?) in libwebp's order
        steps = [(True, 0, True)] + [(True, o, False) for o in inner_offs] \
            + [(False, 0, True)] + [(False, o, False) for o in inner_offs]
        rel = [_edge_lines(stride, size, ve, off) for ve, off, _ in steps]
        active = []
        for ve, off, mb in steps:
            a = limit > 0
            if mb:
                a &= (mbx > 0) if ve else (mby > 0)
            else:
                a &= inner
            active.append(a)
        order = np.argsort(wave, kind="stable")
        bounds = np.searchsorted(wave[order], np.arange(wave.max() + 2))
        for w in range(wave.max() + 1):
            mbs = order[bounds[w]:bounds[w + 1]]
            for k, (ve, off, mb) in enumerate(steps):
                sel = mbs[active[k][mbs]]
                if not len(sel):
                    continue
                idx = (origin[sel][:, None, None] + rel[k][None]).reshape(
                    -1, 8)
                t = limit[sel] + (4 if mb else 0)
                rep = rel[k].shape[0]
                mode = "simple" if filter_type == 1 else (
                    "mb" if mb else "inner")
                flat[idx] = _filter_lines(
                    flat[idx], np.repeat(2 * t + 1, rep),
                    np.repeat(ilevel[sel], rep), np.repeat(hev[sel], rep),
                    mode)


# ---------------------------------------------------------------------------
# output: fancy upsampling (upsampling.c) and YUV -> RGB (yuv.h)

def upsample_rows(near: np.ndarray, far: np.ndarray, width: int):
    """UpsampleRgbaLinePair's chroma for one output row: `near` and `far`
    chroma rows [..., (width + 1) // 2] -> [..., width]."""
    n = near.astype(np.int64)
    f = far.astype(np.int64)
    out = np.empty(n.shape[:-1] + (width,), np.int64)
    out[..., 0] = (3 * n[..., 0] + f[..., 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        tl, t = n[..., :pairs], n[..., 1:pairs + 1]
        fl, fr_ = f[..., :pairs], f[..., 1:pairs + 1]
        avg = tl + t + fl + fr_ + 8
        out[..., 1:2 * pairs:2] = (((avg + 2 * (t + fl)) >> 3) + tl) >> 1
        out[..., 2:2 * pairs + 1:2] = (((avg + 2 * (tl + fr_)) >> 3) + t) >> 1
    if not width & 1:
        last = (width >> 1) - 1
        out[..., width - 1] = (3 * n[..., last] + f[..., last] + 2) >> 2
    return out


def upsample_chroma(plane: np.ndarray, width: int, height: int):
    """A cropped chroma plane [(height + 1) // 2, (width + 1) // 2] ->
    [height, width] as EmitFancyRGB pairs the rows."""
    ch = (height + 1) >> 1
    r = np.arange(height)
    near = np.where(r & 1, (r - 1) >> 1, r >> 1)
    far = np.where(r == 0, 0, np.where(r & 1, np.minimum((r + 1) >> 1,
                                                          ch - 1),
                                       (r >> 1) - 1))
    return upsample_rows(plane[near], plane[far], width)


def _mult_hi(v, c):
    return (v * c) >> 8


def yuv_to_rgb(y, u, v) -> np.ndarray:
    """VP8YuvToRgb on full-resolution planes -> uint8 [..., 3]."""
    y = y.astype(np.int64)
    yy = _mult_hi(y, 19077)
    r = yy + _mult_hi(v, 26149) - 14234
    g = yy - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708
    b = yy + _mult_hi(u, 33050) - 17685
    return np.clip(np.stack([r, g, b], -1) >> 6, 0, 255).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """The payload of a `VP8 ` chunk -> uint8 [H, W, 3] RGB (libwebp's
    default decode: the loop filter, fancy upsampling, no dithering)."""
    fr = parse_frame(data)
    Y, U, V, nonzero = reconstruct(fr)
    loop_filter(fr, Y, U, V, nonzero)
    w, h = fr.hdr.width, fr.hdr.height
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    return yuv_to_rgb(Y[:h, :w], upsample_chroma(U[:ch, :cw], w, h),
                      upsample_chroma(V[:ch, :cw], w, h))
