"""JPEG 2000 codestream syntax (ITU-T T.800 Annex A) and the geometry of
tiles, components, resolutions, sub-bands, precincts and code-blocks
(Annex B), as OpenJPEG 2.5 reads them.

`parse(data)` reads the main header and every tile-part: SIZ, COD, COC,
QCD, QCC, RGN, POC, PPM, PPT, TLM, PLM, PLT, CRG and COM, then SOT / SOD
/ EOC.  As in OpenJPEG, a COD or QCD sets every component (of the main
header's defaults, or of its tile) and a later COC or QCC one component;
a tile starts from the main header's settings; the POC entries of a
tile-part header follow those of the main header.  A CAP marker (HTJ2K,
Part 15) and the Part 2 markers raise NotImplementedError naming them.

`tile_layout(cs, tile)` gives each component's resolutions, sub-bands,
precincts and code-blocks in reference-grid terms (Annex B.5-B.7), with
image and tile offsets, as OpenJPEG's `opj_tcd_init_tile` places them.
"""
from __future__ import annotations

import copy
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# progression orders of SGcod / Ppoc
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
# the code-block style bits of SPcod / SPcoc
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM, HT = 1, 2, 4, 8, 16, 32, 64
_PART2 = {0xFF50: "CAP (HTJ2K, Part 15)", 0xFF59: "CPF (Part 15)",
          0xFF74: "MCT (Part 2)", 0xFF75: "MCC (Part 2)",
          0xFF77: "MCO (Part 2)", 0xFF78: "CBD (Part 2)",
          0xFF70: "DCO (Part 2)", 0xFF71: "VMS (Part 2)",
          0xFF72: "DFS (Part 2)", 0xFF73: "ADS (Part 2)",
          0xFF79: "ATK (Part 2)", 0xFF76: "NLT (Part 2)"}


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class Component:
    prec: int
    sgnd: bool
    dx: int
    dy: int


@dataclass
class CodingStyle:
    """One component's COD / COC parameters."""
    levels: int = 0
    xcb: int = 6
    ycb: int = 6
    style: int = 0
    reversible: bool = True           # 5/3 (1) or 9/7 (0)
    precincts: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class Quantization:
    """One component's QCD / QCC: style 0 (none), 1 (scalar derived) or 2
    (scalar expounded), guard bits, (exponent, mantissa) per sub-band in
    the order LL, then HL / LH / HH from the lowest resolution up."""
    style: int = 0
    guard: int = 2
    steps: List[Tuple[int, int]] = field(default_factory=list)

    def step(self, index: int) -> Tuple[int, int]:
        if self.style == 1:                  # derived from the LL's
            e, m = self.steps[0]
            return max(e - (index - 1) // 3, 0) if index else e, m
        if index >= len(self.steps):
            raise ValueError(f"JPEG 2000: no quantization step for sub-band "
                             f"{index}")
        return self.steps[index]


@dataclass
class Poc:
    res0: int
    comp0: int
    lay1: int
    res1: int
    comp1: int
    order: int


@dataclass
class TileParams:
    sop: bool = False
    eph: bool = False
    order: int = 0
    layers: int = 1
    mct: int = 0
    cod: List[CodingStyle] = field(default_factory=list)
    qcd: List[Quantization] = field(default_factory=list)
    roi: List[int] = field(default_factory=list)
    pocs: List[Poc] = field(default_factory=list)


@dataclass
class Tile:
    params: TileParams
    data: bytearray = field(default_factory=bytearray)
    headers: bytearray = field(default_factory=bytearray)   # PPM / PPT
    packed: bool = False
    ppt: List[Tuple[int, bytes]] = field(default_factory=list)


@dataclass
class Codestream:
    xsiz: int
    ysiz: int
    xosiz: int
    yosiz: int
    xtsiz: int
    ytsiz: int
    xtosiz: int
    ytosiz: int
    comps: List[Component]
    default: TileParams
    tiles: Dict[int, Tile] = field(default_factory=dict)

    @property
    def tiles_across(self) -> int:
        return ceildiv(self.xsiz - self.xtosiz, self.xtsiz)

    @property
    def tiles_down(self) -> int:
        return ceildiv(self.ysiz - self.ytosiz, self.ytsiz)


def _siz(seg: bytes):
    (_, _, xsiz, ysiz, xo, yo, xt, yt, xto, yto, n) = struct.unpack_from(
        ">HHIIIIIIIIH", seg)
    if len(seg) < 38 + 3 * n or n == 0:
        raise ValueError("JPEG 2000: a truncated SIZ marker")
    comps = []
    for c in range(n):
        s, dx, dy = seg[38 + 3 * c:41 + 3 * c]
        if dx == 0 or dy == 0:
            raise ValueError("JPEG 2000: a component subsampling of 0")
        comps.append(Component((s & 0x7F) + 1, bool(s & 0x80), dx, dy))
    if xt == 0 or yt == 0 or xsiz <= xo or ysiz <= yo or xto > xo or \
            yto > yo or xto + xt <= xo or yto + yt <= yo:
        raise ValueError("JPEG 2000: an inconsistent SIZ marker")
    return xsiz, ysiz, xo, yo, xt, yt, xto, yto, comps


def _spcod(seg: bytes, pos: int, with_precincts: bool) -> CodingStyle:
    if len(seg) < pos + 5:
        raise ValueError("JPEG 2000: a truncated COD / COC marker")
    levels, xcb, ycb, style, transform = seg[pos:pos + 5]
    if levels > 32:
        raise ValueError(f"JPEG 2000: {levels} decomposition levels")
    xcb, ycb = xcb + 2, ycb + 2
    if xcb > 10 or ycb > 10 or xcb + ycb > 12:
        raise ValueError(f"JPEG 2000: code-blocks of 2^{xcb} x 2^{ycb}")
    if style & HT:
        raise NotImplementedError(
            "JPEG 2000: HTJ2K code-blocks (COD style bit 6, Part 15); the "
            "port decodes the Part 1 block coder only")
    if style & 0x80:
        raise NotImplementedError(
            f"JPEG 2000: code-block style {style:#04x} (reserved bit 7)")
    if transform not in (0, 1):
        raise NotImplementedError(
            f"JPEG 2000: wavelet transform {transform} (Part 2 kernels); "
            "the port reads the 9/7 (0) and 5/3 (1) transforms only")
    if with_precincts:
        raw = seg[pos + 5:pos + 5 + levels + 1]
        if len(raw) < levels + 1:
            raise ValueError("JPEG 2000: a truncated precinct list")
        prec = [(b & 15, b >> 4) for b in raw]
    else:
        prec = [(15, 15)] * (levels + 1)
    return CodingStyle(levels, xcb, ycb, style, transform == 1, prec)


def _sqcd(seg: bytes, pos: int) -> Quantization:
    s = seg[pos]
    style, guard = s & 31, s >> 5
    body = seg[pos + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in body]
    elif style in (1, 2):
        if len(body) < 2:
            raise ValueError("JPEG 2000: a truncated QCD / QCC marker")
        steps = [(v >> 11, v & 0x7FF) for v in struct.unpack_from(
            f">{len(body) // 2}H", body)]
        if style == 1:
            steps = steps[:1]
    else:
        raise ValueError(f"JPEG 2000: quantization style {style}")
    return Quantization(style, guard, steps)


def _comp_index(seg: bytes, pos: int, ncomp: int) -> Tuple[int, int]:
    if ncomp < 257:
        return seg[pos], pos + 1
    return struct.unpack_from(">H", seg, pos)[0], pos + 2


def _apply(marker: int, seg: bytes, p: TileParams, ncomp: int) -> None:
    """A COD, COC, QCD, QCC, RGN or POC marker segment onto `p`."""
    if marker == 0xFF52:                                    # COD
        scod = seg[2]
        order, layers, mct = seg[3], struct.unpack_from(">H", seg, 4)[0], \
            seg[6]
        if order > 4:
            raise ValueError(f"JPEG 2000: progression order {order}")
        if layers == 0:
            raise ValueError("JPEG 2000: 0 quality layers")
        if mct > 1:
            raise NotImplementedError(
                f"JPEG 2000: multiple component transform {mct} (Part 2)")
        p.sop, p.eph = bool(scod & 2), bool(scod & 4)
        p.order, p.layers, p.mct = order, layers, mct
        cs = _spcod(seg, 7, bool(scod & 1))
        p.cod = [copy.deepcopy(cs) for _ in range(ncomp)]
    elif marker == 0xFF53:                                  # COC
        c, pos = _comp_index(seg, 2, ncomp)
        if c >= ncomp:
            raise ValueError(f"JPEG 2000: COC of component {c}")
        p.cod[c] = _spcod(seg, pos + 1, bool(seg[pos] & 1))
    elif marker == 0xFF5C:                                  # QCD
        q = _sqcd(seg, 2)
        p.qcd = [copy.deepcopy(q) for _ in range(ncomp)]
    elif marker == 0xFF5D:                                  # QCC
        c, pos = _comp_index(seg, 2, ncomp)
        if c >= ncomp:
            raise ValueError(f"JPEG 2000: QCC of component {c}")
        p.qcd[c] = _sqcd(seg, pos)
    elif marker == 0xFF5E:                                  # RGN
        c, pos = _comp_index(seg, 2, ncomp)
        if c >= ncomp:
            raise ValueError(f"JPEG 2000: RGN of component {c}")
        if seg[pos] != 0:
            raise NotImplementedError(
                f"JPEG 2000: ROI style {seg[pos]} (Part 2); the port reads "
                "the max-shift ROI of Part 1")
        p.roi[c] = seg[pos + 1]
    elif marker == 0xFF5F:                                  # POC
        wide = ncomp >= 257
        size = 9 if wide else 7
        n = (len(seg) - 2) // size
        if n == 0 or (len(seg) - 2) % size:
            raise ValueError("JPEG 2000: a POC marker of a bad length")
        fmt = ">BHHBHB" if wide else ">BBHBBB"
        for i in range(n):
            r0, c0, l1, r1, c1, order = struct.unpack_from(
                fmt, seg, 2 + i * size)
            if order > 4:
                raise ValueError(f"JPEG 2000: POC progression order {order}")
            # OpenJPEG reads CEpoc 0 as 0 (not as 256) and bounds the
            # layer and component ends
            p.pocs.append(Poc(r0, c0, min(l1, p.layers), r1,
                              min(c1, ncomp), order))


def parse(data: bytes) -> Codestream:
    """The main header and every tile-part of a codestream."""
    if data[:4] != b"\xff\x4f\xff\x51":
        raise ValueError("JPEG 2000: no SOC / SIZ at the codestream start")
    pos = 2
    lsiz, = struct.unpack_from(">H", data, pos + 2)
    (xsiz, ysiz, xo, yo, xt, yt, xto, yto, comps) = _siz(
        data[pos + 2:pos + 2 + lsiz])
    n = len(comps)
    default = TileParams(roi=[0] * n)
    cs = Codestream(xsiz, ysiz, xo, yo, xt, yt, xto, yto, comps, default)
    pos += 2 + lsiz
    ppm: Dict[int, bytes] = {}
    seen_cod = seen_qcd = False
    # the main header
    while True:
        if pos + 2 > len(data):
            raise ValueError("JPEG 2000: the main header has no end")
        marker, = struct.unpack_from(">H", data, pos)
        if marker == 0xFF90:
            break
        if marker == 0xFFD9:
            raise ValueError("JPEG 2000: a codestream without tiles")
        if marker in _PART2:
            raise NotImplementedError(
                f"JPEG 2000: a {_PART2[marker]} marker; the port decodes "
                "Part 1 codestreams only (OpenJPEG 2.5 also decodes HTJ2K)")
        if marker >> 8 != 0xFF or marker < 0xFF30:
            raise ValueError(f"JPEG 2000: {marker:#06x} is not a marker")
        length, = struct.unpack_from(">H", data, pos + 2)
        seg = data[pos + 2:pos + 2 + length]
        if len(seg) < length or length < 2:
            raise ValueError("JPEG 2000: a truncated marker segment")
        if marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
            if marker == 0xFF53 and not seen_cod or \
                    marker == 0xFF5D and not seen_qcd:
                raise ValueError("JPEG 2000: COC / QCC before COD / QCD")
            _apply(marker, seg, default, n)
            seen_cod |= marker == 0xFF52
            seen_qcd |= marker == 0xFF5C
        elif marker == 0xFF60:                              # PPM
            ppm[seg[2]] = seg[3:]
        # TLM, PLM, CRG, COM and the markers OpenJPEG skips: nothing to do
        pos += 2 + length
    if not seen_cod or not seen_qcd:
        raise ValueError("JPEG 2000: a main header without COD or QCD")
    ppm_data = b"".join(ppm[k] for k in sorted(ppm)) if ppm else None
    ppm_pos = 0
    # the tile-parts
    ntiles = cs.tiles_across * cs.tiles_down
    while pos + 2 <= len(data):
        marker, = struct.unpack_from(">H", data, pos)
        if marker == 0xFFD9:
            break
        if marker != 0xFF90:
            raise ValueError(f"JPEG 2000: marker {marker:#06x} where a "
                             "tile-part starts")
        _, isot, psot = struct.unpack_from(">HHI", data, pos + 2)
        if isot >= ntiles:
            raise ValueError(f"JPEG 2000: tile {isot} of {ntiles}")
        start = pos
        end = len(data) if psot == 0 else start + psot
        if psot == 0 and data[-2:] == b"\xff\xd9":
            end = len(data) - 2
        if end > len(data):
            raise ValueError("JPEG 2000: a tile-part past the codestream")
        tile = cs.tiles.get(isot)
        if tile is None:
            tile = cs.tiles[isot] = Tile(copy.deepcopy(default))
        pos += 12
        while True:
            if pos + 2 > end:
                raise ValueError("JPEG 2000: a tile-part header without SOD")
            marker, = struct.unpack_from(">H", data, pos)
            if marker == 0xFF93:
                pos += 2
                break
            if marker in _PART2:
                raise NotImplementedError(
                    f"JPEG 2000: a {_PART2[marker]} marker; the port decodes "
                    "Part 1 codestreams only")
            length, = struct.unpack_from(">H", data, pos + 2)
            seg = data[pos + 2:pos + 2 + length]
            if marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
                _apply(marker, seg, tile.params, n)
            elif marker == 0xFF61:                          # PPT
                tile.ppt.append((seg[2], seg[3:]))
            pos += 2 + length
        if ppm_data is not None:
            if ppm_pos + 4 > len(ppm_data):
                raise ValueError("JPEG 2000: PPM holds no headers for a "
                                 "tile-part")
            nppm, = struct.unpack_from(">I", ppm_data, ppm_pos)
            tile.headers += ppm_data[ppm_pos + 4:ppm_pos + 4 + nppm]
            tile.packed = True
            ppm_pos += 4 + nppm
        tile.data += data[pos:end]
        pos = end
    for tile in cs.tiles.values():
        if tile.ppt:
            if ppm_data is not None:
                raise ValueError("JPEG 2000: both PPM and PPT")
            tile.headers = bytearray(b"".join(
                d for _, d in sorted(tile.ppt, key=lambda z: z[0])))
            tile.packed = True
    return cs


# ---------------------------------------------------------------------------
# geometry


@dataclass
class CodeBlock:
    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    numbps: int = 0
    lenbits: int = 3
    segs: List[list] = field(default_factory=list)   # [maxpasses, passes,
    data: bytearray = field(default_factory=bytearray)  # length]


@dataclass
class Precinct:
    """One band's part of a precinct: its code-blocks, cw across."""
    cw: int
    ch: int
    blocks: List[CodeBlock]
    incl: object = None
    imsb: object = None


@dataclass
class Band:
    index: int                  # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    numbps: int
    step: Tuple[int, int]
    precincts: List[Precinct] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return self.x0 >= self.x1 or self.y0 >= self.y1


@dataclass
class Resolution:
    x0: int
    y0: int
    x1: int
    y1: int
    pdx: int
    pdy: int
    pw: int
    ph: int
    bands: List[Band]


@dataclass
class TileComponent:
    x0: int
    y0: int
    x1: int
    y1: int
    resolutions: List[Resolution]


def tile_bounds(cs: Codestream, t: int) -> Tuple[int, int, int, int]:
    p, q = t % cs.tiles_across, t // cs.tiles_across
    return (max(cs.xtosiz + p * cs.xtsiz, cs.xosiz),
            max(cs.ytosiz + q * cs.ytsiz, cs.yosiz),
            min(cs.xtosiz + (p + 1) * cs.xtsiz, cs.xsiz),
            min(cs.ytosiz + (q + 1) * cs.ytsiz, cs.ysiz))


def _ceilpow2(a: int, e: int) -> int:
    return -((-a) >> e)


def tile_layout(cs: Codestream, t: int, params: TileParams
                ) -> List[TileComponent]:
    tx0, ty0, tx1, ty1 = tile_bounds(cs, t)
    out = []
    for c, comp in enumerate(cs.comps):
        cod, qcd = params.cod[c], params.qcd[c]
        tcx0, tcy0 = ceildiv(tx0, comp.dx), ceildiv(ty0, comp.dy)
        tcx1, tcy1 = ceildiv(tx1, comp.dx), ceildiv(ty1, comp.dy)
        nres = cod.levels + 1
        if len(cod.precincts) < nres:
            raise ValueError("JPEG 2000: fewer precinct sizes than "
                             "resolutions")
        res_list = []
        for r in range(nres):
            level = nres - 1 - r
            rx0, ry0 = _ceilpow2(tcx0, level), _ceilpow2(tcy0, level)
            rx1, ry1 = _ceilpow2(tcx1, level), _ceilpow2(tcy1, level)
            pdx, pdy = cod.precincts[r]
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            px1, py1 = _ceilpow2(rx1, pdx) << pdx, _ceilpow2(ry1, pdy) << pdy
            pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
            ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
            if r == 0:
                cbgx0, cbgy0, cbgw, cbgh = px0, py0, pdx, pdy
                kinds = [0]
            else:
                cbgx0, cbgy0 = _ceilpow2(px0, 1), _ceilpow2(py0, 1)
                cbgw, cbgh = pdx - 1, pdy - 1
                kinds = [1, 2, 3]
            if cbgw < 0 or cbgh < 0:
                raise ValueError("JPEG 2000: a precinct size of 1 above "
                                 "resolution 0")
            cbw, cbh = min(cod.xcb, cbgw), min(cod.ycb, cbgh)
            bands = []
            for b in kinds:
                if b == 0:
                    bx0, by0 = _ceilpow2(tcx0, level), _ceilpow2(tcy0, level)
                    bx1, by1 = _ceilpow2(tcx1, level), _ceilpow2(tcy1, level)
                    index = 0
                else:
                    xob, yob = b & 1, b >> 1
                    bx0 = _ceilpow2(tcx0 - (xob << level), level + 1)
                    by0 = _ceilpow2(tcy0 - (yob << level), level + 1)
                    bx1 = _ceilpow2(tcx1 - (xob << level), level + 1)
                    by1 = _ceilpow2(tcy1 - (yob << level), level + 1)
                    index = 3 * (r - 1) + b
                expn, mant = qcd.step(index)
                band = Band(b, bx0, by0, bx1, by1, expn + qcd.guard - 1,
                            (expn, mant))
                for k in range(pw * ph):
                    gx0 = cbgx0 + (k % pw) * (1 << cbgw)
                    gy0 = cbgy0 + (k // pw) * (1 << cbgh)
                    qx0, qy0 = max(gx0, bx0), max(gy0, by0)
                    qx1 = min(gx0 + (1 << cbgw), bx1)
                    qy1 = min(gy0 + (1 << cbgh), by1)
                    cx0 = (qx0 >> cbw) << cbw
                    cy0 = (qy0 >> cbh) << cbh
                    cw = max(0, ((_ceilpow2(qx1, cbw) << cbw) - cx0) >> cbw)
                    ch = max(0, ((_ceilpow2(qy1, cbh) << cbh) - cy0) >> cbh)
                    blocks = []
                    for j in range(cw * ch):
                        x = cx0 + (j % cw) * (1 << cbw)
                        y = cy0 + (j // cw) * (1 << cbh)
                        blocks.append(CodeBlock(
                            max(x, qx0), max(y, qy0),
                            min(x + (1 << cbw), qx1),
                            min(y + (1 << cbh), qy1)))
                    band.precincts.append(Precinct(cw, ch, blocks))
                bands.append(band)
            res_list.append(Resolution(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph,
                                       bands))
        out.append(TileComponent(tcx0, tcy0, tcx1, tcy1, res_list))
    return out
