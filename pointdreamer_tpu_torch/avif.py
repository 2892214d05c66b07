"""AVIF: the ISOBMFF / HEIF container as libavif 1.3 reads it, and the
image PIL 12.1's AvifImagePlugin gives (`Image.open(path)`, then
`convert("RGB")` or `convert("RGBA")`).

The boxes read: `ftyp`; `meta` with `hdlr`, `pitm`, `iloc` (versions 0-2,
construction methods 0 and 1 with `idat`), `iinf` / `infe`, `iref`
(`auxl`, `prem`, `dimg`, `cdsc`), `iprp` / `ipco` / `ipma` and the item
properties `ispe`, `pixi`, `av1C`, `colr` (nclx and ICC), `auxC`, `clap`,
`irot`, `imir`, `a1op`, `lsel`, `a1lx`; `grid` derived items; and for an
`avis` sequence, `moov` / `trak` down to its first sample (`stsd` / `av01`,
`stsz`, `stsc`, `stco` / `co64`).  The first frame is decoded
(`av1_decoder`) and converted to 8-bit RGB or RGBA as PIL asks libavif
(`avif_rgb`); `irot`, `imir` and `clap` are not applied to the pixels,
as PIL does not apply them (EXIF orientation is only reported).

Where libavif's parse fails with a result PIL turns into SyntaxError
(invalid ftyp, a BMFF parse failure, truncated data, no content), the
probe raises `NotThisFormat`, so the walk goes on to PIL's next plugin;
an AV1 fault raises at decode (RuntimeError, as PIL raises it).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .imagemode import NotThisFormat, of_array

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")


class AvifParseError(NotThisFormat):
    """libavif's parse failed the way PIL reports as SyntaxError."""


class AvifDecodeError(RuntimeError):
    """libavif's decode failed (PIL raises RuntimeError)."""


def _boxes(data: bytes, start: int, end: int):
    pos = start
    while pos < end:
        if end - pos < 8 and start == 0:
            break
        if pos + 8 > end:
            raise AvifParseError("AVIF: truncated box header")
        size, kind = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                raise AvifParseError("AVIF: truncated box header")
            size, = struct.unpack_from(">Q", data, pos + 8)
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            raise AvifParseError("AVIF: box %r runs past its parent" % kind)
        yield kind, pos + hdr, pos + size
        pos += size


def _full(data, pos):
    v = data[pos]
    flags = int.from_bytes(data[pos + 1:pos + 4], "big")
    return v, flags, pos + 4


def _uint(data, pos, n):
    if n == 0:
        return 0, pos
    return int.from_bytes(data[pos:pos + n], "big"), pos + n


@dataclass
class Item:
    id: int
    type: bytes = b""
    extents: list = field(default_factory=list)
    construction: int = 0
    props: list = field(default_factory=list)    # (box type, payload, ess.)
    refs: dict = field(default_factory=dict)     # ref type -> [to ids]

    def prop(self, kind):
        for k, payload, _ in self.props:
            if k == kind:
                return payload
        return None


@dataclass
class AvifFile:
    major: bytes
    items: dict
    primary: int
    idat: bytes
    data: bytes
    tracks: list


def parse(data: bytes) -> AvifFile:
    """The top-level boxes and the meta box, as libavif's avifParse."""
    data = bytes(data)
    major, brands = None, []
    meta = None
    moov = None
    first = True
    for kind, s, e in _boxes(data, 0, len(data)):
        if first and kind != b"ftyp":
            raise AvifParseError("AVIF: no ftyp box first")
        first = False
        if kind == b"ftyp":
            if e - s < 8 or (e - s) % 4:
                raise AvifParseError("AVIF: bad ftyp")
            major = data[s:s + 4]
            brands = [data[i:i + 4] for i in range(s + 8, e, 4)]
            if b"avif" not in [major] + brands and \
                    b"avis" not in [major] + brands:
                raise AvifParseError("AVIF: ftyp names no avif / avis brand")
        elif kind == b"meta":
            if meta is not None:
                raise AvifParseError("AVIF: two meta boxes")
            meta = (s, e)
        elif kind == b"moov":
            moov = (s, e)
        if major is not None and meta is not None and (
                moov is not None or major != b"avis"):
            break               # libavif stops once it has what it needs
    if major is None:
        raise AvifParseError("AVIF: no ftyp box")
    items, primary, idat = {}, None, b""
    if meta is not None:
        items, primary, idat = _parse_meta(data, *meta)
    tracks = _parse_moov(data, *moov) if moov is not None else []
    # libavif's source AUTO: the ftyp's major brand decides, else tracks
    use_tracks = bool(tracks) and (major == b"avis" or major != b"avif")
    if not use_tracks and (primary is None or primary not in items):
        raise AvifParseError("AVIF: no primary item")
    return AvifFile(major, items, primary, idat, data,
                    tracks if use_tracks else [])


def _parse_meta(data, s, e):
    v, _, pos = _full(data, s)
    if v != 0:
        raise AvifParseError("AVIF: meta version %d" % v)
    items = {}
    primary = None
    idat = b""
    hdlr_ok = False
    props = []
    assoc = []
    for kind, bs, be in _boxes(data, pos, e):
        if kind == b"hdlr":
            _, _, p = _full(data, bs)
            if data[p + 4:p + 8] != b"pict":
                raise AvifParseError("AVIF: meta handler is not pict")
            hdlr_ok = True
        elif kind == b"pitm":
            ver, _, p = _full(data, bs)
            primary, _ = _uint(data, p, 2 if ver == 0 else 4)
        elif kind == b"iloc":
            _parse_iloc(data, bs, be, items)
        elif kind == b"iinf":
            ver, _, p = _full(data, bs)
            _, p = _uint(data, p, 2 if ver == 0 else 4)
            for k2, s2, e2 in _boxes(data, p, be):
                if k2 != b"infe":
                    continue
                iv, _, q = _full(data, s2)
                if iv < 2:
                    raise AvifParseError("AVIF: infe version %d" % iv)
                iid, q = _uint(data, q, 2 if iv == 2 else 4)
                q += 2
                it = items.setdefault(iid, Item(iid))
                it.type = data[q:q + 4]
        elif kind == b"iref":
            ver, _, p = _full(data, bs)
            n = 2 if ver == 0 else 4
            for k2, s2, e2 in _boxes(data, p, be):
                frm, q = _uint(data, s2, n)
                cnt, q = _uint(data, q, 2)
                to = []
                for _ in range(cnt):
                    t, q = _uint(data, q, n)
                    to.append(t)
                items.setdefault(frm, Item(frm)).refs.setdefault(
                    k2, []).extend(to)
        elif kind == b"iprp":
            for k2, s2, e2 in _boxes(data, bs, be):
                if k2 == b"ipco":
                    props = [(k3, data[s3:e3]) for k3, s3, e3 in
                             _boxes(data, s2, e2)]
                elif k2 == b"ipma":
                    assoc.append((s2, e2))
        elif kind == b"idat":
            idat = data[bs:be]
    if not hdlr_ok:
        raise AvifParseError("AVIF: meta has no hdlr")
    for s2, e2 in assoc:
        ver, flags, q = _full(data, s2)
        cnt, q = _uint(data, q, 4)
        for _ in range(cnt):
            iid, q = _uint(data, q, 2 if ver < 1 else 4)
            n = data[q]
            q += 1
            it = items.setdefault(iid, Item(iid))
            for _ in range(n):
                if flags & 1:
                    v16, q = _uint(data, q, 2)
                    ess, idx = v16 >> 15, v16 & 0x7FFF
                else:
                    ess, idx = data[q] >> 7, data[q] & 0x7F
                    q += 1
                if idx == 0:
                    continue
                if idx > len(props):
                    raise AvifParseError("AVIF: ipma names no property")
                it.props.append((props[idx - 1][0], props[idx - 1][1], ess))
    return items, primary, idat


def _parse_iloc(data, s, e, items):
    ver, _, p = _full(data, s)
    if ver > 2:
        raise AvifParseError("AVIF: iloc version %d" % ver)
    off_size, len_size = data[p] >> 4, data[p] & 15
    base_size, idx_size = data[p + 1] >> 4, data[p + 1] & 15
    p += 2
    if ver < 1:
        idx_size = 0
    cnt, p = _uint(data, p, 2 if ver < 2 else 4)
    for _ in range(cnt):
        iid, p = _uint(data, p, 2 if ver < 2 else 4)
        method = 0
        if ver in (1, 2):
            m, p = _uint(data, p, 2)
            method = m & 15
        p += 2                                  # data_reference_index
        base, p = _uint(data, p, base_size)
        n, p = _uint(data, p, 2)
        it = items.setdefault(iid, Item(iid))
        it.construction = method
        for _ in range(n):
            if idx_size:
                _, p = _uint(data, p, idx_size)
            off, p = _uint(data, p, off_size)
            ln, p = _uint(data, p, len_size)
            it.extents.append((base + off, ln))
        if p > e:
            raise AvifParseError("AVIF: truncated iloc")


def _item_data(f: AvifFile, it: Item) -> bytes:
    if it.construction == 1:
        src = f.idat
    elif it.construction == 0:
        src = f.data
    else:
        raise AvifDecodeError("AVIF: iloc construction method %d"
                              % it.construction)
    out = b""
    for off, ln in it.extents:
        if ln == 0:
            ln = len(src) - off
        if off + ln > len(src):
            raise SyntaxError("Failed to decode frame 0: Truncated data")
        out += src[off:off + ln]
    return out


def _parse_moov(data, s, e):
    tracks = []
    for kind, bs, be in _boxes(data, s, e):
        if kind != b"trak":
            continue
        t = {"id": 0, "refs": {}, "handler": b"", "sample": None,
             "av1c": None}
        _walk_trak(data, bs, be, t)
        tracks.append(t)
    return tracks


def _walk_trak(data, s, e, t):
    chunk_offsets, sizes, stsc = [], [], []
    for kind, bs, be in _boxes(data, s, e):
        if kind == b"tkhd":
            ver, _, p = _full(data, bs)
            p += 16 if ver == 1 else 8
            t["id"], _ = _uint(data, p, 4)
        elif kind == b"tref":
            for k2, s2, e2 in _boxes(data, bs, be):
                t["refs"][k2] = [struct.unpack_from(">I", data, q)[0]
                                 for q in range(s2, e2, 4)]
        elif kind in (b"mdia", b"minf", b"stbl"):
            _walk_trak(data, bs, be, t)
        elif kind == b"hdlr":
            _, _, p = _full(data, bs)
            t["handler"] = data[p + 4:p + 8]
        elif kind == b"stsd":
            _, _, p = _full(data, bs)
            p += 4
            for k2, s2, e2 in _boxes(data, p, be):
                if k2 == b"av01":
                    q = s2 + 78
                    for k3, s3, e3 in _boxes(data, q, e2):
                        if k3 == b"av1C":
                            t["av1c"] = data[s3:e3]
                    t["entry"] = True
        elif kind == b"stsz":
            _, _, p = _full(data, bs)
            size, cnt = struct.unpack_from(">II", data, p)
            if size:
                sizes = [size] * cnt
            else:
                sizes = list(struct.unpack_from(">%dI" % cnt, data, p + 8))
            t["sizes"] = sizes
        elif kind == b"stsc":
            _, _, p = _full(data, bs)
            cnt, = struct.unpack_from(">I", data, p)
            stsc = [struct.unpack_from(">III", data, p + 4 + 12 * i)
                    for i in range(cnt)]
            t["stsc"] = stsc
        elif kind in (b"stco", b"co64"):
            _, _, p = _full(data, bs)
            cnt, = struct.unpack_from(">I", data, p)
            fmt = ">%dI" % cnt if kind == b"stco" else ">%dQ" % cnt
            chunk_offsets = list(struct.unpack_from(fmt, data, p + 4))
            t["chunks"] = chunk_offsets
    if "sizes" in t and "chunks" in t and t.get("sample") is None:
        if not t["sizes"] or not t["chunks"]:
            return
        t["sample"] = (t["chunks"][0], t["sizes"][0])


def probe(data: bytes) -> None:
    """PIL's `_accept` (the ftyp's major brand), then libavif's parse."""
    if data[4:8] != b"ftyp" or data[8:12] not in (b"avif", b"avis",
                                                  b"mif1", b"msf1"):
        raise NotThisFormat("not an AVIF file")
    parse(data)


def _select(f: AvifFile):
    """(colour AV1 data or grid, alpha AV1 data or grid, premultiplied,
    colour item) of the first frame."""
    if f.tracks:
        color = None
        for t in f.tracks:
            if t.get("entry") and not t["refs"].get(b"auxl") and \
                    t["sample"] is not None:
                color = t
                break
        if color is None:
            raise AvifParseError("AVIF: no colour track")
        alpha = None
        for t in f.tracks:
            if t is not color and t["refs"].get(b"auxl") and \
                    color["id"] in t["refs"][b"auxl"] and t["sample"]:
                alpha = t
        off, ln = color["sample"]
        cdata = ("av1", f.data[off:off + ln])
        adata = None
        if alpha is not None:
            off, ln = alpha["sample"]
            adata = ("av1", f.data[off:off + ln])
        prem = bool(color["refs"].get(b"prem"))
        return cdata, adata, prem, None
    items = f.items
    prim = items[f.primary]
    if prim.type not in (b"av01", b"grid"):
        raise AvifDecodeError("AVIF: primary item of type %r" % prim.type)
    cdata = _item_source(f, prim)
    alpha = None
    for it in items.values():
        if f.primary in it.refs.get(b"auxl", []):
            aux = it.prop(b"auxC")
            if aux is not None and aux[4:].rstrip(b"\0") in ALPHA_URNS:
                alpha = it
                break
    adata = _item_source(f, alpha) if alpha is not None else None
    prem = alpha is not None and alpha.id in prim.refs.get(b"prem", [])
    return cdata, adata, prem, prim


def _item_source(f, it):
    if it.type == b"grid":
        g = _item_data(f, it)
        if len(g) < 8:
            raise AvifParseError("AVIF: truncated grid")
        big = g[1] & 1
        rows, cols = g[2] + 1, g[3] + 1
        n = 4 if big else 2
        ow, _ = _uint(g, 4, n)
        oh, _ = _uint(g, 4 + n, n)
        tiles = it.refs.get(b"dimg", [])
        if len(tiles) != rows * cols:
            raise AvifDecodeError("AVIF: grid with %d of %d tiles"
                                  % (len(tiles), rows * cols))
        return ("grid", rows, cols, ow, oh,
                [_item_data(f, f.items[t]) for t in tiles])
    if it.type != b"av01":
        raise AvifDecodeError("AVIF: item type %r" % it.type)
    return ("av1", _item_data(f, it))


def decode_planes(src, stats=None):
    """An item source -> (planes, seq header) with grid tiles put
    together."""
    from .av1_decoder import decode_av1
    from .av1_obu import AV1Error
    from .av1_symbol import SymbolError
    try:
        if src[0] == "av1":
            fr = decode_av1(src[1], stats)
            return fr.planes, fr.seq
        _, rows, cols, ow, oh, tiles = src
        frames = [decode_av1(t, stats) for t in tiles]
        if stats is not None:
            stats.hit("grid")
        _check_grid(frames, rows, cols, ow, oh)
    except (AV1Error, SymbolError, IndexError, ValueError) as e:
        raise AvifDecodeError("AVIF: AV1 decode failed: %s" % e) from e
    seq = frames[0].seq
    out = []
    for p in range(len(frames[0].planes)):
        sx = seq.subsampling_x if p else 0
        sy = seq.subsampling_y if p else 0
        th, tw = frames[0].planes[p].shape
        full = np.zeros((rows * th, cols * tw), np.uint16)
        for i, fr in enumerate(frames):
            r, c = divmod(i, cols)
            full[r * th:(r + 1) * th, c * tw:(c + 1) * tw] = fr.planes[p]
        out.append(full[:(oh + sy) >> sy, :(ow + sx) >> sx])
    return out, seq


def _check_grid(frames, rows, cols, ow, oh):
    """libavif's avifAreGridDimensionsValid (and equal tiles)."""
    seq = frames[0].seq
    th, tw = frames[0].planes[0].shape
    ok = tw >= 64 and th >= 64 and (cols - 1) * tw < ow <= cols * tw and \
        (rows - 1) * th < oh <= rows * th
    if seq.subsampling_x and (tw % 2 or ow % 2 and ow != cols * tw):
        ok = False
    if seq.subsampling_y and (th % 2 or oh % 2 and oh != rows * th):
        ok = False
    for fr in frames:
        if fr.planes[0].shape != (th, tw) or len(fr.planes) != \
                len(frames[0].planes) or fr.seq.BitDepth != seq.BitDepth:
            ok = False
    if not ok:
        raise AvifDecodeError("Failed to decode frame 0: Invalid image grid")


def decode_avif(data: bytes, stats=None) -> np.ndarray:
    """The first frame as PIL 12.1 decodes it: uint8 [H, W, 3] (RGB) or
    [H, W, 4] (RGBA, where the file has an alpha item or track)."""
    from . import avif_rgb
    f = parse(data)
    cdata, adata, prem, prim = _select(f)
    planes, seq = decode_planes(cdata, stats)
    alpha = None
    if adata is not None:
        aplanes, aseq = decode_planes(adata, stats)
        alpha = (aplanes[0], aseq)
    nclx = None
    if prim is not None:
        colr = [p for k, p, _ in prim.props if k == b"colr" and
                p[:4] == b"nclx"]
        if colr:
            c = colr[0]
            nclx = struct.unpack_from(">HHH", c, 4) + (c[10] >> 7,)
    return avif_rgb.to_rgb(planes, seq, nclx, alpha, prem)


def decode_avif_image(data: bytes):
    """`decode_avif` as a ModeImage ("RGB" / "RGBA")."""
    return of_array(decode_avif(data))
