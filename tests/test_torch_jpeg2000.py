"""PyTorch port, JPEG 2000 (jpeg2000.py, jp2.py, j2k_codestream.py,
j2k_t2.py, j2k_t1.py, j2k_dwt.py) and ICNS's JPEG 2000 icons, against PIL
12.1 (OpenJPEG 2.5.4).

PIL is the oracle: each file decodes bit-equal to PIL's pixels in PIL's
mode and to its convert("RGB") / convert("RGBA"), 9/7 files included (no
sample differs).  PIL writes what its encoder can: reversible and
irreversible, JP2 and raw codestreams, "L", "LA", "RGB", "RGBA" and
"I;16", signed, MCT on and off, tiles and image offsets, precincts,
code-block sizes, 1 to 6 resolutions, the five progressions, quality
layers by rate and by dB, PLT and comments.  What its encoder cannot
write comes from the libopenjp2 2.5.4 that Pillow bundles, driven through
ctypes (`opj_encode`): each code-block style, SOP / EPH, ROI, POC,
subsampled components and precisions other than 8, each file checked by
its markers; and from the writers here: JP2 boxes around a codestream
(CMYK, sYCC, ICC and palette `colr` / `pclr`), packed packet headers
(PPM, PPT, moved out of a codestream), TLM / PLM / CRG / COC / QCC markers.

The committed fixtures under tests/data/jp2/ (PIL's convert("RGBA")
beside each as `<stem>_pil.png`, its "I;16" pixels as `<stem>_pil.npy`)
and tests/data/restore18/ are what `make_fixtures` writes; `chip_smoke.py`
decodes them on the machine without PIL.  The slice as a whole: the
restore dataset's items and `load_rgb` / `load_rgba` over restore18 (JP2,
codestreams, ICNS and a ZSTD TIFF) equal the JAX package's."""
import ctypes as C
import functools
import glob
import io
import os
import shutil
import struct
import tempfile
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import j2k_codestream, j2k_dwt, j2k_t2, jp2
from pointdreamer_tpu_torch import jpeg2000 as tj2k

from test_torch_image_formats import _image
from test_torch_image_formats_rest import (NPY_MODES, _native, _pil_bytes,
                                           assert_reads_as_pil, icns_file,
                                           pil_npy_name, pil_png_name)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# ---------------------------------------------------------------------------
# libopenjp2's encoder through ctypes (the structs of openjpeg.h 2.5)

_U32, _I32, _INT = C.c_uint32, C.c_int32, C.c_int


class _Poc(C.Structure):
    _fields_ = [(n, _U32) for n in (
        "resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
        "precno0", "precno1")] + [
        ("prg1", _INT), ("prg", _INT), ("progorder", C.c_char * 5),
        ("tile", _U32)] + [(n, _I32) for n in ("tx0", "tx1", "ty0", "ty1")] + [
        (n, _U32) for n in (
            "layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE",
            "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t",
            "comp_t", "prc_t", "tx0_t", "ty0_t")]


class _Params(C.Structure):
    _fields_ = [(n, _INT) for n in (
        "tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy",
        "cp_disto_alloc", "cp_fixed_alloc", "cp_fixed_quality")] + [
        ("cp_matrice", C.c_void_p), ("cp_comment", C.c_char_p),
        ("csty", _INT), ("prog_order", _INT), ("POC", _Poc * 32),
        ("numpocs", _U32), ("tcp_numlayers", _INT),
        ("tcp_rates", C.c_float * 100), ("tcp_distoratio", C.c_float * 100)
    ] + [(n, _INT) for n in (
        "numresolution", "cblockw_init", "cblockh_init", "mode",
        "irreversible", "roi_compno", "roi_shift", "res_spec")] + [
        ("prcw_init", _INT * 33), ("prch_init", _INT * 33),
        ("infile", C.c_char * 4096), ("outfile", C.c_char * 4096),
        ("index_on", _INT), ("index", C.c_char * 4096)] + [
        (n, _INT) for n in (
            "image_offset_x0", "image_offset_y0", "subsampling_dx",
            "subsampling_dy", "decod_format", "cod_format", "jpwl_epc_on",
            "jpwl_hprot_MH")] + [
        ("jpwl_hprot_TPH_tileno", _INT * 16), ("jpwl_hprot_TPH", _INT * 16),
        ("jpwl_pprot_tileno", _INT * 16), ("jpwl_pprot_packno", _INT * 16),
        ("jpwl_pprot", _INT * 16)] + [(n, _INT) for n in (
            "jpwl_sens_size", "jpwl_sens_addr", "jpwl_sens_range",
            "jpwl_sens_MH")] + [
        ("jpwl_sens_TPH_tileno", _INT * 16), ("jpwl_sens_TPH", _INT * 16),
        ("cp_cinema", _INT), ("max_comp_size", _INT), ("cp_rsiz", _INT),
        ("tp_on", C.c_char), ("tp_flag", C.c_char), ("tcp_mct", C.c_char),
        ("jpip_on", _INT), ("mct_data", C.c_void_p), ("max_cs_size", _INT),
        ("rsiz", C.c_uint16)]


class _CompParm(C.Structure):
    _fields_ = [(n, _U32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec",
                                    "bpp", "sgnd")]


class _Comp(C.Structure):
    _fields_ = [(n, _U32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
        "resno_decoded", "factor")] + [("data", C.POINTER(_I32)),
                                       ("alpha", C.c_uint16)]


class _Image(C.Structure):
    _fields_ = [("x0", _U32), ("y0", _U32), ("x1", _U32), ("y1", _U32),
                ("numcomps", _U32), ("color_space", _INT),
                ("comps", C.POINTER(_Comp)), ("icc_profile_buf", C.c_void_p),
                ("icc_profile_len", _U32)]


@functools.lru_cache(None)
def _openjp2():
    import PIL

    lib = C.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                        "pillow.libs", "libopenjp2-*"))[0])
    lib.opj_image_create.restype = C.POINTER(_Image)
    lib.opj_create_compress.restype = C.c_void_p
    lib.opj_stream_create_default_file_stream.restype = C.c_void_p
    lib.opj_setup_encoder.argtypes = [C.c_void_p, C.POINTER(_Params),
                                      C.POINTER(_Image)]
    for f in ("opj_start_compress",):
        getattr(lib, f).argtypes = [C.c_void_p, C.POINTER(_Image),
                                    C.c_void_p]
    for f in ("opj_encode", "opj_end_compress"):
        getattr(lib, f).argtypes = [C.c_void_p, C.c_void_p]
    for f in ("opj_stream_destroy", "opj_destroy_codec"):
        getattr(lib, f).argtypes = [C.c_void_p]
    lib.opj_image_destroy.argtypes = [C.POINTER(_Image)]
    p = _Params()
    lib.opj_set_default_encoder_parameters(C.byref(p))
    # the layout holds: the defaults around the 4096-byte path fields
    assert (p.numresolution, p.cblockw_init, p.roi_compno,
            p.subsampling_dx, p.decod_format, p.cod_format) == (
        6, 64, -1, 1, -1, -1)
    return lib


_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def opj_encode(planes, prec=8, sgnd=False, sub=None, mode=0, csty=0,
               roi=None, pocs=(), layers=(0,), resolutions=3,
               irreversible=False, mct=None, order="LRCP") -> bytes:
    """A raw codestream of `planes` (each component's samples at its own
    size) by libopenjp2: code-block style `mode`, SOP / EPH in `csty`,
    ROI (component, shift), POC entries (tile, r0, c0, l1, r1, c1, order),
    `sub` (dx, dy) per component, layer rates."""
    lib = _openjp2()
    p = _Params()
    lib.opj_set_default_encoder_parameters(C.byref(p))
    p.tcp_numlayers = len(layers)
    for i, r in enumerate(layers):
        p.tcp_rates[i] = r
    p.cp_disto_alloc = 1
    p.numresolution = resolutions
    p.mode, p.csty, p.irreversible = mode, csty, int(irreversible)
    p.prog_order = _PROG[order]
    if roi:
        p.roi_compno, p.roi_shift = roi
    for i, (tile, r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        q = p.POC[i]
        q.tile, q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = (
            tile, r0, c0, l1, r1, c1)
        q.prg1 = _PROG[prg]
    p.numpocs = len(pocs)
    n = len(planes)
    sub = sub or [(1, 1)] * n
    parms = (_CompParm * n)()
    for k, (pl, (dx, dy)) in enumerate(zip(planes, sub)):
        parms[k].dx, parms[k].dy = dx, dy
        parms[k].h, parms[k].w = pl.shape
        parms[k].prec = parms[k].bpp = prec
        parms[k].sgnd = int(sgnd)
    img = lib.opj_image_create(n, parms, 1)
    im = img.contents
    im.x1, im.y1 = planes[0].shape[1], planes[0].shape[0]
    for k, pl in enumerate(planes):
        flat = np.ascontiguousarray(pl, np.int32).ravel()
        C.memmove(im.comps[k].data, flat.ctypes.data, flat.nbytes)
    p.tcp_mct = bytes([1 if (n >= 3 if mct is None else mct) else 0])
    codec = lib.opj_create_compress(0)
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        assert lib.opj_setup_encoder(codec, C.byref(p), img)
        st = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = lib.opj_start_compress(codec, img, st) and lib.opj_encode(
            codec, st) and lib.opj_end_compress(codec, st)
        lib.opj_stream_destroy(st)
        assert ok
        with open(path, "rb") as f:
            return f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        os.remove(path)


# ---------------------------------------------------------------------------
# codestream surgery and JP2 boxes


def markers(cs: bytes):
    """[(tile-part or -1 for the main header, marker, segment)] of the
    headers, and the tile-parts' (SOT position, SOD end, end)."""
    out, parts = [], []
    pos, part = 2, -1
    while pos + 2 <= len(cs):
        m, = struct.unpack_from(">H", cs, pos)
        if m == 0xFFD9:
            break
        if m == 0xFF90:
            psot, = struct.unpack_from(">I", cs, pos + 6)
            part += 1
            sot = pos
            end = len(cs) - 2 if psot == 0 else pos + psot
            pos += 12
            while struct.unpack_from(">H", cs, pos)[0] != 0xFF93:
                n, = struct.unpack_from(">H", cs, pos + 2)
                out.append((part, struct.unpack_from(">H", cs, pos)[0],
                            cs[pos + 2:pos + 2 + n]))
                pos += 2 + n
            parts.append((sot, pos + 2, end))
            pos = end
            continue
        n, = struct.unpack_from(">H", cs, pos + 2)
        out.append((-1, m, cs[pos + 2:pos + 2 + n]))
        pos += 2 + n
    return out, parts


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _rebuild(cs: bytes, main_extra=b"", drop=(), tile_extra=None,
             bodies=None) -> bytes:
    """A codestream with markers added to its main header and tile-part
    headers, the markers of `drop` taken out, and each tile-part's body
    replaced (by `bodies[i]`) where given."""
    segs, parts = markers(cs)
    main = b"".join(_segment(m, s[2:]) for p, m, s in segs
                    if p == -1 and m not in drop)
    out = cs[:2] + main + main_extra
    for i, (sot, sod, end) in enumerate(parts):
        head = b"".join(_segment(m, s[2:]) for p, m, s in segs
                        if p == i and m not in drop)
        head += tile_extra(i) if tile_extra else b""
        body = bodies[i] if bodies else cs[sod:end]
        psot = 12 + len(head) + 2 + len(body)
        out += cs[sot:sot + 6] + struct.pack(">I", psot) + \
            cs[sot + 10:sot + 12] + head + b"\xff\x93" + body
    return out + b"\xff\xd9"


def _packet_spans(cs: bytes):
    """Each tile's packets as the port reads them: (start, header start,
    header end, end) in its tile-part body (SOP before the header, EPH
    after it); the headers are where the port's packet-header reader
    starts and stops."""
    parsed = j2k_codestream.parse(cs)
    spans = {}
    for t, tile in sorted(parsed.tiles.items()):
        layout = j2k_codestream.tile_layout(parsed, t, tile.params)
        readers = []

        class Recording(j2k_t2.Bio):
            def __init__(self, data, pos, end):
                super().__init__(data, pos, end)
                self.first = pos
                readers.append(self)

        with mock.patch.object(j2k_t2, "Bio", Recording):
            j2k_t2.read_packets(parsed, t, layout)
        data = bytes(tile.data)
        heads = []
        for r in readers:
            end = r.pos + (2 if data[r.pos:r.pos + 2] == b"\xff\x92" else 0)
            sop = r.first >= 6 and data[r.first - 6:r.first - 4] == \
                b"\xff\x91"
            heads.append((r.first - 6 if sop else r.first, r.first, end))
        ends = [s for s, _, _ in heads[1:]] + [len(data)]
        spans[t] = [(s, a, b, e) for (s, a, b), e in zip(heads, ends)]
    return spans


def packed_headers(cs: bytes, where: str) -> bytes:
    """The packet headers of a codestream (one tile-part a tile) moved to
    PPT markers of each tile-part, or to PPM markers of the main header;
    the SOP markers stay in the bodies, the EPH markers go with the
    headers."""
    spans = _packet_spans(cs)
    _, parts = markers(cs)
    heads, bodies = [], []
    for i, (sot, sod, end) in enumerate(parts):
        body = cs[sod:end]
        h = b"".join(body[a:b] for _, a, b, _ in spans[i])
        heads.append(h)
        bodies.append(b"".join(body[s:a] + body[b:e]
                               for s, a, b, e in spans[i]))

    def chunks(data, size):
        return [data[k:k + size] for k in range(0, len(data), size)] or [b""]

    if where == "ppt":
        return _rebuild(cs, bodies=bodies, tile_extra=lambda i: b"".join(
            _segment(0xFF61, bytes([z]) + c)
            for z, c in enumerate(chunks(heads[i], 1000))))
    stream = b"".join(struct.pack(">I", len(h)) + h for h in heads)
    ppm = b"".join(_segment(0xFF60, bytes([z]) + c)
                   for z, c in enumerate(chunks(stream, 1000)))
    return _rebuild(cs, main_extra=ppm, bodies=bodies)


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


def jp2_file(cs: bytes, nc: int, colr: bytes, extra: bytes = b"",
             bpc: int = 7) -> bytes:
    """A JP2 file of a codestream: signature, ftyp, jp2h (ihdr, the colour
    box `colr`, `extra`) and jp2c."""
    xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", cs, 8)
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", ysiz - yo, xsiz - xo, nc,
                                     bpc, 7, 0, 0))
    return (jp2.SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", ihdr + colr + extra) + _box(b"jp2c", cs))


def colr_enum(enumcs: int) -> bytes:
    return _box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def colr_icc() -> bytes:
    return _box(b"colr", b"\x02\x00\x00" + bytes(128))


def pclr_cmap(entries) -> bytes:
    pclr = _box(b"pclr", struct.pack(">HB", len(entries), 3) + b"\x07" * 3
                + bytes(v for e in entries for v in e))
    return pclr + _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k)
                                         for k in range(3)))


# ---------------------------------------------------------------------------
# fixtures


def _pil_j2k(arr, mode=None, **opts) -> bytes:
    if mode == "LA":
        img = Image.merge("LA", [Image.fromarray(arr[..., k])
                                 for k in range(2)])
    else:
        img = Image.fromarray(arr)
    return _pil_bytes(img, "JPEG2000", **opts)


def _planes(w, h, n, seed, prec=8):
    a = _image(w, h, seed).astype(np.int32)
    if n == 4:
        a = np.dstack([a, _image(w, h, seed + 1)[..., :1]])
    a = a[..., :n]
    if prec != 8:
        a = (a * ((1 << prec) - 1)) // 255
    return [a[..., k] for k in range(n)]


@functools.lru_cache(None)
def _cs(n: int) -> bytes:
    """A codestream of n components, MCT off (a palette's indices for
    n = 1), for the JP2 boxes around it."""
    if n == 1:
        return opj_encode([(_planes(19, 20, 1, 202)[0] % 6)], resolutions=2)
    return opj_encode(_planes(19, 20, n, 199 + n), mct=False)


@functools.lru_cache(None)
def _tiled() -> bytes:
    """Tiles, precincts and two layers: the packets PPM / PPT pack."""
    return _pil_j2k(_image(40, 37, 203), no_jp2=True, tile_size=(16, 16),
                    quality_mode="rates", quality_layers=[12, 4],
                    precinct_size=(16, 16), num_resolutions=3)


def _jp2_fixtures():
    rgb = _image(13, 10, 180)
    mid = _image(37, 29, 181)
    sq = _image(40, 37, 182)
    rgba = np.dstack([_image(17, 9, 183), _image(17, 9, 184)[..., :1]])
    i16 = (_image(19, 20, 185)[..., 0].astype(np.uint16) * 257 + 3)
    prog = {f"prog_{p.lower()}.j2k": (lambda p: lambda: _pil_j2k(
        mid, progression=p, precinct_size=(16, 16), num_resolutions=3,
        tile_size=(20, 16), quality_mode="rates", quality_layers=[20, 10]))(
        p) for p in _PROG}
    prog.update({f"prog_{p.lower()}_odd_irr.jp2": (lambda p: lambda: _pil_j2k(
        mid, progression=p, precinct_size=(8, 8), num_resolutions=3,
        offset=(3, 1), tile_size=(64, 64), irreversible=True))(p)
        for p in _PROG})
    styles = {f"style_{name}.j2k": (lambda m: lambda: opj_encode(
        _planes(37, 40, 3, 190), mode=m))(m)
        for name, m in (("bypass", 1), ("reset", 2), ("termall", 4),
                        ("vsc", 8), ("pterm", 16), ("segsym", 32))}
    return {
        "rev_rgb_13x10.jp2": lambda: _pil_j2k(rgb),
        "irr_rgb_13x10.jp2": lambda: _pil_j2k(rgb, irreversible=True),
        "rev_l_1x23.j2k": lambda: _pil_j2k(_image(23, 1, 186)[..., 0],
                                           no_jp2=True),
        "rev_l_23x1.jp2": lambda: _pil_j2k(_image(1, 23, 187)[..., 0]),
        "irr_l_1x23.jp2": lambda: _pil_j2k(_image(23, 1, 188)[..., 0],
                                           irreversible=True),
        "rev_la_17x9.jp2": lambda: _pil_j2k(rgba[..., :2], "LA"),
        "rev_rgba_17x9.j2k": lambda: _pil_j2k(rgba, no_jp2=True),
        "irr_rgba_17x9.jp2": lambda: _pil_j2k(rgba, irreversible=True),
        "rev_i16_19x20.jp2": lambda: _pil_j2k(i16),
        "irr_i16_19x20.j2k": lambda: _pil_j2k(i16, no_jp2=True,
                                              irreversible=True),
        "signed_l.j2k": lambda: _pil_j2k(rgb[..., 1], no_jp2=True,
                                         signed=True),
        "signed_rgb_irr.jp2": lambda: _pil_j2k(rgb, signed=True,
                                               irreversible=True),
        "mct0_rgb.jp2": lambda: _pil_j2k(rgb, mct=0),
        "mct0_rgb_irr.j2k": lambda: _pil_j2k(rgb, mct=0, no_jp2=True,
                                             irreversible=True),
        "tiles_offsets.j2k": lambda: _pil_j2k(
            mid, no_jp2=True, tile_size=(16, 12), tile_offset=(3, 5),
            offset=(7, 9)),
        "tiles_offsets_irr.jp2": lambda: _pil_j2k(
            mid[:, :28], tile_size=(16, 12), tile_offset=(3, 5),
            offset=(7, 9), irreversible=True),
        "precincts_res4.jp2": lambda: _pil_j2k(sq, precinct_size=(8, 8),
                                               num_resolutions=4),
        "precincts_irr.j2k": lambda: _pil_j2k(
            sq, no_jp2=True, precinct_size=(16, 8), num_resolutions=3,
            irreversible=True),
        "cblk_16x16.j2k": lambda: _pil_j2k(sq, no_jp2=True,
                                           codeblock_size=(16, 16)),
        "cblk_32x8.jp2": lambda: _pil_j2k(sq, codeblock_size=(32, 8)),
        "res1.jp2": lambda: _pil_j2k(_image(19, 20, 189), num_resolutions=1),
        "res6_64.jp2": lambda: _pil_j2k(_image(64, 64, 190),
                                        num_resolutions=6),
        "layers_rates_irr.jp2": lambda: _pil_j2k(
            sq, irreversible=True, quality_mode="rates",
            quality_layers=[40, 20, 10]),
        "layers_db.j2k": lambda: _pil_j2k(sq, no_jp2=True, quality_mode="dB",
                                          quality_layers=[30, 40, 50]),
        "plt.j2k": lambda: _pil_j2k(sq, no_jp2=True, plt=True),
        "comment.jp2": lambda: _pil_j2k(rgb, comment="a JPEG 2000 comment"),
        **prog,
        **styles,
        "style_all_irr_layers.j2k": lambda: opj_encode(
            _planes(37, 40, 3, 191), mode=63, irreversible=True,
            layers=(30, 10, 0)),
        "style_bypass_layers.j2k": lambda: opj_encode(
            _planes(37, 40, 3, 192), mode=1, layers=(20, 8, 0)),
        "sop_eph.j2k": lambda: opj_encode(_planes(37, 40, 3, 193), csty=6,
                                          layers=(20, 0)),
        "roi.j2k": lambda: opj_encode(_planes(37, 40, 3, 194), roi=(0, 5)),
        "roi_irr.j2k": lambda: opj_encode(_planes(37, 40, 3, 195),
                                          roi=(1, 7), irreversible=True,
                                          layers=(20, 0)),
        "poc.j2k": lambda: opj_encode(_planes(37, 40, 3, 196), layers=(20, 0),
                                      pocs=[(1, 0, 0, 1, 2, 3, "RLCP"),
                                            (1, 0, 0, 2, 3, 3, "CPRL")]),
        "sub_420.j2k": lambda: opj_encode(
            [_planes(36, 40, 1, 197)[0]] + _planes(18, 20, 2, 198),
            sub=[(1, 1), (2, 2), (2, 2)], mct=False),
        "sub_odd.j2k": lambda: opj_encode(
            [_planes(19, 21, 1, 199)[0]] + _planes(10, 11, 2, 200),
            sub=[(1, 1), (2, 2), (2, 2)], mct=False),
        "sub_sycc.jp2": lambda: jp2_file(opj_encode(
            [_planes(36, 40, 1, 201)[0]] + _planes(18, 20, 2, 202),
            sub=[(1, 1), (2, 2), (2, 2)], mct=False), 3, colr_enum(18)),
        "prec12_l.j2k": lambda: opj_encode(_planes(19, 20, 1, 203, 12),
                                           prec=12),
        "prec4_rgb.j2k": lambda: opj_encode(_planes(19, 20, 3, 204, 4),
                                            prec=4),
        "prec12_rgb_irr.j2k": lambda: opj_encode(
            _planes(19, 20, 3, 205, 12), prec=12, irreversible=True),
        "signed12_l.j2k": lambda: opj_encode(
            [p - 2048 for p in _planes(19, 20, 1, 206, 12)], prec=12,
            sgnd=True),
        "cmyk.jp2": lambda: jp2_file(_cs(4), 4, colr_enum(12)),
        "sycc.jp2": lambda: jp2_file(_cs(3), 3, colr_enum(18)),
        "icc.jp2": lambda: jp2_file(_cs(3), 3, colr_icc()),
        "pclr.jp2": lambda: jp2_file(_cs(1), 1, colr_enum(16), pclr_cmap(
            [(10, 20, 30), (40, 50, 60), (10, 20, 30), (200, 100, 0),
             (1, 2, 3)])),
        "ppt.j2k": lambda: packed_headers(_tiled(), "ppt"),
        "ppm.j2k": lambda: packed_headers(_tiled(), "ppm"),
        "ppt_sop_eph.j2k": lambda: packed_headers(opj_encode(
            _planes(40, 37, 3, 204), csty=6, layers=(16, 4),
            order="RPCL"), "ppt"),
        "tlm_plm_crg.j2k": lambda: _with_pointer_markers(_tiled()),
        "coc_qcc.j2k": lambda: _with_component_markers(sq),
        "icns_jp2.icns": lambda: icns_file([(b"icp6", _pil_j2k(
            _image(64, 64, 207), irreversible=True))]),
        "icns_j2k_la.icns": lambda: icns_file([(b"icp4", _pil_j2k(
            _image(16, 16, 208)[..., :2], "LA", no_jp2=True))]),
    }


def _with_pointer_markers(cs: bytes) -> bytes:
    """TLM (each tile-part's length), PLM (each packet's length) and CRG
    markers in the main header: pointers a decoder reads past."""
    spans = _packet_spans(cs)
    _, parts = markers(cs)
    ntp = len(parts)
    tlm = _segment(0xFF55, b"\x00\x60" + b"".join(
        struct.pack(">HI", i, end - sot) for i, (sot, _, end) in
        enumerate(parts)))

    def length_bytes(n):
        out = [n & 0x7F]
        n >>= 7
        while n:
            out.append(0x80 | (n & 0x7F))
            n >>= 7
        return bytes(reversed(out))

    plm_body = b"\x00"
    for i in range(ntp):
        lens = b"".join(length_bytes(e - s) for s, _, _, e in spans[i])
        plm_body += bytes([len(lens)]) + lens
    crg = _segment(0xFF63, struct.pack(">HHHHHH", 0, 0, 100, 200, 32768, 0))
    return _rebuild(cs, main_extra=tlm + _segment(0xFF57, plm_body) + crg)


def _with_component_markers(arr) -> bytes:
    """COC and QCC in the main header (component 1's style with
    predictable termination, component 2's quantization restated) and a
    tile-part COD / QCD restating the main header's."""
    cs = _pil_j2k(arr, no_jp2=True, precinct_size=(16, 16),
                  num_resolutions=3)
    segs, _ = markers(cs)
    cod = next(s for p, m, s in segs if m == 0xFF52)
    qcd = next(s for p, m, s in segs if m == 0xFF5C)
    spcod = bytearray(cod[7:])
    spcod[3] |= 16
    coc = _segment(0xFF53, b"\x01" + bytes([cod[2] & 1]) + bytes(spcod))
    qcc = _segment(0xFF5D, b"\x02" + qcd[2:])
    return _rebuild(cs, main_extra=coc + qcc, tile_extra=lambda i: (
        _segment(0xFF52, cod[2:]) + _segment(0xFF5C, qcd[2:])))


# what each crafted or libopenjp2 fixture must show in its codestream
FEATURES = {
    "style_bypass.j2k": ("style", 1), "style_reset.j2k": ("style", 2),
    "style_termall.j2k": ("style", 4), "style_vsc.j2k": ("style", 8),
    "style_pterm.j2k": ("style", 16), "style_segsym.j2k": ("style", 32),
    "style_all_irr_layers.j2k": ("style", 63),
    "style_bypass_layers.j2k": ("style", 1),
    "sop_eph.j2k": ("marker", 0xFF91), "roi.j2k": ("marker", 0xFF5E),
    "roi_irr.j2k": ("marker", 0xFF5E), "poc.j2k": ("marker", 0xFF5F),
    "sub_420.j2k": ("sub", 2), "sub_odd.j2k": ("sub", 2),
    "sub_sycc.jp2": ("sub", 2), "ppt.j2k": ("marker", 0xFF61),
    "ppm.j2k": ("marker", 0xFF60), "ppt_sop_eph.j2k": ("marker", 0xFF61),
    "tlm_plm_crg.j2k": ("marker", 0xFF57), "coc_qcc.j2k": ("marker", 0xFF5D),
    "plt.j2k": ("marker", 0xFF58), "comment.jp2": ("marker", 0xFF64),
}


def _restore_fixtures():
    """The restore folder: files only this slice's readers decode, under
    the dataset's extensions."""
    from test_torch_zstd import zstd_tiff

    p = [_image(64, 48, 210 + k) for k in range(8)]
    return {
        "a_jp2_rev.png": lambda: _pil_j2k(p[0]),
        "b_j2k_irr.jpg": lambda: _pil_j2k(p[1], no_jp2=True,
                                          irreversible=True),
        "c_tiled.jpeg": lambda: _pil_j2k(p[2], tile_size=(32, 32),
                                         tile_offset=(0, 0)),
        "d_layers.bmp": lambda: _pil_j2k(p[3], irreversible=True,
                                         quality_mode="rates",
                                         quality_layers=[30, 15, 5]),
        "e_icns.webp": lambda: icns_file([(b"icp6", _pil_j2k(
            _image(64, 64, 218), irreversible=True))]),
        "f_zstd.ppm": lambda: zstd_tiff(p[5], predictor=2),
        "g_rgba_rpcl.png": lambda: _pil_j2k(
            np.dstack([p[6], p[7][..., :1]]), no_jp2=True,
            progression="RPCL", precinct_size=(16, 16), num_resolutions=3),
        "h_sop_eph.jpg": lambda: opj_encode(_planes(64, 48, 3, 219),
                                            csty=6, layers=(20, 0)),
    }


FIXTURE_SETS = {"jp2": _jp2_fixtures, "restore18": _restore_fixtures}
# --image in chip_smoke's phase 17: 256x256, 9/7, 5 levels, 3 layers
IMAGE_JP2 = ("jp2", "restore_256.jp2", lambda: _pil_j2k(
    _image(256, 256, 220), irreversible=True, num_resolutions=6,
    quality_mode="rates", quality_layers=[40, 20, 10]))
# decoded on the card only (CPU fixtures stay at 64 x 64 and below)
CARD_ONLY = {IMAGE_JP2[1]}


def _items(sub):
    items = list(FIXTURE_SETS[sub]().items())
    if sub == IMAGE_JP2[0]:
        items.append(IMAGE_JP2[1:])
    return items


def make_fixtures(root: str) -> None:
    """Write each fixture under root/<set>/, PIL's convert("RGBA") of it
    beside it as `<stem>_pil.png` and its "I;16" pixels as
    `<stem>_pil.npy`."""
    for sub in FIXTURE_SETS:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        stems = [os.path.splitext(n)[0] for n, _ in _items(sub)]
        assert len(set(stems)) == len(stems), sub
        for name, make in _items(sub):
            data = make()
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(data)
            im = Image.open(io.BytesIO(data))
            im.load()
            Image.fromarray(np.asarray(im.convert("RGBA"))).save(
                os.path.join(root, sub, pil_png_name(name)))
            if im.mode in NPY_MODES:
                np.save(os.path.join(root, sub, pil_npy_name(name)),
                        _native(im))


def _committed(sub):
    return sorted(n for n, _ in _items(sub) if n not in CARD_ONLY)


@functools.lru_cache(None)
def _read(sub, name):
    with open(os.path.join(DATA, sub, name), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# tests: every fixture as PIL reads it


@pytest.mark.parametrize("name", _committed("jp2"))
def test_committed_fixture_reads_as_pil(name):
    data = _read("jp2", name)
    got, im = assert_reads_as_pil(data, name)
    np.testing.assert_array_equal(tmode_rgba(got), tio.load_png(
        os.path.join(DATA, "jp2", pil_png_name(name))))
    npy = os.path.join(DATA, "jp2", pil_npy_name(name))
    assert os.path.exists(npy) == (im.mode in NPY_MODES), name
    if im.mode in NPY_MODES:
        np.testing.assert_array_equal(got.pixels, np.load(npy))


def tmode_rgba(img):
    from pointdreamer_tpu_torch import imagemode

    return imagemode.to_rgba(img)


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_feature_fixture_carries_its_feature(name):
    # the fixtures PIL's encoder cannot write hold what they are named for
    data = _read("jp2", name)
    cs = jp2.read_header(data).codestream if data[:4] != jp2.CODESTREAM \
        else data
    kind, value = FEATURES[name]
    segs, parts = markers(cs)
    if kind == "style":
        cod = next(s for p, m, s in segs if m == 0xFF52)
        assert cod[10] == value, (name, cod[10])
    elif kind == "marker":
        bodies = b"".join(cs[s:e] for _, s, e in parts)
        assert value in {m for _, m, _ in segs} or (
            value >> 8 == 0xFF and struct.pack(">H", value) in bodies), name
    else:
        siz = cs[4:]
        ncomp, = struct.unpack_from(">H", siz, 36)
        subs = [siz[38 + 3 * c + 1] for c in range(ncomp)]
        assert max(subs) == value, (name, subs)


def test_packed_headers_decode_as_the_original():
    # PIL reads the PPM / PPT files as it reads the codestream they came
    # from: the headers were moved, nothing else
    want = np.asarray(Image.open(io.BytesIO(_tiled())))
    for name in ("ppt.j2k", "ppm.j2k"):
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(
            _read("jp2", name)))), want)


@pytest.mark.parametrize("name", _committed("restore18"))
def test_restore18_fixture_reads_as_pil(name):
    data = _read("restore18", name)
    assert_reads_as_pil(data, name)


def test_fixtures_are_what_make_fixtures_writes(tmp_path):
    make_fixtures(str(tmp_path))
    for sub in FIXTURE_SETS:
        assert sorted(os.listdir(tmp_path / sub)) == sorted(
            os.listdir(os.path.join(DATA, sub))), sub
        for name, _ in _items(sub):
            for n in (name, pil_png_name(name), pil_npy_name(name)):
                committed = os.path.join(DATA, sub, n)
                if not os.path.exists(committed):
                    continue
                made = str(tmp_path / sub / n)
                if n.endswith("_pil.png"):
                    np.testing.assert_array_equal(tio.load_png(committed),
                                                  tio.load_png(made))
                elif n.endswith((".tif", ".ppm")) and sub == "restore18":
                    # libtiff leaves some IFD bytes undefined
                    np.testing.assert_array_equal(
                        np.asarray(Image.open(committed)),
                        np.asarray(Image.open(made)))
                else:
                    assert open(committed, "rb").read() == open(
                        made, "rb").read(), n


# ---------------------------------------------------------------------------
# what PIL refuses, and what the port refuses by name


def test_colour_spaces_pil_cannot_unpack_raise_oserror():
    for data in (jp2_file(_cs(3), 3, colr_enum(24)),     # e-sYCC
                 jp2_file(_cs(3), 3, colr_enum(17)),     # grey, 3 comps
                 jp2_file(_cs(1), 1, colr_enum(17), pclr_cmap([(1, 2, 3)]))):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        assert tio.image_type(data) == "JPEG2000"
        with pytest.raises(OSError):
            tio.decode_image(data)


def test_jp2_header_faults_follow_pil():
    good = _read("jp2", "comment.jp2")
    # a codestream of 5 components: PIL's _open raises SyntaxError, and no
    # later plugin takes the file
    cs = bytearray(opj_encode(_planes(13, 10, 3, 209), mct=False))
    cs[40:42] = struct.pack(">H", 5)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(bytes(cs)))
    assert tio.image_type(bytes(cs)) == ""
    # a JP2 with no jp2h box: PIL reads past the end (OSError)
    nohead = jp2.SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    with pytest.raises(OSError):
        Image.open(io.BytesIO(nohead))
    assert tio.image_type(nohead) == "JPEG2000"
    with pytest.raises(OSError):
        tio.decode_image(nohead)
    assert tio.image_type(good) == "JPEG2000"


def test_htj2k_and_part2_markers_raise_naming_them():
    cs = _read("jp2", "plt.j2k")
    cap = _rebuild(cs, main_extra=_segment(0xFF50, b"\x00\x02\x00\x00"
                                           b"\x00\x00"))
    with pytest.raises(NotImplementedError, match="HTJ2K"):
        tj2k.decode_jpeg2000(cap)
    segs, _ = markers(cs)
    cod = bytearray(next(s for p, m, s in segs if m == 0xFF52))
    cod[10] |= 64
    ht = _rebuild(cs, drop=(0xFF52,), main_extra=_segment(0xFF52,
                                                          bytes(cod[2:])))
    with pytest.raises(NotImplementedError, match="HTJ2K"):
        tj2k.decode_jpeg2000(ht)
    cod = bytearray(next(s for p, m, s in segs if m == 0xFF52))
    cod[6] = 2                                   # Part 2 custom MCT
    mct = _rebuild(cs, drop=(0xFF52,), main_extra=_segment(0xFF52,
                                                           bytes(cod[2:])))
    with pytest.raises(NotImplementedError, match="Part 2"):
        tj2k.decode_jpeg2000(mct)


def test_pclr_of_other_widths_raises_naming_it():
    pclr = _box(b"pclr", struct.pack(">HB", 2, 4) + b"\x07" * 4
                + bytes(range(8)))
    data = jp2_file(_cs(1), 1, colr_enum(16), pclr)
    with pytest.raises(NotImplementedError, match="pclr"):
        tio.decode_image(data)


# ---------------------------------------------------------------------------
# the wavelet transforms: numpy forward transforms, round trips


def _split53(x, odd):
    """Forward 5/3 along the last axis (ITU-T T.800 F.4.8.2), the signal
    starting at an odd coordinate when `odd`: (low, high)."""
    x = x.astype(np.int64).copy()
    n = x.shape[-1]
    if n == 1:
        return (x, x[..., :0]) if not odd else (x[..., :0], 2 * x)
    lo, hi = int(odd), 1 - int(odd)
    idx, left, right = j2k_dwt._neighbours(n, hi)
    x[..., idx] -= (x[..., left] + x[..., right]) >> 1
    idx, left, right = j2k_dwt._neighbours(n, lo)
    x[..., idx] += (x[..., left] + x[..., right] + 2) >> 2
    return x[..., lo::2], x[..., hi::2]


def _split97(x, odd):
    """Forward 9/7 (F.4.8.2) in float64, scaled to OpenJPEG's synthesis:
    low / K, high / 1.625732422 (OpenJPEG's 2 / K, which it keeps at a
    historic value 3.3e-5 off)."""
    x = x.astype(np.float64).copy()
    n = x.shape[-1]
    lo, hi = int(odd), 1 - int(odd)
    if n == 1:
        return (x, x[..., :0]) if not odd else (x[..., :0], x)
    for k, c in enumerate((-1.586134342, -0.052980118, 0.882911075,
                           0.443506852)):
        idx, left, right = j2k_dwt._neighbours(n, hi if k % 2 == 0 else lo)
        x[..., idx] += (x[..., left] + x[..., right]) * c
    return x[..., lo::2] / 1.230174105, x[..., hi::2] / 1.625732422


def _forward(a, x0, y0, split):
    """One 2-D level (columns, then rows): LL, HL, LH, HH."""
    lo, hi = split(a.T, bool(y0 & 1))
    ll, hl = split(lo.T, bool(x0 & 1))
    lh, hh = split(hi.T, bool(x0 & 1))
    return ll, hl, lh, hh


@pytest.mark.parametrize("h,w,x0,y0", [(13, 10, 0, 0), (13, 10, 1, 1),
                                       (1, 23, 3, 0), (23, 1, 0, 5),
                                       (7, 9, 2, 3), (2, 2, 1, 0),
                                       (16, 17, 5, 8)])
def test_53_round_trip_is_exact(h, w, x0, y0):
    a = np.random.default_rng(h * w + x0).integers(-300, 300, (h, w))
    back = j2k_dwt.inverse(*_forward(a, x0, y0, _split53), x0, y0, True)
    np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("h,w,x0,y0", [(13, 10, 0, 0), (13, 10, 1, 1),
                                       (2, 23, 3, 0), (23, 2, 0, 5),
                                       (7, 9, 2, 3), (16, 17, 5, 8)])
def test_97_round_trip_within_float32(h, w, x0, y0):
    # float32 synthesis of a float64 analysis: within 1e-3 of the samples
    # (their magnitude is below 300, float32 carries 7 digits; the cases
    # here come to 1.7e-4 at most)
    a = np.random.default_rng(h * w + y0).uniform(-300, 300, (h, w))
    bands = [b.astype(np.float32) for b in _forward(a, x0, y0, _split97)]
    back = j2k_dwt.inverse(*bands, x0, y0, False)
    assert back.dtype == np.float32
    np.testing.assert_allclose(back, a, atol=1e-3)


def test_97_lone_sample_is_left_as_it_is():
    # OpenJPEG's opj_v8dwt_decode returns at once on a one-sample signal
    # (irr_l_1x23.jp2 holds such columns at even coordinates; its encoder
    # refuses one at an odd coordinate, so no file holds that)
    x = np.array([[3.5]], np.float32)
    for odd in (False, True):
        assert j2k_dwt._synth97(x, odd)[0, 0] == np.float32(3.5)


# ---------------------------------------------------------------------------
# the slice as a whole, against the JAX package


def test_restore18_folder_matches_jax(tmp_path):
    from pointdreamer_tpu.core import io as jio
    from pointdreamer_tpu.models.diffusion import datasets as jds
    from pointdreamer_tpu_torch.models.diffusion import datasets as tds

    names = _committed("restore18")
    root = tmp_path / "imgs"
    os.makedirs(root)
    for n in names:
        shutil.copy(os.path.join(DATA, "restore18", n), root / n)
    jd = jds.ImageFolderDataset(str(root), 256)
    td = tds.ImageFolderDataset(str(root), 256)
    assert td.files == jd.files and len(td.files) == 8
    for k in range(len(td.files)):
        np.testing.assert_array_equal(td[k], jd[k])
    for n in names + ["icns_jp2.icns"]:
        path = str(root / n) if n in names else os.path.join(
            DATA, "jp2", n)
        np.testing.assert_array_equal(tio.load_rgb(path), jio.load_rgb(path))
        np.testing.assert_array_equal(tio.load_rgba(path),
                                      jio.load_rgba(path))
    kinds = sorted(tio.image_type(_read("restore18", n)) for n in names)
    assert kinds == ["ICNS"] + ["JPEG2000"] * 6 + ["TIFF"]
