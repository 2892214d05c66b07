"""Test tools for the port's AVIF reader: dav1d's planes (the AV1 oracle,
through the `dav1d_*` functions Pillow's libavif exports), an AV1 encoder
for what PIL's `save` cannot write (the system libaom through ctypes: 10
and 12 bits, superres, IntraBC), and an AVIF writer (items, alpha, grid,
colr / irot / imir / clap properties, an `avis` track) around such
streams.  Only tests import this; the port loads no AV1 library.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import struct

import numpy as np

# ---------------------------------------------------------------------------
# dav1d through Pillow's libavif


def _pil_libavif():
    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "libavif-*.so*"))
    if not libs:
        return None
    lib = ctypes.CDLL(libs[0])
    lib.dav1d_version.restype = ctypes.c_char_p
    lib.dav1d_data_create.restype = ctypes.c_void_p
    lib.dav1d_data_create.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.dav1d_default_settings.argtypes = [ctypes.c_void_p]
    lib.dav1d_open.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dav1d_send_data.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dav1d_get_picture.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dav1d_picture_unref.argtypes = [ctypes.c_void_p]
    lib.dav1d_close.argtypes = [ctypes.c_void_p]
    return lib


_DAV1D = None


def dav1d():
    global _DAV1D
    if _DAV1D is None:
        _DAV1D = _pil_libavif()
    return _DAV1D


def dav1d_planes(obus: bytes, apply_grain=True):
    """The first picture dav1d decodes from `obus`: uint16 planes."""
    lib = dav1d()
    settings = ctypes.create_string_buffer(512)
    lib.dav1d_default_settings(settings)
    ctypes.c_int.from_buffer(settings, 0).value = 1       # n_threads
    ctypes.c_int.from_buffer(settings, 4).value = 1       # max_frame_delay
    ctypes.c_int.from_buffer(settings, 8).value = int(apply_grain)
    ctx = ctypes.c_void_p()
    assert lib.dav1d_open(ctypes.byref(ctx), settings) == 0
    data = ctypes.create_string_buffer(256)
    buf = lib.dav1d_data_create(data, len(obus))
    ctypes.memmove(buf, obus, len(obus))
    pic = ctypes.create_string_buffer(1024)
    got = False
    for _ in range(100):
        r = lib.dav1d_send_data(ctx, data)
        if lib.dav1d_get_picture(ctx, pic) == 0:
            got = True
            break
        if r < 0 and r != -11:
            break
    assert got, "dav1d gave no picture"
    ptrs = (ctypes.c_void_p * 3).from_buffer(pic, 16)
    strides = (ctypes.c_ssize_t * 2).from_buffer(pic, 40)
    w, h, layout, bpc = (ctypes.c_int * 4).from_buffer(pic, 56)
    hbd = bpc > 8
    ss = {1: (1, 1), 2: (1, 0), 3: (0, 0)}.get(layout)
    planes = []
    for p in range(1 if layout == 0 else 3):
        pw, ph = (w, h) if p == 0 else ((w + ss[0]) >> ss[0],
                                        (h + ss[1]) >> ss[1])
        st = strides[0 if p == 0 else 1]
        raw = ctypes.string_at(ptrs[p], st * ph)
        arr = np.frombuffer(raw, np.uint16 if hbd else np.uint8).reshape(
            ph, st // (2 if hbd else 1))[:, :pw]
        planes.append(arr.astype(np.uint16))
    lib.dav1d_picture_unref(pic)
    lib.dav1d_close(ctypes.byref(ctx))
    return planes


# ---------------------------------------------------------------------------
# libaom through ctypes

_AOM = None


def aom():
    global _AOM
    if _AOM is None:
        path = ctypes.util.find_library("aom")
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.aom_codec_av1_cx.restype = ctypes.c_void_p
        lib.aom_codec_enc_config_default.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
        lib.aom_codec_enc_init_ver.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int]
        lib.aom_img_alloc.restype = ctypes.c_void_p
        lib.aom_img_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_uint, ctypes.c_uint,
                                      ctypes.c_uint]
        lib.aom_codec_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_ulong,
                                         ctypes.c_long]
        lib.aom_codec_get_cx_data.restype = ctypes.c_void_p
        lib.aom_codec_get_cx_data.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p]
        lib.aom_codec_set_option.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p,
                                             ctypes.c_char_p]
        lib.aom_codec_control.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
        lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
        lib.aom_img_free.argtypes = [ctypes.c_void_p]
        _AOM = lib
    return _AOM


_ABI = None


def _abi(lib):
    """The encoder ABI version this libaom accepts."""
    global _ABI
    if _ABI is None:
        for ver in range(64):
            ctx = ctypes.create_string_buffer(512)
            cfg = ctypes.create_string_buffer(4096)
            lib.aom_codec_enc_config_default(lib.aom_codec_av1_cx(), cfg, 0)
            if lib.aom_codec_enc_init_ver(ctx, lib.aom_codec_av1_cx(), cfg,
                                          0, ver) == 0:
                lib.aom_codec_destroy(ctx)
                _ABI = ver
                break
    return _ABI


def aom_encode(planes, bit_depth=8, ssx=1, ssy=1, options=None,
               superres_kf_denominator=0, usage=0, speed=6, full_range=True,
               cq_level=24):
    """One key frame from libaom: the OBUs (temporal delimiter, sequence
    header, frame).  `planes` are uint16 Y, U, V at the subsampling."""
    lib = aom()
    h, w = planes[0].shape
    cfg = ctypes.create_string_buffer(4096)
    assert lib.aom_codec_enc_config_default(lib.aom_codec_av1_cx(), cfg,
                                            usage) == 0
    u = (ctypes.c_uint * 32).from_buffer(cfg)
    profile = 2 if (bit_depth == 12 or (ssx and not ssy)) else \
        (1 if not ssx else 0)
    u[2] = profile
    u[3], u[4] = w, h
    u[5] = 1                                    # g_limit
    u[8] = u[9] = bit_depth
    u[14] = 0                                   # g_lag_in_frames
    if superres_kf_denominator:
        u[19] = 1                               # AOM_SUPERRES_FIXED
        u[20] = u[21] = superres_kf_denominator
    u[24] = 3                                   # AOM_Q
    ctx = ctypes.create_string_buffer(512)
    flags = 0x40000 if bit_depth > 8 else 0     # AOM_CODEC_USE_HIGHBITDEPTH
    assert lib.aom_codec_enc_init_ver(ctx, lib.aom_codec_av1_cx(), cfg,
                                      flags, _abi(lib)) == 0
    opts = {"cpu-used": str(speed), "cq-level": str(cq_level)}
    opts.update(options or {})
    for k, v in opts.items():
        r = lib.aom_codec_set_option(ctx, k.encode(), str(v).encode())
        assert r == 0, (k, v, r)
    fmt = {(1, 1): 0x102, (1, 0): 0x105, (0, 0): 0x106}[(ssx, ssy)]
    if bit_depth > 8:
        fmt |= 0x800
    img = lib.aom_img_alloc(None, fmt, w, h, 16)
    ctypes.c_int.from_address(img + 24).value = int(full_range)
    ptrs = (ctypes.c_void_p * 3).from_address(img + 64)
    strides = (ctypes.c_int * 3).from_address(img + 88)
    for p in range(3):
        arr = planes[p]
        dt = np.uint16 if bit_depth > 8 else np.uint8
        rows = np.ascontiguousarray(arr.astype(dt))
        for y in range(rows.shape[0]):
            ctypes.memmove(ptrs[p] + y * strides[p], rows[y].ctypes.data,
                           rows.shape[1] * rows.itemsize)
    out = b""
    for frame in (img, None):
        assert lib.aom_codec_encode(ctx, frame, 0, 1, 0) == 0
        it = ctypes.c_void_p()
        while True:
            pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                break
            if ctypes.c_int.from_address(pkt).value == 0:   # frame packet
                buf = ctypes.c_void_p.from_address(pkt + 8).value
                sz = ctypes.c_size_t.from_address(pkt + 16).value
                out += ctypes.string_at(buf, sz)
    lib.aom_img_free(img)
    lib.aom_codec_destroy(ctx)
    return out


# ---------------------------------------------------------------------------
# AVIF writer


def _box(kind, payload):
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _full(kind, version, flags, payload):
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


def strip_obus(data: bytes) -> bytes:
    """The OBUs without temporal delimiters (as AVIF stores them)."""
    from pointdreamer_tpu_torch.av1_obu import split_obus
    out = b""
    for o in split_obus(data):
        if o.type == 2:
            continue
        out += _obu(o.type, o.data)
    return out


def _obu(kind, payload):
    size, n = b"", len(payload)
    while True:
        b = n & 0x7F
        n >>= 7
        size += bytes([b | (0x80 if n else 0)])
        if not n:
            break
    return bytes([(kind << 3) | 2]) + size + payload


def av1c(obus: bytes) -> bytes:
    from pointdreamer_tpu_torch.av1_obu import (parse_sequence_header,
                                                split_obus)
    seq_obu = [o for o in split_obus(obus) if o.type == 1][0]
    s = parse_sequence_header(seq_obu.data)
    b1 = (s.seq_profile << 5) | 0        # seq_level_idx 0
    b2 = ((int(s.BitDepth > 8) << 6) | (int(s.BitDepth == 12) << 5) |
          (s.mono_chrome << 4) | (s.subsampling_x << 3) |
          (s.subsampling_y << 2) | s.chroma_sample_position)
    return bytes([0x81, b1, b2, 0]) + _obu(1, seq_obu.data)


def write_avif(color, alpha=None, nclx=(1, 13, 6, 1), prem=False, icc=None,
               extra_props=(), grid=None, brands=(b"avif", b"mif1", b"miaf"),
               major=b"avif", idat=False, avis=False, iloc_version=0):
    """An AVIF around AV1 OBU streams.  `color` is the OBUs of one image
    (or, with `grid` = (rows, cols, width, height), a list of tile
    streams); `alpha` likewise.  `nclx` = (cp, tc, mc, full) or None."""
    from pointdreamer_tpu_torch.av1_obu import (parse_sequence_header,
                                                split_obus)

    def dims(obus):
        s = parse_sequence_header([o for o in split_obus(obus)
                                   if o.type == 1][0].data)
        return (s.max_frame_width_minus_1 + 1,
                s.max_frame_height_minus_1 + 1, s)

    items = []          # (id, type, data, props, refs)
    next_id = [1]

    def add(kind, data, props, refs=()):
        iid = next_id[0]
        next_id[0] += 1
        items.append([iid, kind, data, props, list(refs)])
        return iid

    def image_props(obus, is_alpha):
        w, h, s = dims(obus)
        nch = 1 if s.mono_chrome else 3
        props = [_full(b"ispe", 0, 0, struct.pack(">II", w, h)),
                 _full(b"pixi", 0, 0, bytes([nch] + [s.BitDepth] * nch)),
                 _box(b"av1C", av1c(obus))]
        if is_alpha:
            props.append(_full(b"auxC", 0, 0,
                               b"urn:mpeg:mpegB:cicp:systems:auxiliary:"
                               b"alpha\0"))
        return props, w, h

    color_props = []
    if nclx is not None:
        cp, tc, mc, full = nclx
        color_props.append(_box(b"colr", b"nclx" + struct.pack(
            ">HHHB", cp, tc, mc, full << 7)))
    if icc is not None:
        color_props.append(_box(b"colr", b"prof" + icc))
    color_props += list(extra_props)
    if grid is None:
        cstream = strip_obus(color)
        props, w, h = image_props(cstream, False)
        primary = add(b"av01", cstream, props + color_props)
        if alpha is not None:
            astream = strip_obus(alpha)
            aprops, _, _ = image_props(astream, True)
            aid = add(b"av01", astream, aprops, [(b"auxl", primary)])
            if prem:
                items[0][4].append((b"prem", aid))
    else:
        rows, cols, ow, oh = grid
        tiles = [strip_obus(t) for t in color]
        tile_ids = []
        for t in tiles:
            props, w, h = image_props(t, False)
            tile_ids.append(add(b"av01", t, props + color_props))
        gdata = bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", ow,
                                                                 oh)
        _, _, s = dims(tiles[0])
        nch = 1 if s.mono_chrome else 3
        gprops = [_full(b"ispe", 0, 0, struct.pack(">II", ow, oh)),
                  _full(b"pixi", 0, 0, bytes([nch] + [s.BitDepth] * nch))
                  ] + color_props
        primary = add(b"grid", gdata, gprops,
                      [(b"dimg", t) for t in tile_ids])
        for it in items:
            if it[0] in tile_ids:
                it[3] = it[3][:3]
    # property container and associations
    all_props = []
    assoc = []
    for iid, kind, data, props, refs in items:
        idx = []
        for p in props:
            all_props.append(p)
            idx.append(len(all_props))
        assoc.append((iid, idx))
    ipco = _box(b"ipco", b"".join(all_props))
    ipma_body = struct.pack(">I", len(assoc))
    for iid, idx in assoc:
        ipma_body += struct.pack(">HB", iid, len(idx))
        for k in idx:
            ipma_body += bytes([0x80 | k])
    ipma = _full(b"ipma", 0, 0, ipma_body)
    iprp = _box(b"iprp", ipco + ipma)
    hdlr = _full(b"hdlr", 0, 0, b"\0\0\0\0pict" + b"\0" * 12 + b"\0")
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", primary))
    infes = b"".join(_full(b"infe", 2, 0, struct.pack(">HH", iid, 0) + kind
                           + b"\0") for iid, kind, *_ in items)
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", len(items)) + infes)
    refs = b""
    for iid, kind, data, props, rr in items:
        by_type = {}
        for t, to in rr:
            by_type.setdefault(t, []).append(to)
        for t, tos in by_type.items():
            refs += _box(t, struct.pack(">HH", iid, len(tos)) +
                         b"".join(struct.pack(">H", x) for x in tos))
    iref = _full(b"iref", 0, 0, refs) if refs else b""
    ftyp = _box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))

    def build(offsets):
        if idat:
            method = 1
        else:
            method = 0
        body = b""
        if iloc_version == 0 and not idat:
            body = bytes([0x44, 0x00]) + struct.pack(">H", len(items))
            for (iid, kind, data, props, rr), off in zip(items, offsets):
                body += struct.pack(">HHHII", iid, 0, 1, off, len(data))
            iloc = _full(b"iloc", 0, 0, body)
        else:
            ver = max(1, iloc_version)
            body = bytes([0x44, 0x00])
            body += struct.pack(">H" if ver < 2 else ">I", len(items))
            for (iid, kind, data, props, rr), off in zip(items, offsets):
                body += struct.pack(">H" if ver < 2 else ">I", iid)
                body += struct.pack(">HHH", method, 0, 1)
                body += struct.pack(">II", off, len(data))
            iloc = _full(b"iloc", ver, 0, body)
        extra = b""
        if idat:
            extra = _box(b"idat", b"".join(it[2] for it in items))
        meta = _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref +
                     iprp + extra)
        return meta

    if idat:
        offs, pos = [], 0
        for it in items:
            offs.append(pos)
            pos += len(it[2])
        meta = build(offs)
        return ftyp + meta
    meta = build([0] * len(items))
    start = len(ftyp) + len(meta) + 8
    offs, pos = [], start
    for it in items:
        offs.append(pos)
        pos += len(it[2])
    meta = build(offs)
    mdat = _box(b"mdat", b"".join(it[2] for it in items))
    return ftyp + meta + mdat


def rewrite_colr(data: bytes, nclx) -> bytes:
    """A PIL-made single-item AVIF with its colr nclx replaced (the same
    AV1 stream, another matrix / range for libavif's conversion)."""
    from pointdreamer_tpu_torch import avif
    f = avif.parse(data)
    prim = f.items[f.primary]
    color = avif._item_data(f, prim)
    alpha = None
    for it in f.items.values():
        if f.primary in it.refs.get(b"auxl", []):
            alpha = avif._item_data(f, it)
    return write_avif(color, alpha, nclx=nclx)


# ---------------------------------------------------------------------------
# rav1e through ctypes (segmentation, which libaom leaves off for stills)

_RAV1E = None


def rav1e():
    global _RAV1E
    if _RAV1E is None:
        path = ctypes.util.find_library("rav1e")
        if path is None:
            return None
        r = ctypes.CDLL(path)
        vp = ctypes.c_void_p
        for name, res, args in (
                ("rav1e_config_default", vp, []),
                ("rav1e_config_parse", ctypes.c_int,
                 [vp, ctypes.c_char_p, ctypes.c_char_p]),
                ("rav1e_config_set_pixel_format", ctypes.c_int,
                 [vp, ctypes.c_uint8, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int]),
                ("rav1e_context_new", vp, [vp]),
                ("rav1e_frame_new", vp, [vp]),
                ("rav1e_frame_fill_plane", None,
                 [vp, ctypes.c_int, vp, ctypes.c_size_t, ctypes.c_ssize_t,
                  ctypes.c_int]),
                ("rav1e_send_frame", ctypes.c_int, [vp, vp]),
                ("rav1e_receive_packet", ctypes.c_int, [vp, vp]),
                ("rav1e_packet_unref", None, [vp]),
                ("rav1e_frame_unref", None, [vp]),
                ("rav1e_context_unref", None, [vp]),
                ("rav1e_config_unref", None, [vp])):
            fn = getattr(r, name)
            fn.restype = res
            fn.argtypes = args
        _RAV1E = r
    return _RAV1E


def rav1e_encode(planes, options, bit_depth=8, chroma=0):
    """One key frame from rav1e (`chroma`: 0 4:2:0, 1 4:2:2, 2 4:4:4):
    the OBUs."""
    r = rav1e()
    h, w = planes[0].shape
    cfg = r.rav1e_config_default()
    for k, v in [("width", w), ("height", h)] + list(options.items()):
        assert r.rav1e_config_parse(cfg, k.encode(), str(v).encode()) == 0
    assert r.rav1e_config_set_pixel_format(cfg, bit_depth, chroma, 0, 1) == 0
    ctx = r.rav1e_context_new(cfg)
    frame = r.rav1e_frame_new(ctx)
    bw = 2 if bit_depth > 8 else 1
    for p, a in enumerate(planes):
        a = np.ascontiguousarray(a.astype(np.uint16 if bw == 2 else np.uint8))
        r.rav1e_frame_fill_plane(frame, p, a.ctypes.data, a.nbytes,
                                 a.shape[1] * bw, bw)
    r.rav1e_send_frame(ctx, frame)
    r.rav1e_send_frame(ctx, None)
    out = b""
    for _ in range(64):
        pkt = ctypes.c_void_p()
        st = r.rav1e_receive_packet(ctx, ctypes.byref(pkt))
        if st == 0 and pkt.value:
            data = ctypes.c_void_p.from_address(pkt.value).value
            ln = ctypes.c_size_t.from_address(pkt.value + 8).value
            out += ctypes.string_at(data, ln)
            r.rav1e_packet_unref(pkt.value)
        elif st in (1, 3) or st < 0:            # need data, limit, failure
            break
    r.rav1e_frame_unref(frame)
    r.rav1e_context_unref(ctx)
    r.rav1e_config_unref(cfg)
    return out


def rgb_to_yuv(rgb, ssx, ssy, bit_depth=8):
    """BT.601 full-range planes of an RGB uint8 image, subsampled by
    dropping samples (input for the ctypes encoders)."""
    a = rgb.astype(np.float64)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 128 + (b - y) / 1.772
    v = 128 + (r - y) / 1.402
    mx = (1 << bit_depth) - 1
    sc = (1 << bit_depth) / 256
    out = [np.clip(np.round(c * sc), 0, mx).astype(np.uint16)
           for c in (y, u, v)]
    out[1] = out[1][::1 << ssy, ::1 << ssx]
    out[2] = out[2][::1 << ssy, ::1 << ssx]
    return out
