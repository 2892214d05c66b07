"""Host-side IO: PLY point clouds and meshes, OBJ/MTL meshes, images.

Twin of pointdreamer_tpu's core/io.py without PIL or cv2.  PNGs are
written with zlib + struct (8-bit, filter 0).  An image file is told
apart by its content, as PIL's `Image.open` tells it: every plugin of PIL
12.1's `Image.ID`, in its order, with the header checks of each plugin's
`_open` whose failure sends PIL on to the next one (the extension only
where no plugin takes the content).  It is read with PIL 12.1's pixels in
PIL's mode (`imagemode.ModeImage`): PNG (every colour type and depth,
palettes and tRNS, Adam7), PBM/PGM/PPM at any maxval, PFM and PIL's own
PNM variants, BMP (palettes, RLE, 16/24/32-bit) and bare DIB, JPEG
(`jpeg.py`), GIF (`gif.py`), TIFF (`tiff.py`), WebP (`webp.py`), TGA
(`tga.py`), PCX and DCX (`pcx.py`, `dcx.py`), SGI (`sgi.py`), QOI
(`qoi.py`), ICO and CUR (`ico.py`), MSP (`msp.py`), XBM (`xbm.py`), DDS
and FTEX with BC1-BC7 (`dds.py`, `bcn.py`), PSD (`psd.py`), ICNS
(`icns.py`), BLP (`blp.py`), IM and IMT (`im.py`), SPIDER (`spider.py`),
FITS (`fits.py`), XPM (`xpm.py`), FLI (`fli.py`), SUN (`sun.py`), PCD
(`pcd.py`), IPTC (`iptc.py`), GBR, McIdas, PIXAR and XV thumbnails
(`smallimg.py`), JPEG 2000 (JP2 files and raw codestreams:
`jpeg2000.py`), AVIF (the first frame, through the AV1 decoder `av1_*.py`
and libavif's YUV to RGB: `avif.py`, `avif_rgb.py`).  EPS, MPEG, WMF,
BUFR, GRIB and HDF5 are identified and refused (`refused.py`).  `load_rgb` / `load_rgba` are
PIL's convert("RGB") / convert("RGBA") from that mode.  Image writers take
numpy arrays or torch tensors; a device tensor is quantized to uint8 on
the device before the one host transfer.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from . import (avif, blp, dcx, dds, fits, fli, icns, ico, im, iptc, jp2, msp,
               pcd, pcx, psd, qoi, refused, sgi, smallimg, spider, sun, tga,
               xbm, xpm)
from .gif import decode_gif
from .imagemode import (ModeImage, NotThisFormat, natural, of_array, to_rgb,
                        to_rgba)
from .jpeg import decode_jpeg, decode_jpeg_image  # noqa: F401 (re-export)
from .jpeg2000 import decode_jpeg2000
from .tiff import decode_tiff
from .webp import decode_webp

# --------------------------------------------------------------------------
# PLY
# --------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_xyzrgb(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """PLY with x,y,z (+ red,green,blue) vertex properties, ascii or
    binary_little_endian.  Returns (xyz float32 [N,3], rgb uint8 [N,3])."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []
        cur_element = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur_element = tok[1]
                if cur_element == "vertex":
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and cur_element == "vertex":
                if tok[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((tok[-1], _PLY_TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt == "ascii":
            rows = [f.readline().split()[: len(props)]
                    for _ in range(n_vertex)]
            arr = np.array(rows, dtype=np.float64)
            data = {name: arr[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + t) for name, t in props])
            rec = np.frombuffer(f.read(dtype.itemsize * n_vertex),
                                dtype=dtype, count=n_vertex)
            data = {name: rec[name] for name, _ in props}
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
    xyz = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    if "red" in data:
        rgb = np.stack([data["red"], data["green"], data["blue"]], 1)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255)
        rgb = rgb.astype(np.uint8)
    else:
        rgb = np.zeros((n_vertex, 3), dtype=np.uint8)
    return xyz, rgb


def load_ply_mesh(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY MESH (vertex + face elements), ascii or
    binary_little_endian.  Returns {'vertices' [N,3] f32,
    'faces' [F,3] i64} (quads are fan-triangulated).  The point2surf GT
    meshes (eval/eval_point2surf/evaluation.py:221-305 load them with
    trimesh) are plain tri meshes in this format."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []           # (name, count, [(prop, dtype) | list])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property" and cur is not None:
                if tok[1] == "list":
                    cur[2].append(("list", _PLY_TYPES[tok[2]],
                                   _PLY_TYPES[tok[3]], tok[-1]))
                else:
                    cur[2].append(("scalar", _PLY_TYPES[tok[1]], tok[-1]))
            elif tok[0] == "end_header":
                break

        verts, faces = None, []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    idx = {p[-1]: i for i, p in enumerate(props)
                           if p[0] == "scalar"}
                    arr = np.array([[r[idx["x"]], r[idx["y"]], r[idx["z"]]]
                                    for r in rows], np.float32)
                    verts = arr
                elif name == "face":
                    for r in rows:
                        k = int(r[0])
                        poly = [int(v) for v in r[1:1 + k]]
                        for j in range(1, k - 1):
                            faces.append([poly[0], poly[j], poly[j + 1]])
            elif fmt == "binary_little_endian":
                if all(p[0] == "scalar" for p in props):
                    dtype = np.dtype([(p[-1], "<" + p[1]) for p in props])
                    rec = np.frombuffer(f.read(dtype.itemsize * count),
                                        dtype=dtype, count=count)
                    if name == "vertex":
                        verts = np.stack([rec["x"], rec["y"], rec["z"]],
                                         1).astype(np.float32)
                else:
                    # list property (face indices): parse sequentially
                    for _ in range(count):
                        for p in props:
                            if p[0] == "list":
                                cnt_dt = np.dtype("<" + p[1])
                                val_dt = np.dtype("<" + p[2])
                                k = int(np.frombuffer(
                                    f.read(cnt_dt.itemsize), cnt_dt)[0])
                                poly = np.frombuffer(
                                    f.read(val_dt.itemsize * k), val_dt,
                                    count=k).astype(np.int64)
                                if name == "face":
                                    for j in range(1, k - 1):
                                        faces.append([poly[0], poly[j],
                                                      poly[j + 1]])
                            else:
                                f.read(np.dtype("<" + p[1]).itemsize)
            else:
                raise ValueError(f"{path}: unsupported PLY format {fmt}")

    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    return {"vertices": verts,
            "faces": np.asarray(faces, np.int64).reshape(-1, 3)}


def save_colored_pc_ply(xyz, rgb01, path: str) -> None:
    """xyz float + rgb (float in [0,1] or uint8) as binary PLY."""
    xyz = np.asarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb01)
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    n = len(xyz)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\n"
              "property uchar blue\nend_header\n")
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


# --------------------------------------------------------------------------
# OBJ / MTL
# --------------------------------------------------------------------------

def save_textured_obj(vertices, uvs, faces, face_uv_idx,
                      obj_path: str) -> None:
    """v/vt/f OBJ + companion MTL referencing a PNG texture (the
    reference's savemeshtes2 format: 1-based `f v/vt`, one material)."""
    fol = os.path.dirname(obj_path)
    os.makedirs(fol or ".", exist_ok=True)
    na = os.path.splitext(os.path.basename(obj_path))[0]
    with open(os.path.join(fol, na + ".mtl"), "w") as fid:
        fid.write("newmtl material_0\nKd 1 1 1\nKa 0 0 0\nKs 0.4 0.4 0.4\n"
                  f"Ns 10\nillum 2\nmap_Kd {na}.png\n")
    v = np.asarray(vertices, dtype=np.float64)
    vt = np.asarray(uvs, dtype=np.float64)
    fv = np.asarray(faces, dtype=np.int64) + 1
    ft = np.asarray(face_uv_idx, dtype=np.int64) + 1
    fidx = np.empty((len(fv), 6), np.int64)
    fidx[:, 0::2], fidx[:, 1::2] = fv, ft
    body = "".join([
        f"mtllib {na}.mtl\n",
        ("v %f %f %f\n" * len(v)) % tuple(v.ravel().tolist()),
        ("vt %f %f\n" * len(vt)) % tuple(vt.ravel().tolist()),
        "usemtl material_0\n",
        ("f %d/%d %d/%d %d/%d\n" * len(fv)) % tuple(fidx.ravel().tolist()),
    ])
    with open(obj_path, "w") as fid:
        fid.write(body)


def save_obj(vertices, faces, path: str) -> None:
    """Plain v/f OBJ."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.asarray(vertices, dtype=np.float64)
    fv = np.asarray(faces, dtype=np.int64) + 1
    body = (("v %f %f %f\n" * len(v)) % tuple(v.ravel().tolist())
            + ("f %d %d %d\n" * len(fv)) % tuple(fv.ravel().tolist()))
    with open(path, "w") as fid:
        fid.write(body)


def load_obj(path: str) -> Dict[str, np.ndarray]:
    """Minimal OBJ loader: v, vt, f (v, v/vt or v/vt/vn); fan-triangulates."""
    verts, uvs, faces, face_uv = [], [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                uvs.append([float(x) for x in tok[1:3]])
            elif tok[0] == "f":
                idx = []
                for w in tok[1:]:
                    parts = w.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    idx.append((vi, ti))
                for i in range(1, len(idx) - 1):
                    tri = [idx[0], idx[i], idx[i + 1]]
                    faces.append([t[0] - 1 if t[0] > 0 else len(verts) + t[0]
                                  for t in tri])
                    face_uv.append([t[1] - 1 for t in tri])
    out = {"vertices": np.asarray(verts, dtype=np.float32),
           "faces": np.asarray(faces, dtype=np.int64)}
    if uvs:
        out["uvs"] = np.asarray(uvs, dtype=np.float32)
        out["face_uv_idx"] = np.asarray(face_uv, dtype=np.int64)
    return out


# --------------------------------------------------------------------------
# PNG (8-bit, zlib + struct)
# --------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}      # channels -> PNG color type
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, level: int = 1) -> bytes:
    """uint8 [H,W] or [H,W,C] (C in 1..4) -> PNG bytes."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        raise TypeError(f"encode_png wants uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png: {c} channels")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(a).reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: bytes, rows: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of one (sub-)image -> uint8 [rows,
    rowbytes]."""
    out = np.zeros((rows, rowbytes), np.uint8)
    prev = bytes(rowbytes)
    for y in range(rows):
        o = y * (rowbytes + 1)
        ft = raw[o]
        line = np.frombuffer(raw, np.uint8, rowbytes, o + 1)
        if ft == 0:
            cur = line
        elif ft == 1:                    # sub: a running sum per channel
            pad = -rowbytes % bpp
            x = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(
                -1, bpp)
            cur = (np.cumsum(x, 0, np.uint64) & 255).astype(
                np.uint8).reshape(-1)[:rowbytes]
        elif ft == 2:                    # up
            cur = line + np.frombuffer(prev, np.uint8)
        elif ft in (3, 4):               # average, paeth: sequential
            b = bytearray(line.tobytes())
            up = prev
            for i in range(rowbytes):
                a = b[i - bpp] if i >= bpp else 0
                if ft == 3:
                    b[i] = (b[i] + ((a + up[i]) >> 1)) & 255
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    u = up[i]
                    pa, pb, pc = abs(u - c), abs(a - c), abs(a + u - 2 * c)
                    pred = a if pa <= pb and pa <= pc else u if pb <= pc \
                        else c
                    b[i] = (b[i] + pred) & 255
            cur = np.frombuffer(bytes(b), np.uint8)
        else:
            raise ValueError(f"bad PNG filter {ft}")
        out[y] = cur
        prev = cur.tobytes()
    return out


def _png_samples(rows: np.ndarray, width: int, depth: int,
                 samples: int) -> np.ndarray:
    """Unfiltered rows -> sample values [h, width, samples] (int64; MSB
    first below 8 bits, big-endian at 16)."""
    h = rows.shape[0]
    if depth == 16:
        v = rows[:, :2 * width * samples].reshape(h, -1, 2).astype(np.int64)
        return (v[..., 0] << 8 | v[..., 1]).reshape(h, width, samples)
    if depth == 8:
        return rows[:, :width * samples].reshape(h, width, samples).astype(
            np.int64)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    weights = 1 << np.arange(depth - 1, -1, -1)
    v = (bits.reshape(h, width, depth) * weights).sum(-1)
    return v.reshape(h, width, 1).astype(np.int64)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H,W,C] as PIL's conversions give it: grey (C 1),
    grey + alpha (2), RGB (3), RGBA (4).  Every colour type and bit depth,
    Adam7 interlacing, all five filters.  Palettes are expanded through
    PLTE; a tRNS chunk becomes an alpha channel (per palette entry, or a
    grey or RGB key compared with the 8-bit values, as PIL's
    convert("RGBA") does).  1, 2 and 4-bit grey scale by 255, 85 and 17;
    16-bit colour keeps the high byte and 16-bit grey is clipped at 255
    (PIL's I;16 -> RGB)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype] \
            or interlace > 1:
        raise ValueError(f"unsupported PNG (depth {depth}, type {ctype}, "
                         f"interlace {interlace})")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    c = _PNG_SAMPLES[ctype]
    bpp = max(1, c * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        rowbytes = (w * c * depth + 7) // 8
        need = h * (rowbytes + 1)
        if len(raw) < need:
            raise ValueError("PNG: truncated image data")
        v = _png_samples(_unfilter(raw, h, rowbytes, bpp), w, depth, c)
    else:
        v = np.zeros((h, w, c), np.int64)
        o = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            rowbytes = (pw * c * depth + 7) // 8
            n = ph * (rowbytes + 1)
            if len(raw) < o + n:
                raise ValueError("PNG: truncated image data")
            v[y0::dy, x0::dx] = _png_samples(
                _unfilter(raw[o:o + n], ph, rowbytes, bpp), pw, depth, c)
            o += n
    if ctype == 3:
        idx = v[..., 0]
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        out = pal[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
            out = np.concatenate([out, alpha[idx][..., None]], -1)
        return out
    if depth < 8:
        out = (v * {1: 255, 2: 85, 4: 17}[depth]).astype(np.uint8)
    elif depth == 16 and ctype == 0:
        out = np.minimum(v, 255).astype(np.uint8)
    elif depth == 16:
        out = (v >> 8).astype(np.uint8)
    else:
        out = v.astype(np.uint8)
    if trns is not None and ctype in (0, 2):
        key = np.array(struct.unpack(f">{c}H", trns[:2 * c]), np.int64)
        alpha = np.where((out.astype(np.int64) == key).all(-1), 0, 255)
        out = np.concatenate([out, alpha[..., None].astype(np.uint8)], -1)
    return out


def to_uint8(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        if img.dtype != torch.uint8:
            img = torch.clamp(img.float() * 255.0 + 0.5, 0.0, 255.0).to(
                torch.uint8)
        return img.cpu().numpy()
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_rgb(img01, path: str, flip_vertical: bool = False) -> None:
    """HWC (or CHW) float [0,1] or uint8 image -> PNG (row 0 = top)."""
    arr = to_uint8(img01)
    if arr.ndim == 3 and arr.shape[0] in (3, 4) \
            and arr.shape[-1] not in (3, 4):
        arr = np.transpose(arr, (1, 2, 0))
    if flip_vertical:
        arr = arr[::-1]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(arr)))


def load_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


# PIL's PpmImagePlugin: the magic numbers it opens and their modes
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
              b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_PNM_BANDS = {"L": 1, "I": 1, "RGB": 3, "RGBA": 4, "CMYK": 4, "P": 1}
_PNM_SPACE = b" \t\n\x0b\x0c\r"


def _pnm_token(data: bytes, pos: int):
    """PpmImageFile._read_token: skip leading whitespace, drop `#` comments
    up to a CR or LF (also inside a token), end at whitespace (consumed);
    at most 10 characters.  Returns (token, position after it)."""
    tok = b""
    while len(tok) <= 10:
        c = data[pos:pos + 1]
        pos += 1
        if not c:
            break
        if c in _PNM_SPACE:
            if not tok:
                continue
            break
        if c == b"#":
            while data[pos:pos + 1] not in (b"\r", b"\n", b""):
                pos += 1
            pos += 1
            continue
        tok += c
    if not tok:
        raise ValueError("PNM: reached the end of the file in the header")
    if len(tok) > 10:
        raise ValueError(f"PNM: header token too long: {tok!r}")
    return tok, pos


def _pnm_plain(data: bytes, pos: int, count: int, maxval: int,
               out_max: int) -> np.ndarray:
    """PpmPlainDecoder._decode_blocks: whitespace-separated decimal samples
    (comments dropped), each round(v / maxval * out_max)."""
    body = data[pos:]
    while b"#" in body:
        i = body.index(b"#")
        ends = [j for j in (body.find(b"\n", i), body.find(b"\r", i))
                if j >= 0]
        body = body[:i] + (body[min(ends) + 1:] if ends else b"")
    toks = body.split()[:count]
    if len(toks) < count:
        raise ValueError(f"PNM: {len(toks)} of {count} plain samples")
    if any(len(t) > 10 for t in toks):
        raise ValueError("PNM: a plain sample longer than 10 characters")
    v = np.array([int(t) for t in toks], np.int64)
    if (v > maxval).any():
        raise ValueError(f"PNM: a sample above maxval {maxval}")
    return np.round(v / maxval * out_max).astype(np.int64)


def decode_pnm(data: bytes) -> ModeImage:
    """PBM, PGM, PPM and PFM bytes as PIL 12.1's PpmImagePlugin reads them
    (every magic number it opens: P1-P6, Pf and PIL's own P0CMYK, PyP,
    PyRGBA, PyCMYK).  Bitmaps are mode "1" (PBM's 1 is black); maxval 255
    is read as it is, any other maxval from 1 to 65535 scaled to 255 as
    round(v / maxval * 255) (two big-endian bytes a sample above 255),
    except a PGM above 255, which is mode "I" scaled to 65535 (as it is at
    65535); `Pf` is mode "F", little-endian where its scale is negative,
    rows bottom-up; `PyP` is mode "P" with PIL's empty (black) palette."""
    magic, pos = b"", 0
    while pos < min(len(data), 6) and data[pos:pos + 1] not in _PNM_SPACE:
        magic += data[pos:pos + 1]
        pos += 1
    pos += 1                                    # the whitespace after it
    mode = _PNM_MODES.get(magic)
    if mode is None:
        raise ValueError(f"not a PNM file (magic {magic!r})")
    w_tok, pos = _pnm_token(data, pos)
    h_tok, pos = _pnm_token(data, pos)
    w, h = int(w_tok), int(h_tok)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if magic == b"P4":
            stride = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, h * stride, pos)
            bits = np.unpackbits(rows.reshape(h, stride), axis=1)[:, :w]
        else:
            body = b"".join(ln.split(b"#")[0]
                            for ln in data[pos:].splitlines())
            body = b"".join(body.split())[:h * w]
            if len(body) < h * w or body.strip(b"01"):
                raise ValueError("PBM: bad or too few plain samples")
            bits = (np.frombuffer(body, np.uint8) - 48).reshape(h, w)
        return ModeImage("1", np.where(bits == 1, 0, 255).astype(np.uint8))
    if mode == "F":
        scale_tok, pos = _pnm_token(data, pos)
        scale = float(scale_tok)
        if scale == 0 or not np.isfinite(scale):
            raise ValueError("PFM: scale must be finite and non-zero")
        a = np.frombuffer(data, "<f4" if scale < 0 else ">f4", h * w, pos)
        return ModeImage("F", a.reshape(h, w)[::-1].astype(np.float32))
    maxval_tok, pos = _pnm_token(data, pos)
    maxval = int(maxval_tok)
    if not 0 < maxval < 65536:
        raise ValueError("PNM: maxval must be greater than 0 and less than "
                         "65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    c = _PNM_BANDS[mode]
    out_max = 65535 if mode == "I" else 255
    n = h * w * c
    if plain:
        v = _pnm_plain(data, pos, n, maxval, out_max)
    else:
        wide = maxval > 255
        if len(data) - pos < n * (2 if wide else 1):
            raise ValueError("PNM: image data is truncated")
        v = np.frombuffer(data, ">u2" if wide else np.uint8, n,
                          pos).astype(np.int64)
        if not (maxval == 255 or (maxval == 65535 and mode == "I")):
            v = np.minimum(out_max, np.round(v / maxval * out_max)).astype(
                np.int64)
    if mode == "I":
        return ModeImage("I", v.reshape(h, w).astype(np.int32))
    v = v.astype(np.uint8).reshape(h, w, c)
    if mode == "P":
        return ModeImage("P", v[..., 0].copy(), np.zeros((256, 3), np.uint8))
    if mode == "CMYK":
        return ModeImage("CMYK", v)
    return of_array(v)


# 32-bit BI_BITFIELDS masks (r, g, b, a) PIL reads, and their channel
# order from the low byte up
_BMP_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's BmpRleDecoder, step for step (its delta escape skips two bytes
    before reading the offsets; absolute runs of RLE4 keep whole bytes;
    the word alignment follows the file offset)."""
    out = bytearray()
    x = 0
    n = len(data)
    while len(out) < w * h:
        if pos + 2 > n:
            break
        num, byte = data[pos], data[pos + 1]
        pos += 2
        if num:
            if x + num > w:
                num = max(0, w - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 15))
                out += (pair * ((num + 1) // 2))[:num]
            else:
                out += bytes((byte,)) * num
            x += num
        elif byte == 0:                          # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                          # end of bitmap
            break
        elif byte == 2:                          # delta
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("BMP: truncated RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                    # absolute run
            count = byte // 2 if rle4 else byte
            chunk = data[pos:pos + count]
            pos += len(chunk)
            if rle4:
                for b in chunk:
                    out += bytes((b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < count:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < w * h:
        raise ValueError("BMP: not enough image data")
    return bytes(out[:w * h])


def decode_bmp(data: bytes, raw_alpha: bool = False) -> np.ndarray:
    """BMP bytes -> uint8 [H,W,3] (or [H,W,4] for the 32-bit bit-field
    layouts with alpha, and for uncompressed 32-bit pixels with
    `raw_alpha`, as PIL reads a cursor's), row 0 at the top, as PIL reads
    them: 1, 4 and 8-bit palettes, RLE8 and RLE4, 16-bit 5-5-5 and 5-6-5,
    24 and 32-bit (alpha dropped unless bit fields name it); core (OS/2)
    and info headers."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    offset, hsize = struct.unpack_from("<II", data, 10)
    hp = 18
    if hsize == 12:
        w, h, _, bpp = struct.unpack_from("<HHHH", data, hp)
        comp, colors, pal_pad, flip = 0, 0, 3, False
        masks_end = hp + 8
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = data[hp + 7] == 0xFF
        w, = struct.unpack_from("<i", data, hp)
        hraw, = struct.unpack_from("<I", data, hp + 4)
        h = 2 ** 32 - hraw if flip else hraw
        _, bpp, comp = struct.unpack_from("<HHI", data, hp + 8)
        colors, = struct.unpack_from("<I", data, hp + 28)
        pal_pad = 4
        masks_end = 14 + hsize
    else:
        raise ValueError(f"unsupported BMP header ({hsize} bytes)")
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"unsupported BMP pixel depth ({bpp})")
    colors = colors or (1 << bpp)
    if offset == 14 + hsize and bpp <= 8:
        offset += 4 * colors
    raw_mode = {1: "P", 4: "P", 8: "P", 16: "BGR;15", 24: "BGR",
                32: "BGRA" if raw_alpha and comp == 0 else "BGRX"}[bpp]
    if comp == 3:                                # BI_BITFIELDS
        if hsize >= 52:
            masks = struct.unpack_from("<IIII", data, hp + 36)
            if hsize < 56:
                masks = masks[:3] + (0,)
        else:
            masks = struct.unpack_from("<III", data, masks_end) + (0,)
            masks_end += 12
        if bpp == 32 and masks in _BMP_MASKS32:
            raw_mode = _BMP_MASKS32[masks]
        elif bpp == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            raw_mode = "BGR"
        elif bpp == 16 and masks[:3] == (0xF800, 0x7E0, 0x1F):
            raw_mode = "BGR;16"
        elif bpp == 16 and masks[:3] == (0x7C00, 0x3E0, 0x1F):
            raw_mode = "BGR;15"
        else:
            raise ValueError("unsupported BMP bit-field layout")
    elif comp not in (0, 1, 2):
        raise ValueError(f"unsupported BMP compression ({comp})")
    pal = None
    stride = ((w * bpp + 31) >> 3) & ~3
    if raw_mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size ({colors})")
        p = np.frombuffer(data, np.uint8, pal_pad * colors, masks_end)
        p = p.reshape(colors, pal_pad)[:, 2::-1]
        grey = (0, 255) if colors == 2 else range(colors)
        if all((p[i] == v).all() for i, v in enumerate(grey)) \
                and comp == 0:
            # PIL drops a grey palette and reads the raster as "1" (two
            # colours) or "L", whatever the depth: rows still `stride`
            # apart, zeros past the end
            rb = 1 if colors == 2 else 8
            need = (w * rb + 7) // 8
            buf = data[offset:offset + (h - 1) * stride + need]
            buf = np.frombuffer(buf + bytes((h - 1) * stride + need
                                            - len(buf)), np.uint8)
            rows = np.stack([buf[r * stride:r * stride + need]
                             for r in range(h)])
            if rb == 1:
                rows = np.unpackbits(rows, axis=1)[:, :w] * 255
            img = np.repeat(rows[:, :w, None], 3, -1).astype(np.uint8)
            return np.ascontiguousarray(img if flip else img[::-1])
        pal = np.zeros((max(256, colors), 3), np.uint8)
        pal[:colors] = p
    if comp in (1, 2):                           # RLE8, RLE4
        idx = np.frombuffer(_bmp_rle(data, offset, w, h, comp == 2),
                            np.uint8).reshape(h, w)
    else:
        rows = np.frombuffer(data, np.uint8, h * stride, offset).reshape(
            h, stride)
        if bpp < 8:
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(h, w, bpp)
            idx = (bits * (1 << np.arange(bpp - 1, -1, -1))).sum(-1)
        elif bpp == 8:
            idx = rows[:, :w]
        elif bpp == 16:
            v = rows[:, :2 * w].reshape(h, w, 2).astype(np.int64)
            v = v[..., 0] | (v[..., 1] << 8)
            if raw_mode == "BGR;16":
                r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
                idx = np.stack([r * 255 // 31, g * 255 // 63,
                                b * 255 // 31], -1)
            else:
                r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
                idx = np.stack([r * 255 // 31, g * 255 // 31,
                                b * 255 // 31], -1)
            idx = idx.astype(np.uint8)
        else:
            c = bpp // 8
            px = rows[:, :w * c].reshape(h, w, c)
            order = raw_mode
            chans = [px[..., order.index(k)] for k in "RGB"]
            if "A" in order:
                chans.append(px[..., order.index("A")])
            idx = np.stack(chans, -1)
    img = pal[idx.astype(np.int64)] if pal is not None else idx
    return np.ascontiguousarray(img if flip else img[::-1])


def _png_image(data: bytes) -> ModeImage:
    return of_array(decode_png(data))


def _bmp_image(data: bytes) -> ModeImage:
    return of_array(decode_bmp(data))


def _webp_image(data: bytes) -> ModeImage:
    return of_array(decode_webp(data))


def _pnm_accepts(data: bytes) -> bool:
    """PpmImagePlugin's prefix and a magic number it opens."""
    magic = data[:6]
    for i, c in enumerate(magic):
        if c in _PNM_SPACE:
            magic = magic[:i]
            break
    return magic in _PNM_MODES


def _opens(probe):
    """A plugin's test from its header probe: False where the probe fails
    as PIL's `_open` does when PIL goes on to the next plugin (the
    exceptions `Image.open` catches, or `NotThisFormat`), True where it
    passes or fails otherwise (PIL then raises: the file is that
    plugin's, and its decoder raises the same error)."""
    def opens(data: bytes) -> bool:
        try:
            probe(data)
        except (NotThisFormat, SyntaxError, IndexError, TypeError, KeyError,
                EOFError, struct.error):
            return False
        except Exception:
            return True
        return True
    return opens


def _when(accepts, probe):
    """PIL's `_accept` on the first 16 bytes, then its `_open` checks."""
    opens = _opens(probe)
    return lambda d: bool(accepts(d[:16])) and opens(d)


# PIL 12.1's plugins in the order `Image.open` tries them (`Image.ID`: its
# preinit plugins, then the rest by module name), each with the test that
# makes it take a file and the decoder here; the name is PIL's `format`
# ("PNM" for PIL's "PPM")
_PLUGINS = (
    ("BMP", lambda d: d[:2] == b"BM", _bmp_image),
    ("DIB", ico.dib_accepts, ico.decode_dib),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff", decode_jpeg_image),
    ("PNM", _pnm_accepts, decode_pnm),
    ("PNG", lambda d: d[:8] == _PNG_SIG, _png_image),
    ("AVIF", _opens(avif.probe), avif.decode_avif_image),
    ("BLP", _when(blp.accepts, blp.probe), blp.decode_blp),
    ("BUFR", refused.bufr_accepts, refused.stub_refused("BUFR")),
    ("CUR", ico.cur_accepts, ico.decode_cur),
    ("PCX", _opens(pcx.probe), pcx.decode_pcx),
    ("DCX", _opens(dcx.probe), dcx.decode_dcx),
    ("DDS", _when(dds.accepts, dds.probe), dds.decode_dds),
    ("EPS", _when(refused.eps_accepts, refused.eps_probe),
     refused.eps_refused),
    ("FITS", _when(fits.accepts, fits.probe), fits.decode_fits),
    ("FLI", _when(fli.accepts, fli.probe), fli.decode_fli),
    ("FTEX", _when(dds.ftex_accepts, dds.ftex_probe), dds.decode_ftex),
    ("GBR", _when(smallimg.gbr_accepts, smallimg.gbr_probe),
     smallimg.decode_gbr),
    ("GRIB", refused.grib_accepts, refused.stub_refused("GRIB")),
    ("HDF5", refused.hdf5_accepts, refused.stub_refused("HDF5")),
    ("JPEG2000", _when(jp2.accepts, jp2.probe), decode_jpeg2000),
    ("ICNS", _when(icns.accepts, icns.probe), icns.decode_icns),
    ("ICO", ico.ico_accepts, ico.decode_ico),
    ("IM", _opens(im.probe), im.decode_im),
    ("IMT", _opens(im.imt_probe), im.decode_imt),
    ("IPTC", _opens(iptc.probe), iptc.decode_iptc),
    ("MCIDAS", _when(smallimg.mcidas_accepts, smallimg.mcidas_probe),
     smallimg.decode_mcidas),
    ("MPEG", _opens(refused.mpeg_probe), refused.mpeg_refused),
    ("TIFF", lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00",
                                 b"MM\x00+"), decode_tiff),
    ("MSP", msp.header_ok, msp.decode_msp),
    ("PCD", _opens(pcd.probe), pcd.decode_pcd),
    ("PIXAR", _when(smallimg.pixar_accepts, smallimg.pixar_probe),
     smallimg.decode_pixar),
    ("PSD", _when(psd.accepts, psd.probe), psd.decode_psd),
    ("QOI", qoi.accepts, qoi.decode_qoi),
    ("SGI", sgi.accepts, sgi.decode_sgi),
    ("SPIDER", _opens(spider.probe), spider.decode_spider),
    ("SUN", _when(sun.accepts, sun.probe), sun.decode_sun),
    ("TGA", tga.header_ok, tga.decode_tga),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP",
     _webp_image),
    ("WMF", _opens(refused.wmf_probe), refused.stub_refused("WMF")),
    ("XBM", xbm.accepts, xbm.decode_xbm),
    ("XPM", _when(xpm.accepts, xpm.probe), xpm.decode_xpm),
    ("XVThumb", _when(smallimg.xv_accepts, smallimg.xv_probe),
     smallimg.decode_xv),
)
_BY_TYPE = {name: dec for name, _, dec in _PLUGINS}
# where the content matches no signature, the extension names the decoder
_EXTENSIONS = {".png": _png_image, ".ppm": decode_pnm,
               ".pgm": decode_pnm, ".pbm": decode_pnm,
               ".pnm": decode_pnm, ".bmp": _bmp_image,
               ".jpg": decode_jpeg_image, ".jpeg": decode_jpeg_image,
               ".webp": _webp_image, ".gif": decode_gif,
               ".tif": decode_tiff, ".tiff": decode_tiff}


def image_type(data: bytes) -> str:
    """The format the content says, as PIL's `Image.open` picks its plugin:
    its `format` ("PNM" for PIL's "PPM"), one of the names of `_PLUGINS`;
    "" if no plugin takes it."""
    for name, takes, _ in _PLUGINS:
        if takes(data):
            return name
    return ""


def decode_image(data: bytes, path: str = "") -> ModeImage:
    """Image bytes -> the image in its PIL mode (`imagemode.ModeImage`),
    the decoder picked by content as PIL picks it; by `path`'s extension
    only where the content matches no signature."""
    kind = image_type(data)
    if kind:
        return _BY_TYPE[kind](data)
    ext = os.path.splitext(path)[1].lower()
    if ext in _EXTENSIONS:
        return _EXTENSIONS[ext](data)
    raise ValueError(f"{path or 'image'}: unknown image type (content "
                     f"{data[:8]!r}, extension {ext!r})")


def read_image(path: str) -> ModeImage:
    """The image file at `path` in its PIL mode (`decode_image`)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def load_image(path: str) -> np.ndarray:
    """An image file of any type `image_type` names, told apart by content
    as PIL tells them -> uint8 [H,W,C]: grey (C 1), grey + alpha (2), RGB
    (3) or RGBA (4), palettes expanded (`imagemode.natural`), each bit for
    bit what PIL 12.1 decodes.  Where PIL fails, this raises."""
    return natural(read_image(path))


def load_rgb_uint8(path: str) -> np.ndarray:
    """An image (`load_image`'s types) as RGB uint8 [H,W,3]: PIL's
    `convert("RGB")` from its mode (alpha dropped, grey expanded, CMYK
    through Pillow's cmyk2rgb, a palette looked up)."""
    return to_rgb(read_image(path))


def load_rgb(path: str) -> np.ndarray:
    """An image (`load_image`'s types) -> HWC float32 RGB in [0,1] (alpha
    dropped, gray expanded)."""
    return load_rgb_uint8(path).astype(np.float32) / 255.0


def load_rgba_uint8(path: str) -> np.ndarray:
    """An image (`load_image`'s types) as RGBA uint8 [H,W,4]: PIL's
    `convert("RGBA")` from its mode (grey expanded, a transparent palette
    index or grey level alpha 0, "RGBa" un-premultiplied, alpha 255 where
    the image has none)."""
    return to_rgba(read_image(path))


def load_rgba(path: str) -> np.ndarray:
    """An image (`load_image`'s types) -> HWC float32 RGBA in [0,1]."""
    return load_rgba_uint8(path).astype(np.float32) / 255.0


# --------------------------------------------------------------------------
# background writer thread
# --------------------------------------------------------------------------

_ASYNC_IO = None
_ASYNC_LOCK = threading.Lock()
# queued writes by the thread that queued them: concurrent shapes
# (pipeline/batch.py) each flush their own writes, and one shape's writer
# error stays its own
_PENDING: Dict[int, list] = {}


def async_executor():
    """The one background IO thread (created on first use)."""
    global _ASYNC_IO
    with _ASYNC_LOCK:
        if _ASYNC_IO is None:
            from concurrent.futures import ThreadPoolExecutor

            _ASYNC_IO = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="pd-io")
    return _ASYNC_IO


def _queue(fut) -> None:
    with _ASYNC_LOCK:
        _PENDING.setdefault(threading.get_ident(), []).append(fut)


def submit_async_io(fn) -> None:
    """Queue an IO callable on the background thread; pair with
    flush_async_io() in the same thread."""
    _queue(async_executor().submit(fn))


def save_rgb_stack_async(imgs, paths, flip_vertical: bool = False) -> None:
    """Write a [V,H,W,3] image stack as V PNGs on the background thread
    (one uint8 device->host transfer happens here, the encodes there)."""
    stack = to_uint8(imgs)

    def work(stack=stack, ps=tuple(paths), flip=flip_vertical):
        for a, p in zip(stack, ps):
            save_rgb(a, p, flip)

    _queue(async_executor().submit(work))


def flush_async_io() -> None:
    """Block until every write this thread queued has finished; re-raise
    the first writer error."""
    with _ASYNC_LOCK:
        mine = _PENDING.pop(threading.get_ident(), [])
    err = None
    for fut in mine:
        try:
            fut.result()
        except Exception as e:      # keep draining, report one
            err = err or e
    if err is not None:
        raise err
