"""Host-side IO: PLY point clouds and meshes, OBJ/MTL meshes, 8-bit PNG
images.

Twin of pointdreamer_tpu's core/io.py without PIL or cv2: PNGs are written
and read with zlib + struct (8-bit gray, gray+alpha, RGB and RGBA; all
five row filters on read, filter 0 on write); binary and ASCII PPM/PGM
(maxval 255), uncompressed 24/32-bit BMP and baseline JPEG (`jpeg.py`)
are read too.  WebP needs a decoder the port does not have (ROADMAP
Queue A item 9): reading one raises.  Image writers take numpy
arrays or torch tensors; a device tensor is quantized to uint8 on the
device before the one host transfer.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from .jpeg import decode_jpeg

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


def _paeth(a, b, c):
    p = a.astype(np.int16) + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced PNG bytes -> uint8 [H,W,C]."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG (depth {depth}, type {ctype}, "
                         f"interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        ft, line = raw[y, 0], raw[y, 1:].copy()
        if ft == 1:
            for x in range(c, w * c, c):     # vectorized per pixel step
                line[x:x + c] += line[x - c:x]
        elif ft == 2:
            line += prev
        elif ft == 3:
            for x in range(w * c):
                left = int(line[x - c]) if x >= c else 0
                line[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 255
        elif ft == 4:
            for x in range(w * c):
                left = line[x - c] if x >= c else np.uint8(0)
                ul = prev[x - c] if x >= c else np.uint8(0)
                line[x] = line[x] + _paeth(np.asarray(left),
                                           np.asarray(prev[x]),
                                           np.asarray(ul))
        elif ft != 0:
            raise ValueError(f"bad PNG filter {ft}")
        out[y] = line
        prev = line
    return out.reshape(h, w, c)


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


def decode_pnm(data: bytes) -> np.ndarray:
    """PPM (P6, P3) or PGM (P5, P2) bytes with maxval 255 -> uint8
    [H,W,C]."""
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"unsupported PNM type {magic!r}")
    fields, pos = [], 2
    while len(fields) < 3:                     # width, height, maxval
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"unsupported PNM maxval {maxval}")
    c = 3 if magic in (b"P3", b"P6") else 1
    if magic in (b"P5", b"P6"):                # one whitespace, then bytes
        a = np.frombuffer(data, np.uint8, h * w * c, pos + 1)
    else:
        body = b" ".join(ln.split(b"#")[0]
                         for ln in data[pos:].splitlines())
        a = np.array(body.split()[:h * w * c], np.int64).astype(np.uint8)
    return a.reshape(h, w, c).copy()


def decode_bmp(data: bytes) -> np.ndarray:
    """Uncompressed (BI_RGB / BI_BITFIELDS in BGRA order) 24- or 32-bit BMP
    bytes -> uint8 [H,W,3], row 0 at the top."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    offset, = struct.unpack_from("<I", data, 10)
    w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    if bpp not in (24, 32) or comp not in (0, 3):
        raise ValueError(f"unsupported BMP ({bpp} bits, compression {comp})")
    c = bpp // 8
    stride = (w * c + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, abs(h) * stride, offset)
    a = rows.reshape(abs(h), stride)[:, :w * c].reshape(abs(h), w, c)
    a = a[..., 2::-1]                          # BGR(A) -> RGB
    return np.ascontiguousarray(a[::-1] if h > 0 else a)


_DECODERS = {".png": decode_png, ".ppm": decode_pnm, ".pgm": decode_pnm,
             ".pnm": decode_pnm, ".bmp": decode_bmp, ".jpg": decode_jpeg,
             ".jpeg": decode_jpeg}
UNSUPPORTED_IMAGES = (".webp",)


def load_image(path: str) -> np.ndarray:
    """A PNG, PPM/PGM, uncompressed BMP or baseline JPEG (`jpeg.py`,
    libjpeg-turbo's decode bit for bit) -> uint8 [H,W,C] as stored.  WebP
    raises NotImplementedError: the port has no VP8 decoder (ROADMAP Queue
    A item 9)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in UNSUPPORTED_IMAGES:
        raise NotImplementedError(
            f"{path}: {ext} images need a decoder the port does not have "
            "(ROADMAP Queue A item 9: a VP8 decoder for WebP); convert "
            "them to PNG, JPEG, PPM or BMP")
    if ext not in _DECODERS:
        raise ValueError(f"{path}: unknown image type {ext!r}")
    with open(path, "rb") as f:
        return _DECODERS[ext](f.read())


def load_rgb_uint8(path: str) -> np.ndarray:
    """`load_image` as RGB uint8 [H,W,3] (alpha dropped, gray expanded:
    PIL's `convert("RGB")`)."""
    a = load_image(path)
    if a.shape[-1] in (1, 2):
        a = np.repeat(a[..., :1], 3, axis=-1)
    return np.ascontiguousarray(a[..., :3])


def load_rgb(path: str) -> np.ndarray:
    """An image (`load_image`'s types) -> HWC float32 RGB in [0,1] (alpha
    dropped, gray expanded)."""
    return load_rgb_uint8(path).astype(np.float32) / 255.0


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
