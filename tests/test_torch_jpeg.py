"""PyTorch port, the JPEG decoder (jpeg.py, io.decode_jpeg) against PIL
(libjpeg-turbo 3.1) on the CPU: PIL encodes, and the port's decode must be
PIL's decode bit for bit.  What PIL cannot write is emitted here: an
arithmetic-coded file re-emitted from a PIL file's coefficients with the
same scan script (`arith_jpeg`, jcarith.c's encoder), a lossless file from
an image's samples (`lossless_jpeg`), YCCK by an Adobe transform of 2 on a
PIL CMYK file, a smoothed progressive file by dropping the last scans of a
PIL one.  Each variant PIL refuses, the port refuses too.  Also the
committed fixtures under tests/data/jpeg/ and tests/data/timing/ (which
`chip_smoke.py` decodes on the machine without PIL) and the restore CLI
over a folder of one JPEG against the JAX CLI."""
import hashlib
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import jpeg as tjpeg

from test_torch_ddnm_restore import STEPS, _same_outputs, tiny_models  # noqa

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
TIMING = os.path.join(os.path.dirname(FIXTURES), "timing")

# name: (width, height, grey, PIL save options)
FIXTURE_SPECS = {
    "420": (64, 48, False, dict(quality=75, subsampling=2)),
    "444": (40, 30, False, dict(quality=90, subsampling=0)),
    "grey": (33, 21, True, dict(quality=75)),
    "restart": (45, 37, False, dict(quality=75, subsampling=2,
                                    restart_marker_blocks=2)),
    "odd_422": (17, 23, False, dict(quality=50, subsampling=1)),
    "prog_420": (64, 48, False, dict(quality=75, subsampling=2,
                                     progressive=True)),
    "prog_444": (40, 30, False, dict(quality=90, subsampling=0,
                                     progressive=True)),
    "prog_grey": (33, 21, True, dict(quality=75, progressive=True)),
    "prog_restart": (45, 37, False, dict(quality=75, subsampling=2,
                                         restart_marker_blocks=2,
                                         progressive=True)),
}


def _image(w, h, seed, grey=False):
    """Smooth ramps plus noise, so that every block has AC terms."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 200
    img = np.clip(base + rng.integers(0, 55, (h, w, 3)), 0, 255).astype(
        np.uint8)
    return img[..., 0] if grey else img


def _encode(img, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _port(data: bytes) -> np.ndarray:
    a = tjpeg.decode_jpeg(data)
    return np.repeat(a, 3, -1) if a.shape[-1] == 1 else a


ZZ = tjpeg.ZIGZAG.tolist()


class ArithEncoder:
    """jcarith.c's encoder (arith_encode, finish_pass)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def bit(self, stats, i, val):
        sv = stats[i]
        qe, nm, nl = tjpeg._QM[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        while self.sc:
                            self._emit(0xFF)
                            self._emit(0)
                            self.sc -= 1
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def flush(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)


def _enc_dc(enc, stats, ctx, v, cond):
    st = ctx
    if v == 0:
        enc.bit(stats, st, 0)
        return 0
    enc.bit(stats, st, 1)
    if v > 0:
        enc.bit(stats, st + 1, 0)
        st += 2
        new = 4
    else:
        v = -v
        enc.bit(stats, st + 1, 1)
        st += 3
        new = 8
    m = 0
    v -= 1
    if v:
        enc.bit(stats, st, 1)
        m = 1
        v2 = v >> 1
        st = 20
        while v2:
            enc.bit(stats, st, 1)
            m <<= 1
            st += 1
            v2 >>= 1
    enc.bit(stats, st, 0)
    lo, hi = cond
    if m < (1 << lo) >> 1:
        new = 0
    elif m > (1 << hi) >> 1:
        new += 8
    st += 14
    m >>= 1
    while m:
        enc.bit(stats, st, 1 if m & v else 0)
        m >>= 1
    return new


def _enc_ac(enc, stats, st, v, k, kx, fixed):
    if v > 0:
        enc.bit(fixed, 0, 0)
    else:
        v = -v
        enc.bit(fixed, 0, 1)
    st += 2
    m = 0
    v -= 1
    if v:
        enc.bit(stats, st, 1)
        m = 1
        v2 = v >> 1
        if v2:
            enc.bit(stats, st, 1)
            m <<= 1
            st = 189 if k <= kx else 217
            v2 >>= 1
            while v2:
                enc.bit(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
    enc.bit(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.bit(stats, st, 1 if m & v else 0)
        m >>= 1


def _shift(v, al):                       # AC point transform: toward zero
    return v >> al if v >= 0 else -((-v) >> al)


def _encode_scan(frame, coefs, sel, ss, se, ah, al, restart, cond):
    prog = frame["progressive"]
    units = tjpeg._scan_units(frame, sel)
    enc = ArithEncoder()
    fixed = [tjpeg._FIXED]
    dc_first = not prog or (ss == 0 and ah == 0)
    ac_used = not prog or ss != 0

    def fresh():
        return ({td: [0] * 64 for _, td, _ in sel},
                {ta: [0] * 256 for _, _, ta in sel}, [0] * len(sel),
                [0] * len(sel))

    dcs, acs, last, ctx = fresh()
    out = bytearray()
    for n, mcu in enumerate(units):
        if restart and n and n % restart == 0:
            enc.flush()
            out += enc.out + bytes((0xFF, 0xD0 + (n // restart - 1) % 8))
            enc.out = bytearray()
            enc.reset()
            dcs, acs, last, ctx = fresh()
        for slot, base in mcu:
            ci, td, ta = sel[slot]
            blk = coefs[ci][base:base + 64]
            if dc_first:
                m = int(blk[0]) >> al if prog else int(blk[0])
                ctx[slot] = _enc_dc(enc, dcs[td], ctx[slot], m - last[slot],
                                    cond["dc"][td])
                last[slot] = m
                if prog:
                    continue
            elif ss == 0:
                enc.bit(fixed, 0, (int(blk[0]) >> al) & 1)
                continue
            stats, kx = acs[ta], cond["ac"][ta]
            if not prog:
                ke = 63
                while ke and blk[ZZ[ke]] == 0:
                    ke -= 1
                k = 0
                while k < ke:
                    st = 3 * k
                    enc.bit(stats, st, 0)
                    k += 1
                    while blk[ZZ[k]] == 0:
                        enc.bit(stats, st + 1, 0)
                        st += 3
                        k += 1
                    enc.bit(stats, st + 1, 1)
                    _enc_ac(enc, stats, st, int(blk[ZZ[k]]), k, kx, fixed)
                if k < 63:
                    enc.bit(stats, 3 * k, 1)
                continue
            sv = [_shift(int(blk[ZZ[k]]), al) for k in range(64)]
            ke = se
            while ke > 0 and sv[ke] == 0:
                ke -= 1
            if ah == 0:
                k = ss
                while k <= ke:
                    st = 3 * (k - 1)
                    enc.bit(stats, st, 0)
                    while sv[k] == 0:
                        enc.bit(stats, st + 1, 0)
                        st += 3
                        k += 1
                    enc.bit(stats, st + 1, 1)
                    _enc_ac(enc, stats, st, sv[k], k, kx, fixed)
                    k += 1
                if k <= se:
                    enc.bit(stats, 3 * (k - 1), 1)
            else:
                kex = ke
                while kex > 0 and _shift(int(blk[ZZ[kex]]), ah) == 0:
                    kex -= 1
                k = ss
                while k <= ke:
                    st = 3 * (k - 1)
                    if k > kex:
                        enc.bit(stats, st, 0)
                    while True:
                        v = abs(sv[k])
                        if v:
                            if v >> 1:
                                enc.bit(stats, st + 2, v & 1)
                            else:
                                enc.bit(stats, st + 1, 1)
                                enc.bit(fixed, 0, 1 if sv[k] < 0 else 0)
                            break
                        enc.bit(stats, st + 1, 0)
                        st += 3
                        k += 1
                    k += 1
                if k <= se:
                    enc.bit(stats, 3 * (k - 1), 1)
    enc.flush()
    return bytes(out + enc.out)


def segments(data):
    """(marker, payload) of each header segment, and each scan's entropy
    data after its SOS."""
    out, pos = [], 2
    while pos < len(data):
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        n, = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + n]
        pos += n
        if marker == 0xDA:
            _, end = tjpeg._segments(data, pos)
            out.append((marker, seg, data[pos:end]))
            pos = end
        else:
            out.append((marker, seg, b""))
    return out


def arith_jpeg(data, restart=0, dac=None):
    """A Huffman JPEG's coefficients re-emitted arithmetic-coded
    (SOF9 / SOF10), with the same headers and scan script; `dac`
    {(class, table): value} writes a DAC segment."""
    j = tjpeg.read_jpeg(data)
    frame, coefs = j["frame"], j["coefs"]
    cond = {"dc": [(0, 1)] * 4, "ac": [5] * 4}
    for (tc, tb), val in (dac or {}).items():
        if tc:
            cond["ac"][tb] = val
        else:
            cond["dc"][tb] = (val & 15, val >> 4)
    out = bytearray(b"\xff\xd8")
    started = False
    for marker, seg, _ in segments(data):
        if marker in (0xC4, 0xDD, 0xDA):
            continue
        if marker in (0xC0, 0xC1, 0xC2):
            marker = 0xCA if marker == 0xC2 else 0xC9
        out += bytes((0xFF, marker)) + struct.pack(">H", len(seg) + 2) + seg
    if dac:
        body = b"".join(bytes((tc << 4 | tb, val))
                        for (tc, tb), val in dac.items())
        out += b"\xff\xcc" + struct.pack(">H", len(body) + 2) + body
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    for marker, seg, _ in segments(data):
        if marker != 0xDA:
            continue
        sel, ss, se, ah, al = tjpeg._scan_header(seg, frame)
        out += b"\xff\xda" + struct.pack(">H", len(seg) + 2) + seg
        out += _encode_scan(frame, coefs, sel, ss, se, ah, al, restart,
                            cond)
    return bytes(out + b"\xff\xd9")


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, v, n):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _predict(x, psv, first_rows, initial):
    """The lossless predictions of samples x [h, w] (int64)."""
    h, w = x.shape
    pred = np.zeros_like(x)
    for r in range(h):
        if r in first_rows:
            pred[r, 0] = initial
            pred[r, 1:] = x[r, :-1]
            continue
        ra, rb = x[r, :-1], x[r - 1, 1:]
        rc = x[r - 1, :-1]
        pred[r, 0] = x[r - 1, 0]
        pred[r, 1:] = {1: lambda: ra, 2: lambda: rb, 3: lambda: rc,
                       4: lambda: ra + rb - rc,
                       5: lambda: ra + ((rb - rc) >> 1),
                       6: lambda: rb + ((ra - rc) >> 1),
                       7: lambda: (ra + rb) >> 1}[psv]()
    return pred


def lossless_jpeg(img, psv, pt=0, sampling=None, ids=None, jfif=False,
                  restart_rows=0):
    """Lossless Huffman JPEG (SOF3) of uint8 img [H, W, C] (C 1 or 3):
    predictor `psv`, point transform `pt`, per-component sampling
    factors (the subsampled planes take every h-th / v-th sample), one
    interleaved scan."""
    img = img if img.ndim == 3 else img[..., None]
    H, W, C = img.shape
    sampling = sampling or [(1, 1)] * C
    ids = ids or list(range(1, C + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    if C == 1:
        mcux, mcuy, sampling = W, H, [(1, 1)]
    diffs = []
    rows_per_interval = restart_rows
    for c, (h, v) in enumerate(sampling):
        plane = img[::vmax // v, ::hmax // h, c].astype(np.int64) >> pt
        ph, pw = -(-H * v // vmax), -(-W * h // hmax)
        plane = plane[:ph, :pw]
        first = set(range(0, ph, rows_per_interval * v)) if restart_rows \
            else {0}
        d = plane - _predict(plane, psv, first, 1 << (8 - pt - 1))
        full = np.zeros((mcuy * v, mcux * h), np.int64)
        full[:ph, :pw] = d
        diffs.append(full)
    bits = _Bits()
    scans = bytearray()
    n = 0
    for my in range(mcuy):
        if restart_rows and my and my % restart_rows == 0:
            bits.flush()
            scans += bits.out + bytes((0xFF, 0xD0 + (n % 8)))
            n += 1
            bits = _Bits()
        for mx in range(mcux):
            for c, (h, v) in enumerate(sampling):
                for y in range(v):
                    for x in range(h):
                        dv = int(diffs[c][my * v + y, mx * h + x])
                        s = abs(dv).bit_length()
                        bits.put(s, 5)
                        if s:
                            bits.put(dv if dv > 0 else dv + (1 << s) - 1, s)
    bits.flush()
    scans += bits.out
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    sof = struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes((ids[c], h << 4 | v, 0)) for c, (h, v) in enumerate(sampling))
    out += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    counts = bytes([0, 0, 0, 0, 17] + [0] * 11)
    dht = bytes((0,)) + counts + bytes(range(17))
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    if restart_rows:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * mcux)
    sos = bytes((C,)) + b"".join(bytes((ids[c], 0)) for c in range(C)) + \
        bytes((psv, 0, pt))
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos + scans
    return bytes(out + b"\xff\xd9")


def _timing_jpeg() -> bytes:
    from test_torch_webp import photo

    return _encode(photo(512, 384, 3), quality=80, progressive=True)


def _timing_arith_jpeg() -> bytes:
    from test_torch_webp import photo

    return arith_jpeg(_encode(photo(512, 384, 4), quality=80))


def _cmyk_jpeg(seed=21, sub=2, adobe=True) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_image(48, 40, seed)).convert("CMYK").save(
        buf, "JPEG", quality=80, subsampling=sub)
    data = buf.getvalue()
    if not adobe:
        i = data.index(b"Adobe") - 4               # the APP14 marker
        n, = struct.unpack_from(">H", data, i + 2)
        data = data[:i] + data[i + 2 + n:]
        assert b"Adobe" not in data
    return data


def with_adobe_transform(data: bytes, transform: int) -> bytes:
    """`data` with its Adobe APP14 segment's transform byte set."""
    i = data.index(b"Adobe")
    out = bytearray(data)
    out[i + 11] = transform
    return bytes(out)


def drop_scans(data: bytes, keep: int) -> bytes:
    """A progressive file cut after its first `keep` scans."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) > keep
    return data[:sos[keep]] + b"\xff\xd9"


# the fixtures PIL cannot write as they are: name -> bytes
EMITTED = {
    "cmyk": lambda: _cmyk_jpeg(),
    "cmyk_no_adobe": lambda: _cmyk_jpeg(22, 0, adobe=False),
    "ycck": lambda: with_adobe_transform(_cmyk_jpeg(23, 1), 2),
    "arith": lambda: arith_jpeg(_encode(_image(64, 48, 31), quality=75,
                                        subsampling=2)),
    "arith_prog": lambda: arith_jpeg(
        _encode(_image(45, 37, 32), quality=80, subsampling=1,
                progressive=True),
        restart=3, dac={(0, 0): 0x52, (1, 0): 2, (1, 1): 9}),
    "smooth": lambda: drop_scans(_encode(_image(64, 48, 33), quality=75,
                                         subsampling=2, progressive=True), 6),
    "smooth_dc": lambda: drop_scans(_encode(_image(45, 37, 34), quality=60,
                                            progressive=True), 1),
    "lossless": lambda: lossless_jpeg(_image(40, 30, 35), 4,
                                      ids=[82, 71, 66]),
    "lossless_grey": lambda: lossless_jpeg(_image(33, 21, 36, True), 7, 1,
                                           restart_rows=3),
}


def _write_timing(timing_root, name, data):
    os.makedirs(timing_root, exist_ok=True)
    with open(os.path.join(timing_root, name + ".jpg"), "wb") as f:
        f.write(data)
    with open(os.path.join(timing_root, name + ".sha256"), "w") as f:
        f.write(hashlib.sha256(_pil(data).tobytes()).hexdigest() + "\n")


def make_fixtures(root: str, timing_root=None) -> None:
    """Write each fixture's JPEG and PIL's decode of it (convert("RGB")) as
    PNG; with `timing_root`, also the 512x384 progressive and arithmetic
    timing fixtures and the SHA-256 of PIL's decoded bytes."""
    os.makedirs(root, exist_ok=True)
    made = {name: _encode(_image(w, h, 100 + k, grey), **opts)
            for k, (name, (w, h, grey, opts)) in enumerate(
                FIXTURE_SPECS.items())}
    made.update({name: make() for name, make in EMITTED.items()})
    for name, data in made.items():
        with open(os.path.join(root, f"{name}.jpg"), "wb") as f:
            f.write(data)
        Image.fromarray(_pil(data)).save(os.path.join(root, f"{name}.png"))
    if timing_root is not None:
        _write_timing(timing_root, "jpeg_prog_512x384", _timing_jpeg())
        _write_timing(timing_root, "jpeg_arith_512x384",
                      _timing_arith_jpeg())


@pytest.mark.parametrize("w,h", [(17, 23), (64, 64), (333, 250)])
@pytest.mark.parametrize("sub", [0, 1, 2])
def test_decode_is_bit_equal_to_pil(w, h, sub):
    for q in (50, 75, 95) if (w, h) != (333, 250) else (75,):
        data = _encode(_image(w, h, w + sub + q), quality=q,
                       subsampling=sub)
        got = _port(data)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil(data), err_msg=str(q))


@pytest.mark.parametrize("case", ["grey", "restart", "restart_rows",
                                  "optimized", "411", "tiny"])
def test_decode_other_streams_bit_equal_to_pil(case):
    img = _image(45, 37, 7)
    data = {
        "grey": lambda: _encode(img[..., 0], quality=75),
        "restart": lambda: _encode(img, quality=75, subsampling=2,
                                   restart_marker_blocks=2),
        "restart_rows": lambda: _encode(img, quality=95, subsampling=1,
                                        restart_marker_rows=1),
        "optimized": lambda: _encode(img, quality=75, optimize=True),
        "411": lambda: _encode(img, quality=75, subsampling="4:1:1"),
        "tiny": lambda: _encode(img[:2, :3], quality=75),
    }[case]()
    got = tjpeg.decode_jpeg(data)
    if case == "grey":
        assert got.shape == (37, 45, 1)
    np.testing.assert_array_equal(_port(data), _pil(data))


def test_unsupported_frames_raise_by_name(tmp_path):
    img = _image(24, 16, 3)
    # progressive, CMYK and arithmetic frames are read now: PIL's decode,
    # bit for bit
    prog = _encode(img, quality=75, progressive=True)
    assert b"\xff\xc2" in prog
    np.testing.assert_array_equal(_port(prog), _pil(prog))
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    np.testing.assert_array_equal(_port(cmyk.getvalue()), _pil(
        cmyk.getvalue()))
    base = _encode(img, quality=75)
    arith = arith_jpeg(base)
    assert b"\xff\xc9" in arith
    np.testing.assert_array_equal(_port(arith), _pil(arith))
    # 12-bit samples, by the frame header: PIL refuses them too
    twelve = bytearray(base)
    sof = base.index(b"\xff\xc0")
    twelve[sof + 1] = 0xC1
    twelve[sof + 4] = 12
    with pytest.raises(Exception):
        _pil(bytes(twelve))
    with pytest.raises(NotImplementedError, match="12-bit"):
        tjpeg.decode_jpeg(bytes(twelve))
    with pytest.raises(ValueError, match="not a JPEG"):
        tjpeg.decode_jpeg(b"\x89PNG....")


@pytest.mark.parametrize("w,h", [(17, 23), (64, 64), (333, 250)])
@pytest.mark.parametrize("sub", [0, 1, 2])
def test_progressive_is_bit_equal_to_pil(w, h, sub):
    for q in (50, 75, 95) if (w, h) != (333, 250) else (75,):
        data = _encode(_image(w, h, w + sub + q), quality=q,
                       subsampling=sub, progressive=True)
        assert b"\xff\xc2" in data
        got = _port(data)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil(data), err_msg=str(q))


@pytest.mark.parametrize("case", ["grey", "restart", "restart_rows",
                                  "optimized", "411", "tiny"])
def test_progressive_other_streams_bit_equal_to_pil(case):
    img = _image(45, 37, 8)
    opts = dict(quality=75, progressive=True)
    data = {
        "grey": lambda: _encode(img[..., 0], **opts),
        "restart": lambda: _encode(img, subsampling=2,
                                   restart_marker_blocks=3, **opts),
        "restart_rows": lambda: _encode(img, subsampling=1,
                                        restart_marker_rows=1, **opts),
        "optimized": lambda: _encode(img, optimize=True, **opts),
        "411": lambda: _encode(img, subsampling="4:1:1", **opts),
        "tiny": lambda: _encode(img[:2, :3], **opts),
    }[case]()
    np.testing.assert_array_equal(_port(data), _pil(data))


def test_incomplete_progressive_raises_naming_block_smoothing():
    # a file cut after its third scan: libjpeg-turbo smooths the blocks of
    # such a file (jdcoefct.c), and so does the port now, bit for bit
    data = _encode(_image(48, 40, 6), quality=75, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) > 4
    cut = data[:sos[3]] + b"\xff\xd9"
    j = tjpeg.read_jpeg(cut)
    assert tjpeg.smoothing_applies(j["frame"], j["qt"])
    assert _pil(cut).shape == (40, 48, 3)
    np.testing.assert_array_equal(_port(cut), _pil(cut))
    # the first (DC) scan alone: the DC itself is smoothed too
    dc_only = data[:sos[1]] + b"\xff\xd9"
    np.testing.assert_array_equal(_port(dc_only), _pil(dc_only))
    # a whole file needs no smoothing
    j = tjpeg.read_jpeg(data)
    assert not tjpeg.smoothing_applies(j["frame"], j["qt"])


def _pil_raw(data: bytes):
    im = Image.open(io.BytesIO(data))
    return im.mode, np.asarray(im)


@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("kind", ["cmyk", "no_adobe", "ycck", "transform1"])
def test_cmyk_and_ycck_bit_equal_to_pil(kind, sub):
    data = _cmyk_jpeg(40 + sub, sub, adobe=kind != "no_adobe")
    if kind in ("ycck", "transform1"):
        data = with_adobe_transform(data, 2 if kind == "ycck" else 1)
    mode, want = _pil_raw(data)
    got = tjpeg.decode_jpeg_image(data)
    assert mode == got.mode == "CMYK"
    np.testing.assert_array_equal(got.pixels, want)
    np.testing.assert_array_equal(tjpeg.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("prog", [False, True])
@pytest.mark.parametrize("sub", [0, 2])
@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("restart,dac", [(0, None),
                                         (3, {(0, 0): 0x52, (1, 0): 2}),
                                         (1, {(0, 1): 0x10, (1, 1): 63})])
def test_arithmetic_bit_equal_to_pil(prog, sub, grey, restart, dac):
    data = _encode(_image(45, 37, 50 + sub, grey), quality=75,
                   subsampling=sub, progressive=prog)
    arith = arith_jpeg(data, restart, dac)
    assert (b"\xff\xca" if prog else b"\xff\xc9") in arith
    # the re-emission carries the coefficients whole: PIL decodes it to
    # the Huffman file's pixels
    np.testing.assert_array_equal(_pil(arith), _pil(data))
    mode, want = _pil_raw(arith)
    got = tjpeg.decode_jpeg_image(arith)
    assert got.mode == mode
    np.testing.assert_array_equal(got.pixels, want)


def test_arithmetic_cmyk_and_smoothed_bit_equal_to_pil():
    # four components, and a progressive arithmetic file cut short
    arith = arith_jpeg(_cmyk_jpeg(60, 2))
    np.testing.assert_array_equal(tjpeg.decode_jpeg_image(arith).pixels,
                                  _pil_raw(arith)[1])
    prog = arith_jpeg(_encode(_image(64, 48, 61), quality=75,
                              progressive=True))
    for keep in (1, 3, 6):
        cut = drop_scans(prog, keep)
        np.testing.assert_array_equal(_port(cut), _pil(cut))


@pytest.mark.parametrize("w,h,sub", [(48, 40, 2), (45, 37, 0), (64, 48, 1),
                                     (33, 21, 2), (17, 9, 2), (100, 70, 2)])
@pytest.mark.parametrize("grey", [False, True])
def test_block_smoothing_bit_equal_to_pil(w, h, sub, grey):
    # every cut of the scan script; grey files with subsampling 2 carry
    # 2x2 factors on their one component (the iMCU-row bookkeeping)
    data = _encode(_image(w, h, 6 + w, grey), quality=75, progressive=True,
                   subsampling=sub)
    n = data.count(b"\xff\xda")
    for keep in range(1, n):
        cut = drop_scans(data, keep)
        np.testing.assert_array_equal(tjpeg.decode_jpeg_image(cut).pixels,
                                      _pil_raw(cut)[1], err_msg=str(keep))


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 2])
def test_lossless_grey_bit_equal_to_pil(psv, pt):
    img = _image(29, 19, psv, grey=True)
    data = lossless_jpeg(img, psv, pt, restart_rows=4 if pt else 0)
    mode, want = _pil_raw(data)
    np.testing.assert_array_equal(want, img >> pt << pt)
    got = tjpeg.decode_jpeg_image(data)
    assert got.mode == mode == "L"
    np.testing.assert_array_equal(got.pixels, want)


@pytest.mark.parametrize("ids", [(82, 71, 66), (1, 2, 3)])
@pytest.mark.parametrize("sampling", [None, ((2, 2), (1, 1), (1, 1)),
                                      ((2, 1), (1, 1), (1, 1))])
def test_lossless_colour_bit_equal_to_pil(ids, sampling):
    # no colour conversion in lossless mode, whatever the component ids;
    # subsampled components are box-upsampled
    img = _image(29, 19, 3)
    data = lossless_jpeg(img, 6, 0, sampling, list(ids))
    mode, want = _pil_raw(data)
    if sampling is None:
        np.testing.assert_array_equal(want, img)
    got = tjpeg.decode_jpeg_image(data)
    assert got.mode == mode == "RGB"
    np.testing.assert_array_equal(got.pixels, want)


def _sof_patched(data: bytes, sof: int) -> bytes:
    out = bytearray(data)
    i = next(i for i in range(len(out) - 1) if out[i] == 0xFF
             and out[i + 1] in (0xC0, 0xC1, 0xC2, 0xC3))
    out[i + 1] = sof
    return bytes(out)


@pytest.mark.parametrize("case", ["12-bit", "hierarchical", "arith_lossless",
                                  "lossless_jfif", "lossless_ycck"])
def test_what_pil_refuses_the_port_refuses(case):
    img = _image(24, 16, 3)
    base = _encode(img, quality=75)
    data = {
        "12-bit": lambda: bytes(base[:base.index(b"\xff\xc0") + 4])
        + b"\x0c" + base[base.index(b"\xff\xc0") + 5:],
        "hierarchical": lambda: _sof_patched(base, 0xC5),
        "arith_lossless": lambda: _sof_patched(lossless_jpeg(img, 1), 0xCB),
        "lossless_jfif": lambda: lossless_jpeg(img, 1, jfif=True),
        "lossless_ycck": lambda: lossless_jpeg(
            np.dstack([img, img[..., :1]]), 1)[:2]
        + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"
        + lossless_jpeg(np.dstack([img, img[..., :1]]), 1)[2:],
    }[case]()
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(NotImplementedError):
        tjpeg.decode_jpeg_image(data)


def _timing_hash(name):
    got = tio.load_image(os.path.join(TIMING, name + ".jpg"))
    want = open(os.path.join(TIMING, name + ".sha256")).read()
    assert got.shape == (384, 512, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want.strip()


def test_progressive_timing_fixture_hash():
    _timing_hash("jpeg_prog_512x384")


def test_arithmetic_timing_fixture_hash():
    _timing_hash("jpeg_arith_512x384")


def test_idct_matches_the_float_dct():
    # ISLOW against the exact inverse DCT: within one level (libjpeg's
    # accuracy), on random dequantised blocks
    rng = np.random.default_rng(0)
    coef = rng.integers(-200, 200, (50, 64)) * (rng.random((50, 64)) < 0.3)
    coef[:, 0] = rng.integers(-500, 500, 50)
    got = tjpeg.idct_islow(coef).astype(np.int64)
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(0.5), 1.0)
    basis = c[None, :] * np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi
                                / 16) / 2                    # [x, u]
    want = np.einsum("xu,nuv,yv->nxy", basis, coef.reshape(-1, 8, 8),
                     basis) + 128
    want = np.clip(np.round(want), 0, 255)
    assert np.abs(got - want).max() <= 1


def test_fixtures_decode_to_their_pil_pngs(tmp_path):
    # the committed files are what make_fixtures writes with this PIL
    make_fixtures(str(tmp_path), str(tmp_path / "timing"))
    for f in ("jpeg_prog_512x384.jpg", "jpeg_prog_512x384.sha256",
              "jpeg_arith_512x384.jpg", "jpeg_arith_512x384.sha256"):
        assert open(os.path.join(TIMING, f), "rb").read() == open(
            tmp_path / "timing" / f, "rb").read(), f
    for names in (FIXTURE_SPECS, EMITTED):
        total = 0
        for name in names:
            for ext in (".jpg", ".png"):
                committed = os.path.join(FIXTURES, name + ext)
                total += os.path.getsize(committed)
                if ext == ".jpg":
                    assert open(committed, "rb").read() == open(
                        tmp_path / (name + ext), "rb").read(), name
            got = tio.load_rgb_uint8(os.path.join(FIXTURES, name + ".jpg"))
            np.testing.assert_array_equal(
                got, tio.load_png(os.path.join(FIXTURES, name + ".png")))
        assert total < 64 * 1024
    # each emitted fixture is the variant it is named for
    kinds = {n: tjpeg.read_jpeg(open(os.path.join(FIXTURES, n + ".jpg"),
                                     "rb").read()) for n in EMITTED}
    assert kinds["ycck"]["adobe"] == 2 and kinds["cmyk"]["adobe"] == 0
    assert kinds["cmyk_no_adobe"]["adobe"] is None
    assert kinds["arith"]["frame"]["arith"]
    assert kinds["arith_prog"]["frame"]["progressive"]
    assert kinds["lossless"]["frame"]["lossless"]
    for n in ("smooth", "smooth_dc"):
        assert tjpeg.smoothing_applies(kinds[n]["frame"], kinds[n]["qt"])


def test_load_image_registers_jpeg_and_refuses_webp(tmp_path):
    # JPEG and WebP are both registered now: each reads as PIL reads it
    img = _image(20, 12, 5)
    for ext in (".jpg", ".jpeg", ".JPG"):
        p = str(tmp_path / ("a" + ext))
        Image.fromarray(img).save(p, "JPEG", quality=80)
        np.testing.assert_array_equal(tio.load_rgb_uint8(p),
                                      np.asarray(Image.open(p).convert(
                                          "RGB")))
    p = str(tmp_path / "a.webp")
    Image.fromarray(img).save(p, "WEBP", quality=80)
    np.testing.assert_array_equal(tio.load_image(p),
                                  np.asarray(Image.open(p)))
    np.testing.assert_array_equal(tio.load_rgb_uint8(p),
                                  np.asarray(Image.open(p).convert("RGB")))


def test_restore_cli_over_a_jpeg_folder_matches_jax(tiny_models, tmp_path,
                                                    monkeypatch):
    from pointdreamer_tpu.cli import ddnm_restore as jcli
    from pointdreamer_tpu_torch.cli import ddnm_restore as tcli

    root = tmp_path / "imgs"
    os.makedirs(root)
    Image.fromarray(_image(300, 260, 9)).save(root / "a.jpg", quality=85)
    argv = ["--image_dir", str(root), "--dataset", "IMAGENET", "--deg",
            "inpainting", "--batch", "1", "--steps", str(STEPS)]
    monkeypatch.setattr("sys.argv", ["ddnm_restore"] + argv
                        + ["--out", str(tmp_path / "jax")])
    jcli.main()
    tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert _same_outputs(tmp_path / "jax", tmp_path / "port") == [
        "a.png", "a_degraded.png"]
