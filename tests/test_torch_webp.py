"""PyTorch port, the WebP decoders (webp.py, vp8.py, vp8l.py) against PIL
12.1 (libwebp) on the CPU: PIL encodes, and the port's decode must be
`np.asarray(Image.open(f))` bit for bit.  Lossy at many sizes, qualities
and methods; lossless over palettes, smooth and noisy images; alpha (lossy
with filtered ALPH, lossless); the first frame of an animation.

PIL's encoder never emits the simple loop filter, sharpness, several token
partitions or an unfiltered raw ALPH chunk.  Those paths are reached by
re-emitting a PIL-made file: the port's decoder records its (bit,
probability) pairs, and a boolean encoder (RFC 6386 section 7.3) writes
them back with the header fields changed and the tokens split by
macroblock row across partitions; raw alpha chunks are written by hand.
PIL's decode of the rewritten file is the oracle.

Also the committed fixtures under tests/data/webp/ and tests/data/timing/
(which chip_smoke.py decodes on the machine without PIL), and the restore
CLI over a folder of WebP and progressive JPEG against the JAX CLI."""
import hashlib
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import vp8, vp8l, webp

from test_torch_ddnm_restore import STEPS, _same_outputs, tiny_models  # noqa

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = os.path.join(DATA, "webp")
TIMING = os.path.join(DATA, "timing")


def photo(w, h, seed):
    """Smooth colour fields with discs and a little noise: a mix of flat
    and textured macroblocks (both 16x16 and 4x4 prediction)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(w, h, 1)
    img = np.stack([0.5 + 0.4 * np.sin(9 * xx + seed),
                    0.5 + 0.4 * np.cos(7 * yy * (1 + xx)),
                    0.5 + 0.3 * np.sin(13 * xx * yy)], -1)
    for _ in range(12):
        cx, cy, r = rng.random(3)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < (0.15 * r) ** 2] = rng.random(3)
    img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
    return (img * 255).astype(np.uint8)


def alpha_ramp(w, h):
    a = np.linspace(0, 1, w)[None, :] * np.linspace(0, 1, h)[:, None] * 400
    a = np.clip(a, 0, 255).astype(np.uint8)
    a[h // 3:h // 2] = 0
    return a


def encode(img, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **opts)
    return buf.getvalue()


def pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def check(data: bytes) -> None:
    want = pil(data)
    got = webp.decode_webp(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\x00" * (
        len(body) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def payload(data: bytes, tag: bytes = b"VP8 ") -> bytes:
    for t, s, e in webp.riff_chunks(data, 12, len(data)):
        if t == tag:
            return data[s:e]
    raise KeyError(tag)


# ---------------------------------------------------------------------------
# a boolean encoder and the re-emitter

class BoolEncoder:
    """RFC 6386 section 7.3 (write_bool, add_one_to_output,
    flush_bool_encoder)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _value_bools(v: int, n: int):
    return [((v >> (n - 1 - i)) & 1, 128) for i in range(n)]


def _signed_bools(v: int, n: int):
    return _value_bools(abs(v), n) + [(int(v < 0), 128)]


def reemit(data: bytes, simple=None, level=None, sharpness=None,
           num_parts=None, lf_delta=None) -> bytes:
    """A PIL-made lossy WebP rewritten as a plain `VP8 ` file with the
    filter header and the token partitions changed.  `lf_delta`: None
    keeps the file's deltas, False turns them off, (ref0, mode0) sets
    them."""
    pay = payload(data)
    fr, first, rows = vp8.parse_frame(pay, trace=True)
    hdr = fr.hdr
    m = hdr.marks
    fh = [(hdr.simple if simple is None else simple, 128)]
    fh += _value_bools(hdr.level if level is None else level, 6)
    fh += _value_bools(hdr.sharpness if sharpness is None else sharpness, 3)
    if lf_delta is None:        # the file's own delta bools
        fh += first[m["filter"] + 10:m["partitions"]]
    elif lf_delta is False:
        fh.append((0, 128))
    else:
        fh += [(1, 128), (1, 128)]
        for i in range(4):
            fh += [(1, 128)] + _signed_bools(lf_delta[0], 6) if i == 0 \
                else [(0, 128)]
        for i in range(4):
            fh += [(1, 128)] + _signed_bools(lf_delta[1], 6) if i == 0 \
                else [(0, 128)]
    parts = hdr.num_parts if num_parts is None else num_parts
    bools = first[:m["filter"]] + fh \
        + _value_bools(parts.bit_length() - 1, 2) + first[m["quant"]:]
    enc = BoolEncoder()
    for b, p in bools:
        enc.put(b, p)
    first_part = enc.flush()
    part_enc = [BoolEncoder() for _ in range(parts)]
    for y, row in enumerate(rows):
        for b, p in row:
            part_enc[y & (parts - 1)].put(b, p)
    part_bytes = [e.flush() for e in part_enc]
    tag = (pay[0] & 0x0E) | 0x10 | (len(first_part) << 5)
    out = struct.pack("<I", tag)[:3] + pay[3:10] + first_part
    for pb in part_bytes[:-1]:
        out += struct.pack("<I", len(pb))[:3]
    out += b"".join(part_bytes)
    return riff(chunk(b"VP8 ", out))


def alpha_filter(a: np.ndarray, method: int) -> np.ndarray:
    """The forward ALPH filters (the unfilters' inverse)."""
    x = a.astype(np.int64)
    pred = np.zeros_like(x)
    pred[0, 1:] = x[0, :-1]
    if method == 0:
        pred[:] = 0
    elif method == 1:
        pred[1:, 0] = x[:-1, 0]
        pred[1:, 1:] = x[1:, :-1]
    elif method == 2:
        pred[1:] = x[:-1]
    else:
        pred[1:, 0] = x[:-1, 0]
        pred[1:, 1:] = np.clip(x[1:, :-1] + x[:-1, 1:] - x[:-1, :-1], 0,
                               255)
    return ((x - pred) & 255).astype(np.uint8)


def raw_alpha_file(vp8_payload: bytes, alpha: np.ndarray,
                   method: int) -> bytes:
    """VP8X + a raw ALPH chunk filtered with `method` + the VP8 chunk."""
    h, w = alpha.shape
    vp8x = struct.pack("<I", 0x10) + (w - 1).to_bytes(3, "little") \
        + (h - 1).to_bytes(3, "little")
    alph = bytes([method << 2]) + alpha_filter(alpha, method).tobytes()
    return riff(chunk(b"VP8X", vp8x), chunk(b"ALPH", alph),
                chunk(b"VP8 ", vp8_payload))


def animation(lossless: bool, rgb: bool = False) -> bytes:
    frames = []
    for k in range(3):
        if rgb:
            frames.append(Image.fromarray(photo(50, 40, 20 + k)))
            continue
        f = np.zeros((40, 50, 4), np.uint8)
        ys, xs = slice(5 + 3 * k, 30 + k), slice(8 + 4 * k, 40)
        f[ys, xs, :3] = photo(50, 40, 10 + k)[ys, xs]
        f[ys, xs, 3] = 255
        frames.append(Image.fromarray(f))
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, lossless=lossless)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# fixtures

def _fixture_files():
    rng = np.random.default_rng(7)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    lossy = encode(photo(61, 45, 1), quality=75)
    rgba = np.concatenate([photo(45, 37, 5), alpha_ramp(45, 37)[..., None]],
                          -1)
    return {
        "lossy": lossy,
        "lossless_palette": encode(pal[rng.integers(0, 16, (30, 40))],
                                   lossless=True),
        "lossless_noisy": encode(rng.integers(0, 256, (24, 32, 3)).astype(
            np.uint8), lossless=True),
        "alpha_lossy": encode(rgba, quality=70, alpha_quality=80),
        "raw_alpha": raw_alpha_file(payload(lossy), alpha_ramp(61, 45), 3),
        "simple_filter": reemit(encode(photo(48, 64, 2), quality=40),
                                simple=1, sharpness=3, num_parts=2),
        "animated": animation(lossless=False),
    }


def make_fixtures(root: str, timing_root: str) -> None:
    """Write each fixture's WebP and PIL's decode of it as PNG, and the
    512x384 timing fixture with the SHA-256 of PIL's decoded bytes."""
    os.makedirs(root, exist_ok=True)
    for name, data in _fixture_files().items():
        with open(os.path.join(root, name + ".webp"), "wb") as f:
            f.write(data)
        Image.fromarray(pil(data)).save(os.path.join(root, name + ".png"))
    os.makedirs(timing_root, exist_ok=True)
    data = encode(photo(512, 384, 3), quality=80)
    with open(os.path.join(timing_root, "webp_q80_512x384.webp"), "wb") as f:
        f.write(data)
    with open(os.path.join(timing_root, "webp_q80_512x384.sha256"),
              "w") as f:
        f.write(hashlib.sha256(pil(data).tobytes()).hexdigest() + "\n")


def test_fixtures_are_what_pil_gives(tmp_path):
    make_fixtures(str(tmp_path / "webp"), str(tmp_path / "timing"))
    total = 0
    names = sorted(_fixture_files())
    assert sorted(f[:-5] for f in os.listdir(FIXTURES)
                  if f.endswith(".webp")) == names
    for name in names:
        for ext in (".webp", ".png"):
            committed = os.path.join(FIXTURES, name + ext)
            total += os.path.getsize(committed)
            if ext == ".webp":
                assert open(committed, "rb").read() == open(
                    tmp_path / "webp" / (name + ext), "rb").read(), name
        got = tio.load_image(os.path.join(FIXTURES, name + ".webp"))
        np.testing.assert_array_equal(
            got, tio.load_png(os.path.join(FIXTURES, name + ".png")))
    for f in ("webp_q80_512x384.webp", "webp_q80_512x384.sha256"):
        assert open(os.path.join(TIMING, f), "rb").read() == open(
            tmp_path / "timing" / f, "rb").read(), f
    assert total < 48 * 1024


def test_timing_fixture_hash():
    got = tio.load_image(os.path.join(TIMING, "webp_q80_512x384.webp"))
    want = open(os.path.join(TIMING, "webp_q80_512x384.sha256")).read()
    assert got.shape == (384, 512, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want.strip()


# ---------------------------------------------------------------------------
# lossy

@pytest.mark.parametrize("w,h", [(1, 1), (7, 5), (16, 16), (17, 23),
                                 (33, 47), (100, 37)])
@pytest.mark.parametrize("quality", [5, 30, 75, 100])
@pytest.mark.parametrize("method", [0, 3, 6])
def test_lossy_is_bit_equal_to_pil(w, h, quality, method):
    data = encode(photo(w, h, w * h + quality), quality=quality,
                  method=method)
    check(data)
    assert webp.decode_webp(data).shape == (h, w, 3)


def test_lossy_large_frame_uses_every_predictor():
    data = encode(photo(300, 200, 4), quality=95)
    fr = vp8.parse_frame(payload(data))
    modes = set(fr.ymodes[fr.is_i4].ravel().tolist())
    assert modes == set(range(10)), modes
    assert {0, 1, 2, 3} <= set(fr.uvmode.tolist())
    check(data)


def test_shortcut_transforms_equal_the_full_ones():
    # libwebp's TransformDC / TransformAC3 and the DC-only inverse WHT are
    # shortcuts of the full transforms; the port always runs the full ones
    rng = np.random.default_rng(0)
    c = np.zeros((500, 16), np.int64)
    c[:, 0] = rng.integers(-2048, 2048, 500)
    dc = vp8.inverse_dct(c)
    np.testing.assert_array_equal(
        dc, np.broadcast_to(((c[:, 0] + 4) >> 3)[:, None, None],
                            (500, 4, 4)))
    c[:, 1] = rng.integers(-2048, 2048, 500)
    c[:, 4] = rng.integers(-2048, 2048, 500)
    a = c[:, 0] + 4

    def mul1(x):
        return ((x * 20091) >> 16) + x

    def mul2(x):
        return (x * 35468) >> 16

    c4, d4, c1, d1 = mul2(c[:, 4]), mul1(c[:, 4]), mul2(c[:, 1]), mul1(
        c[:, 1])
    rows = [a + d4, a + c4, a - c4, a - d4]
    ac3 = np.stack([np.stack([(r + d1) >> 3, (r + c1) >> 3, (r - c1) >> 3,
                              (r - d1) >> 3], -1) for r in rows], 1)
    np.testing.assert_array_equal(vp8.inverse_dct(c), ac3)
    y2 = np.zeros((500, 16), np.int64)
    y2[:, 0] = rng.integers(-30000, 30000, 500)
    np.testing.assert_array_equal(
        vp8.inverse_wht(y2),
        np.broadcast_to(((y2[:, 0] + 3) >> 3)[:, None], (500, 16)))


@pytest.mark.parametrize("case", ["simple", "simple_sharp", "sharpness1",
                                  "sharpness6", "parts2", "parts4",
                                  "parts8", "lf_delta_off", "lf_deltas",
                                  "level0"])
def test_paths_pil_never_emits(case):
    base = encode(photo(64, 130, 8), quality=50)
    opts = {
        "simple": dict(simple=1), "simple_sharp": dict(simple=1,
                                                       sharpness=5),
        "sharpness1": dict(sharpness=1), "sharpness6": dict(sharpness=6),
        "parts2": dict(num_parts=2), "parts4": dict(num_parts=4),
        "parts8": dict(num_parts=8), "lf_delta_off": dict(lf_delta=False),
        "lf_deltas": dict(lf_delta=(-6, 9)), "level0": dict(level=0),
    }[case]
    data = reemit(base, **opts)
    fr = vp8.parse_frame(payload(data))
    if "num_parts" in opts:
        assert fr.hdr.num_parts == opts["num_parts"]
    if "simple" in opts:
        assert fr.hdr.simple == 1 and fr.hdr.level > 0
    check(data)


def test_reemitting_unchanged_is_identity():
    base = encode(photo(40, 40, 9), quality=60)
    np.testing.assert_array_equal(webp.decode_webp(reemit(base)), pil(base))


# ---------------------------------------------------------------------------
# lossless

def _lossless_image(kind):
    rng = np.random.default_rng(len(kind))
    if kind.startswith("colours"):
        n = int(kind[7:])
        pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        return pal[rng.integers(0, n, (37, 53))]
    if kind == "smooth":
        return photo(61, 45, 3)
    if kind == "noisy":
        return rng.integers(0, 256, (29, 31, 3)).astype(np.uint8)
    return np.concatenate([photo(40, 30, 4), rng.integers(
        0, 256, (30, 40, 1)).astype(np.uint8)], -1)


@pytest.mark.parametrize("kind", ["colours2", "colours4", "colours16",
                                  "colours256", "colours1000", "smooth",
                                  "noisy", "rgba"])
@pytest.mark.parametrize("opts", ["default", "fast", "best", "exact"])
def test_lossless_is_bit_equal_to_pil(kind, opts):
    kw = {"default": {}, "fast": dict(quality=0, method=0),
          "best": dict(quality=100, method=6), "exact": dict(exact=True)}
    img = _lossless_image(kind)
    data = encode(img, lossless=True, **kw[opts])
    check(data)
    rgba = vp8l.decode_vp8l(payload(data, b"VP8L"))
    if kind != "rgba" or opts == "exact":
        np.testing.assert_array_equal(rgba[..., :img.shape[-1]], img)


def test_lossless_large_image_meta_codes_and_every_predictor(monkeypatch):
    # a larger image gets an entropy image (meta prefix codes) and uses
    # all 14 predictor modes
    rng = np.random.default_rng(3)
    img = photo(256, 192, 11)
    img[::7, ::5] = rng.integers(0, 256, img[::7, ::5].shape)
    img[100:150, 20:90] = rng.integers(0, 256, (50, 70, 3))
    seen = {"meta": False, "modes": set()}
    pixels, predictor = vp8l.decode_pixels, vp8l.inverse_predictor

    def decode_pixels(*args):
        seen["meta"] |= args[4] is not None
        return pixels(*args)

    def inverse_predictor(res, w, h, bits, modes):
        seen["modes"] |= set(((modes >> 8) & 15).tolist())
        return predictor(res, w, h, bits, modes)

    monkeypatch.setattr(vp8l, "decode_pixels", decode_pixels)
    monkeypatch.setattr(vp8l, "inverse_predictor", inverse_predictor)
    check(encode(img, lossless=True))
    assert seen["meta"] and seen["modes"] == set(range(14)), seen


def test_prefix_codes_are_canonical():
    table, width = vp8l.build_code([2, 1, 3, 3])
    assert width == 3
    # codes: 1 -> 0, 0 -> 10, 2 -> 110, 3 -> 111 (read LSB first)
    assert table[0b000] >> 4 == 1 and table[0b001] >> 4 == 0
    assert table[0b011] >> 4 == 2 and table[0b111] >> 4 == 3
    assert vp8l.build_code([0, 0, 5, 0]) == ([2 << 4], 0)
    with pytest.raises(ValueError, match="incomplete"):
        vp8l.build_code([1, 2, 0])


# ---------------------------------------------------------------------------
# alpha and animation

@pytest.mark.parametrize("alpha_quality", [100, 30, 0])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossy_alpha_is_bit_equal_to_pil(alpha_quality, method):
    rgba = np.concatenate([photo(45, 37, 5), alpha_ramp(45, 37)[..., None]],
                          -1)
    data = encode(rgba, quality=70, alpha_quality=alpha_quality,
                  method=method)
    assert webp.parse(data)["chunks"][0][0] == b"ALPH"
    check(data)


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_raw_alpha_under_each_filter(method):
    lossy = encode(photo(33, 21, 6), quality=60)
    alpha = np.random.default_rng(method).integers(0, 256, (21, 33)).astype(
        np.uint8)
    alpha[:, :5] = 255
    data = raw_alpha_file(payload(lossy), alpha, method)
    got = webp.decode_webp(data)
    np.testing.assert_array_equal(got[..., 3], alpha)
    check(data)


def test_lossless_rgba_and_opaque_modes():
    rgba = np.concatenate([photo(45, 37, 5), alpha_ramp(45, 37)[..., None]],
                          -1)
    check(encode(rgba, lossless=True))
    data = encode(photo(45, 37, 5), lossless=True)
    assert webp.decode_webp(data).shape == (37, 45, 3)
    check(data)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "opaque"])
def test_animation_first_frame(kind):
    data = animation(lossless=kind == "lossless", rgb=kind == "opaque")
    info = webp.parse(data)
    assert info["animated"]
    if kind != "opaque":
        assert info["offset"] != (0, 0)
    check(data)


def test_load_functions_convert_as_pil(tmp_path):
    rgba = np.concatenate([photo(20, 12, 5), alpha_ramp(20, 12)[..., None]],
                          -1)
    for name, img in (("a", rgba), ("b", rgba[..., :3])):
        p = str(tmp_path / (name + ".webp"))
        Image.fromarray(img).save(p, quality=80)
        im = Image.open(p)
        np.testing.assert_array_equal(tio.load_image(p), np.asarray(im))
        np.testing.assert_array_equal(tio.load_rgb_uint8(p),
                                      np.asarray(im.convert("RGB")))
        np.testing.assert_array_equal(tio.load_rgba_uint8(p),
                                      np.asarray(im.convert("RGBA")))
        np.testing.assert_array_equal(
            tio.load_rgba(p), np.asarray(im.convert("RGBA"),
                                         np.float32) / 255.0)


@pytest.mark.parametrize("kind", ["lossy", "lossless"])
def test_truncated_files_raise_as_pil_does(kind):
    data = encode(photo(40, 30, 1), quality=70, lossless=kind == "lossless")
    cut = data[:len(data) // 2]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(cut)).load()
    with pytest.raises(ValueError):
        webp.decode_webp(cut)
    with pytest.raises(ValueError, match="not a WebP"):
        webp.decode_webp(b"RIFF\x00\x00\x00\x00WAVEfmt ")


def test_restore_cli_over_webp_and_progressive_jpeg_matches_jax(
        tiny_models, tmp_path, monkeypatch):
    from pointdreamer_tpu.cli import ddnm_restore as jcli
    from pointdreamer_tpu_torch.cli import ddnm_restore as tcli

    root = tmp_path / "imgs"
    os.makedirs(root)
    rgba = np.concatenate([photo(270, 260, 5), alpha_ramp(270, 260)[
        ..., None]], -1)
    Image.fromarray(photo(300, 260, 9)).save(root / "a.webp", quality=70)
    Image.fromarray(rgba).save(root / "b.webp", lossless=True)
    Image.fromarray(photo(280, 300, 4)).save(root / "c.jpg", quality=85,
                                             progressive=True)
    argv = ["--image_dir", str(root), "--dataset", "LSUN", "--deg",
            "sr4", "--batch", "3", "--steps", str(STEPS)]
    monkeypatch.setattr("sys.argv", ["ddnm_restore"] + argv
                        + ["--out", str(tmp_path / "jax")])
    jcli.main()
    tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert _same_outputs(tmp_path / "jax", tmp_path / "port") == sorted(
        f"{n}{s}.png" for n in "abc" for s in ("", "_degraded"))
