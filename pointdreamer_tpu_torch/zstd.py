"""Zstandard decompression (RFC 8878) in Python, for TIFF's Compression
50000 (libtiff's ZSTD codec writes one frame a strip or tile).

- frames: the header (window, frame content size, single segment; a
  dictionary ID raises NotImplementedError naming it, since the port has
  no dictionaries), a skippable frame, and the XXH64 content checksum,
  verified;
- blocks: raw, RLE and compressed;
- literals: raw, RLE, and Huffman-coded in 1 or 4 streams, the weights
  coded directly or by FSE, and the treeless form that reuses the last
  table of the frame;
- sequences: the literal-length, match-length and offset codes in
  predefined, RLE, FSE-coded or repeat mode, with the three repeat
  offsets.

`decompress(data)` returns the content of the first frame of `data`, as
libtiff's ZSTD codec reads a strip (a skippable frame there gives
nothing).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

_MAGIC = 0xFD2FB528
_MASK64 = (1 << 64) - 1

# (baseline, extra bits) of each literal-length and match-length code
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# the predefined distributions (RFC 8878, 3.1.1.3.2.2) and their
# accuracy logs
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1] + [-1] * 4, 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (largest symbol, largest accuracy log) of each sequence code
_LL_MAX, _ML_MAX, _OF_MAX = (35, 9), (52, 9), (31, 8)


class ZstdError(ValueError):
    """Corrupt or unsupported Zstandard data."""


# ---------------------------------------------------------------------------
# bit streams


class _Backward:
    """A bit stream read from its end towards its start, most significant
    bits first (the Huffman and FSE streams): the last byte's highest set
    bit marks where the stream begins.  Bits before the start read as 0;
    `left` goes negative once they are read."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("zstd: a bit stream without its end mark")
        self.data = data
        self.left = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def _peek(self, n: int) -> int:
        if n == 0:
            return 0
        lo = self.left - n                      # lowest bit of the field
        if lo >= 0:
            b0 = lo >> 3
            b1 = (self.left + 7) >> 3
            v = int.from_bytes(self.data[b0:b1], "little")
            return (v >> (lo & 7)) & ((1 << n) - 1)
        if self.left <= 0:
            return 0
        v = int.from_bytes(self.data[:(self.left + 7) >> 3], "little")
        return ((v & ((1 << self.left) - 1)) << -lo)

    def read(self, n: int) -> int:
        v = self._peek(n)
        self.left -= n
        return v


# ---------------------------------------------------------------------------
# FSE


def _read_distribution(data: bytes, pos: int, max_symbol: int,
                       max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description (FSE_readNCount): (normalised counts,
    accuracy log, position after it)."""
    if pos >= len(data):
        raise ZstdError("zstd: an FSE table description past the block")
    stream = int.from_bytes(data[pos:pos + 64], "little")
    bit = 0

    def take(n):
        nonlocal bit
        v = (stream >> bit) & ((1 << n) - 1)
        bit += n
        return v

    log = take(4) + 5
    if log > max_log:
        raise ZstdError(f"zstd: FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = 0
            while True:
                r = take(2)
                n0 += r
                if r != 3:
                    break
            counts += [0] * n0
            if len(counts) > max_symbol + 1:
                raise ZstdError("zstd: FSE table past its largest symbol")
        peek = (stream >> bit) & (2 * threshold - 1)
        most = (2 * threshold - 1) - remaining
        if (peek & (threshold - 1)) < most:
            count = peek & (threshold - 1)
            bit += nbits - 1
        else:
            count = peek
            if count >= threshold:
                count -= most
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("zstd: a corrupt FSE table description")
    used = (bit + 7) >> 3
    if pos + used > len(data):
        raise ZstdError("zstd: an FSE table description past the block")
    return counts, log, pos + used


def _fse_table(counts: List[int], log: int):
    """FSE_buildDTable: per state (symbol, bits to read, base of the next
    state)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("zstd: a corrupt FSE distribution")
    bits = [0] * size
    base = [0] * size
    for u in range(size):
        s = symbol[u]
        n = nxt[s]
        nxt[s] += 1
        nb = log - (n.bit_length() - 1)
        bits[u] = nb
        base[u] = (n << nb) - size
    return symbol, bits, base, log


def _rle_table(sym: int):
    return [sym], [0], [0], 0


_PREDEFINED = {name: _fse_table(*dist) for name, dist in (
    ("LL", _LL_DEFAULT), ("ML", _ML_DEFAULT), ("OF", _OF_DEFAULT))}


# ---------------------------------------------------------------------------
# Huffman literals


def _huffman_weights(data: bytes, pos: int) -> Tuple[List[int], int]:
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise ZstdError("zstd: Huffman weights past the block")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], pos + (n + 1) // 2
    end = pos + head
    if head == 0 or end > len(data):
        raise ZstdError("zstd: a corrupt Huffman tree description")
    counts, log, p = _read_distribution(data[:end], pos, 255, 6)
    symbol, bits, base, log = _fse_table(counts, log)
    bs = _Backward(data[p:end])
    s1 = bs.read(log)
    s2 = bs.read(log)
    weights: List[int] = []
    while True:
        if len(weights) > 255:
            raise ZstdError("zstd: too many Huffman weights")
        weights.append(symbol[s1])
        s1 = base[s1] + bs.read(bits[s1])
        if bs.left < 0:
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + bs.read(bits[s2])
        if bs.left < 0:
            weights.append(symbol[s1])
            break
    return weights, end


def _huffman_table(weights: List[int]):
    """The decoding table of a tree: for each `bits`-bit prefix, (symbol,
    code length); the last symbol's weight is the one that completes the
    sum to a power of 2."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("zstd: Huffman weights all zero")
    bits = total.bit_length()
    rest = (1 << bits) - total
    if rest & (rest - 1):
        raise ZstdError("zstd: Huffman weights do not complete a tree")
    weights = weights + [rest.bit_length()]
    if bits > 11:
        raise ZstdError(f"zstd: Huffman code length {bits} above 11")
    syms = [0] * (1 << bits)
    lens = [0] * (1 << bits)
    pos = 0
    for w in range(1, bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                syms[pos:pos + n] = [s] * n
                lens[pos:pos + n] = [bits + 1 - w] * n
                pos += n
    return syms, lens, bits


def _huffman_stream(stream: bytes, table, n: int) -> bytes:
    syms, lens, bits = table
    bs = _Backward(stream)
    out = bytearray(n)
    for i in range(n):
        k = bs._peek(bits)
        out[i] = syms[k]
        bs.left -= lens[k]
    if bs.left != 0:
        raise ZstdError("zstd: a Huffman stream not read to its start")
    return bytes(out)


# ---------------------------------------------------------------------------
# blocks


class _Frame:
    def __init__(self):
        self.huffman = None
        self.tables = {"LL": None, "ML": None, "OF": None}
        self.rep = [1, 4, 8]


def _literals(data: bytes, fr: _Frame) -> Tuple[bytes, int]:
    b0 = data[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            n, pos = b0 >> 3, 1
        elif fmt == 1:
            n, pos = (b0 >> 4) + (data[1] << 4), 2
        else:
            n, pos = (b0 >> 4) + (data[1] << 4) + (data[2] << 12), 3
        if kind == 0:
            if pos + n > len(data):
                raise ZstdError("zstd: raw literals past the block")
            return data[pos:pos + n], pos + n
        if pos >= len(data):
            raise ZstdError("zstd: RLE literals past the block")
        return data[pos:pos + 1] * n, pos + 1
    head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    v = int.from_bytes(data[:head], "little")
    width = {3: 10, 4: 14, 5: 18}[head]
    n = (v >> 4) & ((1 << width) - 1)
    size = (v >> (4 + width)) & ((1 << width) - 1)
    streams = 1 if fmt == 0 else 4
    pos, end = head, head + size
    if end > len(data):
        raise ZstdError("zstd: compressed literals past the block")
    if kind == 2:
        weights, pos = _huffman_weights(data[:end], pos)
        fr.huffman = _huffman_table(weights)
    elif fr.huffman is None:
        raise ZstdError("zstd: treeless literals with no earlier tree")
    if streams == 1:
        return _huffman_stream(data[pos:end], fr.huffman, n), end
    if pos + 6 > end:
        raise ZstdError("zstd: a jump table past the literals")
    s1, s2, s3 = struct.unpack_from("<3H", data, pos)
    pos += 6
    s4 = end - pos - s1 - s2 - s3
    if s4 < 0:
        raise ZstdError("zstd: a corrupt jump table")
    each = (n + 3) // 4
    out = b""
    for i, s in enumerate((s1, s2, s3, s4)):
        out += _huffman_stream(data[pos:pos + s], fr.huffman,
                               each if i < 3 else n - 3 * each)
        pos += s
    return out, end


def _table(mode: int, name: str, data: bytes, pos: int, fr: _Frame,
           limits) -> int:
    if mode == 0:
        fr.tables[name] = _PREDEFINED[name]
    elif mode == 1:
        if pos >= len(data):
            raise ZstdError("zstd: an RLE code past the block")
        if data[pos] > limits[0]:
            raise ZstdError(f"zstd: {name} code {data[pos]} out of range")
        fr.tables[name] = _rle_table(data[pos])
        pos += 1
    elif mode == 2:
        counts, log, pos = _read_distribution(data, pos, *limits)
        fr.tables[name] = _fse_table(counts, log)
    elif fr.tables[name] is None:
        raise ZstdError(f"zstd: {name} repeat mode with no earlier table")
    return pos


def _block(data: bytes, fr: _Frame, out: bytearray, start: int) -> None:
    """One compressed block onto `out` (the frame's content from `start`)."""
    lits, pos = _literals(data, fr)
    if pos >= len(data):
        raise ZstdError("zstd: a compressed block without its sequences")
    b0 = data[pos]
    if b0 == 0:
        nseq, pos = 0, pos + 1
    elif b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != len(data):
            raise ZstdError("zstd: bytes after a block's literals")
        out += lits
        return
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("zstd: reserved bits of the sequence modes set")
    pos = _table(modes >> 6, "LL", data, pos, fr, _LL_MAX)
    pos = _table((modes >> 4) & 3, "OF", data, pos, fr, _OF_MAX)
    pos = _table((modes >> 2) & 3, "ML", data, pos, fr, _ML_MAX)
    ll_sym, ll_bits, ll_base, ll_log = fr.tables["LL"]
    of_sym, of_bits, of_base, of_log = fr.tables["OF"]
    ml_sym, ml_bits, ml_base, ml_log = fr.tables["ML"]
    bs = _Backward(data[pos:])
    read = bs.read
    sll, sof, sml = read(ll_log), read(of_log), read(ml_log)
    rep = fr.rep
    lp = 0
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[sof], ml_sym[sml], ll_sym[sll]
        if of_code > 31:
            raise ZstdError("zstd: offset code above 31")
        ov = (1 << of_code) + read(of_code)
        mb, mx = _ML[ml_code]
        ml = mb + read(mx)
        lb, lx = _LL[ll_code]
        ll = lb + read(lx)
        if ov > 3:
            off = ov - 3
            rep[:] = [off, rep[0], rep[1]]
        else:
            k = ov - 1 + (ll == 0)
            if k == 0:
                off = rep[0]
            elif k == 1:
                off = rep[1]
                rep[:] = [off, rep[0], rep[2]]
            else:
                off = rep[2] if k == 2 else rep[0] - 1
                if off == 0:
                    raise ZstdError("zstd: a repeat offset of 0")
                rep[:] = [off, rep[0], rep[1]]
        if i + 1 < nseq:
            sll = ll_base[sll] + read(ll_bits[sll])
            sml = ml_base[sml] + read(ml_bits[sml])
            sof = of_base[sof] + read(of_bits[sof])
        if lp + ll > len(lits):
            raise ZstdError("zstd: a sequence past its literals")
        out += lits[lp:lp + ll]
        lp += ll
        if off > len(out) - start:
            raise ZstdError("zstd: a match before the start of the frame")
        at = len(out) - off
        if off >= ml:
            out += out[at:at + ml]
        else:
            piece = out[at:]
            out += (piece * (ml // off + 1))[:ml]
    if bs.left != 0:
        raise ZstdError("zstd: a sequence stream not read to its start")
    out += lits[lp:]


# ---------------------------------------------------------------------------
# XXH64


_P1, _P2, _P3, _P4, _P5 = (11400714785074694791, 14029467366897019727,
                           1609587929392839161, 9650029242287828579,
                           2870177450012600261)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _MASK64
    return (_rotl(acc, 31) * _P1) & _MASK64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the frame checksum is its low 32 bits)."""
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _MASK64
        v2 = (seed + _P2) & _MASK64
        v3 = seed
        v4 = (seed - _P1) & _MASK64
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        p = (n // 32) * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) \
            & _MASK64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _MASK64
    else:
        h = (seed + _P5) & _MASK64
    h = (h + n) & _MASK64
    while p + 8 <= n:
        k, = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _MASK64
        p += 8
    if p + 4 <= n:
        k, = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (k * _P1 & _MASK64), 23) * _P2 + _P3) & _MASK64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _MASK64), 11) * _P1) & _MASK64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _MASK64
    h ^= h >> 29
    h = (h * _P3) & _MASK64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# frames


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    start = len(out)
    if pos >= len(data):
        raise ZstdError("zstd: a frame without its header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, reserved, checksum, did_flag = (
        fhd >> 6, (fhd >> 5) & 1, (fhd >> 3) & 1, (fhd >> 2) & 1, fhd & 3)
    if reserved:
        raise ZstdError("zstd: the reserved bit of a frame header is set")
    if not single:
        pos += 1                        # the window descriptor
    did_size = (0, 1, 2, 4)[did_flag]
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if did:
        raise NotImplementedError(
            f"zstd: a frame that needs dictionary {did}; the port has no "
            "zstd dictionaries (libtiff writes frames without one)")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content: Optional[int] = None
    if fcs_size:
        content = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content += 256
        pos += fcs_size
    if pos > len(data):
        raise ZstdError("zstd: a truncated frame header")
    fr = _Frame()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("zstd: a truncated block header")
        head = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("zstd: a raw block past the data")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos >= len(data):
                raise ZstdError("zstd: an RLE block past the data")
            out += data[pos:pos + 1] * size
            pos += 1
        elif kind == 2:
            if pos + size > len(data) or size == 0:
                raise ZstdError("zstd: a compressed block past the data")
            _block(data[pos:pos + size], fr, out, start)
            pos += size
        else:
            raise ZstdError("zstd: a reserved block type")
        if last:
            break
    if content is not None and len(out) - start != content:
        raise ZstdError(f"zstd: a frame of {len(out) - start} bytes where "
                        f"its header says {content}")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError("zstd: a truncated content checksum")
        want, = struct.unpack_from("<I", data, pos)
        pos += 4
        got = xxh64(bytes(out[start:])) & 0xFFFFFFFF
        if got != want:
            raise ZstdError(f"zstd: content checksum {got:08x} where the "
                            f"frame says {want:08x}")
    return pos


def decompress(data: bytes) -> bytes:
    """The content of the first frame of `data`, as libtiff's ZSTD codec
    reads a strip or tile: its ZSTD_decompressStream loop ends with that
    frame, so what follows it is not read, and a skippable frame first
    gives nothing."""
    if len(data) < 4:
        raise ZstdError("zstd: no frame")
    magic, = struct.unpack_from("<I", data)
    if magic & 0xFFFFFFF0 == 0x184D2A50:
        if len(data) < 8 or 8 + struct.unpack_from("<I", data, 4)[0] > \
                len(data):
            raise ZstdError("zstd: a truncated skippable frame")
        return b""
    if magic != _MAGIC:
        raise ZstdError(f"zstd: magic {magic:08x} is not a frame's")
    out = bytearray()
    _frame(data, 4, out)
    return bytes(out)
