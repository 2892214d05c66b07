"""CCITT fax decoding in Python, as libtiff 4.7's tif_fax3.c decodes a
TIFF strip or tile for PIL 12.1: Modified Huffman rows aligned to bytes
(TIFF Compression 2), Group 3 with an EOL before each row, one- or
two-dimensional by T4Options bit 0 (Compression 3), and Group 4 (T.6,
Compression 4).  A row's bits are 0 for the runs coded white and 1 for
the runs coded black (the first run of a row is white), as libtiff fills
them; PIL maps them to pixels by PhotometricInterpretation.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (code bits, run length) of T.4's terminating and make-up codes
_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011")
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111")
# two-dimensional mode codes: pass, horizontal, vertical (offset)
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2,
          "0000011": 3, "010": -1, "000010": -2, "0000010": -3}


def _table(term: str, makeup: str) -> Dict[Tuple[int, int], int]:
    out = {}
    for run, code in enumerate(term.split()):
        out[len(code), int(code, 2)] = run
    for k, code in enumerate(makeup.split()):
        out[len(code), int(code, 2)] = 64 * (k + 1)
    for k, code in enumerate(_EXT_MAKEUP.split()):
        out[len(code), int(code, 2)] = 1792 + 64 * k
    return out


_TABLES = (_table(_WHITE, _WHITE_MAKEUP), _table(_BLACK, _BLACK_MAKEUP))
_MODE_TABLE = {(len(k), int(k, 2)): v for k, v in _MODES.items()}


class _Bits:
    """An MSB-first bit reader."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def code(self, table, what: str):
        v = n = 0
        bits, pos = self.bits, self.pos
        while n < 13:
            if pos + n >= len(bits):
                raise ValueError(f"CCITT: the data ends inside a {what}")
            v = (v << 1) | bits[pos + n]
            n += 1
            hit = table.get((n, v))
            if hit is not None:
                self.pos = pos + n
                return hit
        raise ValueError(f"CCITT: a bad {what} code at bit {pos}")

    def run(self, colour: int) -> int:
        total = 0
        while True:
            r = self.code(_TABLES[colour], "run length")
            total += r
            if r < 64:
                return total

    def eol(self) -> None:
        """libtiff's SYNC_EOL: on to 11 zero bits, past the zeros and the
        one that ends the EOL."""
        bits = self.bits
        while any(bits[self.pos:self.pos + 11]):
            self.pos += 1
        if self.pos + 11 > len(bits):
            raise ValueError("CCITT: no EOL before the end of the data")
        while self.pos < len(bits) and not bits[self.pos]:
            self.pos += 1
        self.pos += 1

    def align(self) -> None:
        self.pos = -(-self.pos // 8) * 8


def _fill(changes: List[int], width: int) -> np.ndarray:
    row = np.zeros(width + 1, np.int8)
    for k, c in enumerate(changes):
        row[min(c, width)] += 1 if k % 2 == 0 else -1
    return (np.cumsum(row[:width]) > 0).astype(np.uint8)


def _row_1d(bits: _Bits, width: int) -> List[int]:
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += bits.run(colour)
        if a0 > width:
            raise ValueError("CCITT: a run past the end of the row")
        changes.append(a0)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, width: int, ref: List[int]) -> List[int]:
    changes, a0, colour = [], -1, 0
    refs = ref + [width] * 3
    while a0 < width:
        # b1: the first change on the reference line past a0 to the colour
        # opposite a0's (even-indexed changes are to black)
        k = colour
        while refs[k] <= a0 and refs[k] < width:
            k += 2
        b1, b2 = refs[k], refs[k + 1]
        mode = bits.code(_MODE_TABLE, "mode")
        if mode == "P":
            a0 = b2
        elif mode == "H":
            start = max(a0, 0)
            a1 = start + bits.run(colour)
            a2 = a1 + bits.run(colour ^ 1)
            if a2 > width:
                raise ValueError("CCITT: a run past the end of the row")
            changes += [a1, a2]
            a0 = a2
        else:
            a1 = b1 + mode
            if a1 < max(a0, 0) or a1 > width:
                raise ValueError("CCITT: a vertical code off the row")
            changes.append(a1)
            a0 = a1
            colour ^= 1
    return changes


def decode(data: bytes, width: int, rows: int, compression: int,
           t4_options: int = 0) -> np.ndarray:
    """One strip or tile (MSB-first bytes) -> bits [rows, width] uint8,
    1 where a run was coded black."""
    bits = _Bits(data)
    out = np.zeros((rows, width), np.uint8)
    ref: List[int] = []
    for y in range(rows):
        if compression == 2:
            changes = _row_1d(bits, width)
            bits.align()
        elif compression == 3:
            bits.eol()
            two_d = bool(t4_options & 1) and not bits.bits[bits.pos]
            if t4_options & 1:
                bits.pos += 1
            changes = _row_2d(bits, width, ref) if two_d else \
                _row_1d(bits, width)
        elif compression == 4:
            changes = _row_2d(bits, width, ref)
        else:
            raise ValueError(f"CCITT: compression {compression}")
        out[y] = _fill(changes, width)
        ref = changes
    return out
