"""The AV1 symbol decoder (specification section 8.2): the arithmetic
decoder of tile data, with CDF adaptation and `disable_cdf_update`.

A CDF is a Python list in the specification's form: N - 1 cumulative
values, 32768, then the adaptation counter.  Lists keep this serial loop
cheap; the rest of the decoder works on numpy arrays.
"""
from __future__ import annotations


class SymbolError(ValueError):
    """A tile's symbol data broke a rule of the bitstream."""


class SymbolDecoder:
    """init_symbol / read_symbol / read_bool / read_literal of the
    specification over `data[start:start + size]`."""

    def __init__(self, data: bytes, start: int, size: int,
                 disable_cdf_update: bool):
        if size < 1:
            raise SymbolError("empty tile")
        self.data = bytes(data[start:start + size]) + b"\0\0\0\0"
        self.bitpos = 0
        self.disable_update = bool(disable_cdf_update)
        num_bits = min(size * 8, 15)
        buf = self._bits(num_bits)
        self.value = ((1 << 15) - 1) ^ (buf << (15 - num_bits))
        self.range = 1 << 15
        self.max_bits = 8 * size - 15

    def _bits(self, n: int) -> int:
        p = self.bitpos
        b = p >> 3
        w = int.from_bytes(self.data[b:b + 3], "big")
        self.bitpos = p + n
        return (w >> (24 - (p & 7) - n)) & ((1 << n) - 1)

    def read_symbol(self, cdf: list) -> int:
        n = len(cdf) - 1
        rng = self.range
        value = self.value
        r8 = rng >> 8
        cur = rng
        symbol = -1
        while True:
            symbol += 1
            prev = cur
            cur = ((r8 * ((32768 - cdf[symbol]) >> 6)) >> 1) + \
                4 * (n - symbol - 1)
            if value >= cur:
                break
        rng = prev - cur
        value -= cur
        bits = 16 - rng.bit_length()
        if bits:
            rng <<= bits
            mb = self.max_bits
            num_bits = bits if bits <= mb else (mb if mb > 0 else 0)
            new_data = self._bits(num_bits) if num_bits else 0
            value = (new_data << (bits - num_bits)) ^ \
                (((value + 1) << bits) - 1)
            self.max_bits = mb - bits
        self.range = rng
        self.value = value
        if not self.disable_update:
            cnt = cdf[n]
            rate = 3 + (cnt > 15) + (cnt > 31) + (2 if n >= 4 else
                                                   (1 if n >= 2 else 0))
            for i in range(n - 1):
                c = cdf[i]
                if i < symbol:
                    cdf[i] = c - (c >> rate)
                else:
                    cdf[i] = c + ((32768 - c) >> rate)
            if cnt < 32:
                cdf[n] = cnt + 1
        return symbol

    def read_bool(self) -> int:
        """read_symbol with the fixed {16384, 32768} CDF, not adapted."""
        rng = self.range
        value = self.value
        cur = (((rng >> 8) * (16384 >> 6)) >> 1) + 4
        if value >= cur:
            bit = 0
            rng = rng - cur
            value -= cur
        else:
            bit = 1
            rng = cur
        bits = 16 - rng.bit_length()
        if bits:
            rng <<= bits
            mb = self.max_bits
            num_bits = bits if bits <= mb else (mb if mb > 0 else 0)
            new_data = self._bits(num_bits) if num_bits else 0
            value = (new_data << (bits - num_bits)) ^ \
                (((value + 1) << bits) - 1)
            self.max_bits = mb - bits
        self.range = rng
        self.value = value
        return bit

    def read_literal(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = 2 * x + self.read_bool()
        return x

    def read_ns(self, n: int) -> int:
        """NS(n) in tile data (the palette's first color index)."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.read_literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.read_literal(1)

    def read_golomb(self) -> int:
        length = 0
        while True:
            length += 1
            if self.read_bool():
                break
            if length > 32:
                raise SymbolError("golomb code too long")
        x = 1
        for _ in range(length - 1):
            x = 2 * x + self.read_bool()
        return x - 1
