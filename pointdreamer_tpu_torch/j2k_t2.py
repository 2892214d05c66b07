"""JPEG 2000 tier-2 decoding (ITU-T T.800 B.9-B.12), as OpenJPEG 2.5 reads
packets: the order of the packets of a tile (the five progression orders
and POC volumes, each packet read once), packet headers (tag trees for
inclusion and zero bit-planes, pass counts, Lblock, the coding-pass
segments of each code-block style), SOP and EPH markers, and packed
headers from PPM / PPT.  Every quality layer is read.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

from .j2k_codestream import (BYPASS, TERMALL, Codestream, Precinct,
                             TileComponent, TileParams, ceildiv,
                             tile_bounds)


class TagTree:
    """OpenJPEG's opj_tgt tree over w x h leaves: values start at 999."""

    def __init__(self, w: int, h: int):
        parent: List[int] = []
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            cw, ch = sizes[-1]
            sizes.append(((cw + 1) // 2, (ch + 1) // 2))
        offs = [0]
        for cw, ch in sizes:
            offs.append(offs[-1] + cw * ch)
        for lv, (cw, ch) in enumerate(sizes):
            for j in range(ch):
                for i in range(cw):
                    if lv + 1 < len(sizes):
                        pw = sizes[lv + 1][0]
                        parent.append(offs[lv + 1] + (j // 2) * pw + i // 2)
                    else:
                        parent.append(-1)
        self.parent = parent
        self.value = [999] * len(parent)
        self.low = [0] * len(parent)

    def decode(self, bio: "Bio", leaf: int, threshold: int) -> bool:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return value[node] < threshold


class Bio:
    """OpenJPEG's opj_bio packet-header bit reader: after a 0xFF byte the
    next byte holds 7 bits."""

    def __init__(self, data, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = 0
        self.ct = 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0


def _num_passes(bio: Bio) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _new_segment(segs: List[list], style: int) -> None:
    """opj_t2_init_seg: the most passes the segment may hold."""
    if style & TERMALL:
        most = 1
    elif style & BYPASS:
        if not segs:
            most = 10
        else:
            most = 2 if segs[-1][0] in (1, 10) else 1
    else:
        most = 109
    segs.append([most, 0, 0])


# ---------------------------------------------------------------------------
# progression


def packet_order(cs: Codestream, t: int, params: TileParams,
                 layout: List[TileComponent]
                 ) -> Iterator[Tuple[int, int, int, int]]:
    """(layer, resolution, component, precinct) of each packet of tile `t`
    in the order they are read (OpenJPEG's opj_pi_next_*)."""
    ncomp = len(layout)
    nres = [len(tc.resolutions) for tc in layout]
    tx0, ty0, tx1, ty1 = tile_bounds(cs, t)
    if params.pocs:
        volumes = [(p.order, p.res0, p.res1, p.comp0, p.comp1, p.lay1)
                   for p in params.pocs]
    else:
        volumes = [(params.order, 0, max(nres), 0, ncomp, params.layers)]
    seen = set()

    def steps(comps):
        dx = dy = 0
        for c in comps:
            for r, res in enumerate(layout[c].resolutions):
                e = res.pdx + nres[c] - 1 - r
                if e < 32:
                    v = cs.comps[c].dx << e
                    dx = v if not dx else min(dx, v)
                e = res.pdy + nres[c] - 1 - r
                if e < 32:
                    v = cs.comps[c].dy << e
                    dy = v if not dy else min(dy, v)
        return dx, dy

    def precinct_at(x, y, c, r):
        comp, res = cs.comps[c], layout[c].resolutions[r]
        level = nres[c] - 1 - r
        sx, sy = comp.dx << level, comp.dy << level
        trx0, try0 = ceildiv(tx0, sx), ceildiv(ty0, sy)
        trx1, try1 = ceildiv(tx1, sx), ceildiv(ty1, sy)
        rpx, rpy = res.pdx + level, res.pdy + level
        if rpx >= 31 or rpy >= 31:
            return None
        if not (y % (comp.dy << rpy) == 0 or (
                y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (comp.dx << rpx) == 0 or (
                x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (ceildiv(x, sx) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (ceildiv(y, sy) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def grid(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - (x % dx)
            y += dy - (y % dy)

    for order, r0, r1, c0, c1, l1 in volumes:
        out: List[Tuple[int, int, int, int]] = []
        if order in (0, 1):                             # LRCP, RLCP
            outer = [(l, r) for l in range(l1) for r in range(r0, r1)] \
                if order == 0 else \
                [(l, r) for r in range(r0, r1) for l in range(l1)]
            for l, r in outer:
                for c in range(c0, c1):
                    if r >= nres[c]:
                        continue
                    res = layout[c].resolutions[r]
                    for p in range(res.pw * res.ph):
                        out.append((l, r, c, p))
        elif order == 2:                                # RPCL
            dx, dy = steps(range(ncomp))
            if dx == 0 or dy == 0:
                return
            for r in range(r0, r1):
                for x, y in grid(dx, dy):
                    for c in range(c0, c1):
                        if r >= nres[c]:
                            continue
                        p = precinct_at(x, y, c, r)
                        if p is not None:
                            out += [(l, r, c, p) for l in range(l1)]
        elif order == 3:                                # PCRL
            dx, dy = steps(range(ncomp))
            if dx == 0 or dy == 0:
                return
            for x, y in grid(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, nres[c])):
                        p = precinct_at(x, y, c, r)
                        if p is not None:
                            out += [(l, r, c, p) for l in range(l1)]
        else:                                           # CPRL
            for c in range(c0, c1):
                dx, dy = steps([c])
                if dx == 0 or dy == 0:
                    return
                for x, y in grid(dx, dy):
                    for r in range(r0, min(r1, nres[c])):
                        p = precinct_at(x, y, c, r)
                        if p is not None:
                            out += [(l, r, c, p) for l in range(l1)]
        for key in out:
            if key not in seen:
                seen.add(key)
                yield key


# ---------------------------------------------------------------------------
# packets


def read_packets(cs: Codestream, t: int, layout: List[TileComponent]
                 ) -> int:
    """Read every packet of tile `t` into its code-blocks (their `segs`
    and `data`); the number of packets."""
    tile = cs.tiles[t]
    params = tile.params
    data = tile.data
    hbuf = tile.headers if tile.packed else data
    pos = 0
    hpos = 0
    count = 0
    for l, r, c, p in packet_order(cs, t, params, layout):
        count += 1
        res = layout[c].resolutions[r]
        style = params.cod[c].style
        if params.sop and data[pos:pos + 2] == b"\xff\x91" and \
                len(data) - pos >= 6:
            pos += 6
        if not tile.packed:
            hpos = pos
        bio = Bio(hbuf, hpos, len(hbuf))
        chunks = []
        if bio.bit():
            for band in res.bands:
                if band.empty:
                    continue
                prc: Precinct = band.precincts[p]
                if prc.incl is None:
                    prc.incl = TagTree(prc.cw, prc.ch)
                    prc.imsb = TagTree(prc.cw, prc.ch)
                for k, cb in enumerate(prc.blocks):
                    if not cb.segs:
                        included = prc.incl.decode(bio, k, l + 1)
                    else:
                        included = bio.bit()
                    if not included:
                        continue
                    if not cb.segs:
                        i = 0
                        while not prc.imsb.decode(bio, k, i):
                            i += 1
                            if i > 74:
                                raise ValueError("JPEG 2000: a corrupt "
                                                 "zero bit-plane tag tree")
                        cb.numbps = band.numbps + 1 - i
                        cb.lenbits = 3
                    n = _num_passes(bio)
                    while bio.bit():
                        cb.lenbits += 1
                    if not cb.segs:
                        _new_segment(cb.segs, style)
                    elif cb.segs[-1][1] == cb.segs[-1][0]:
                        _new_segment(cb.segs, style)
                    segno = len(cb.segs) - 1
                    while True:
                        seg = cb.segs[segno]
                        take = min(seg[0] - seg[1], n)
                        bits = cb.lenbits + take.bit_length() - 1
                        if bits > 32:
                            raise ValueError("JPEG 2000: a code-block "
                                             "segment length of > 32 bits")
                        chunks.append((cb, segno, take, bio.read(bits)))
                        n -= take
                        if n <= 0:
                            break
                        _new_segment(cb.segs, style)
                        segno += 1
        bio.inalign()
        hpos = bio.pos
        if params.eph and hbuf[hpos:hpos + 2] == b"\xff\x92":
            hpos += 2
        if not tile.packed:
            pos = hpos
        for cb, segno, take, length in chunks:
            if pos + length > len(data):
                raise ValueError("JPEG 2000: code-block data past the tile")
            cb.data += data[pos:pos + length]
            cb.segs[segno][1] += take
            cb.segs[segno][2] += length
            pos += length
    return count
