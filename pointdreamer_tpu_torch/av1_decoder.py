"""AV1 still-image decoding (specification section 7): the OBUs of the
first temporal unit, tiles and tile groups into frame buffers at the bit
depth, then deblocking, CDEF, superres upscaling, loop restoration and
film grain, in that order, cropped to the frame size.

`decode_av1(data)` returns the planes of the first shown frame (Y, and U
and V unless the stream is monochrome) as uint16 arrays, with the
sequence header and the frame header.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import av1_obu as O
from .av1_block import FrameDecoder, Stats


@dataclass
class DecodedFrame:
    planes: list               # uint16 [h, w] per plane
    seq: O.SequenceHeader
    hdr: O.FrameHeader
    stats: Stats


def decode_av1(data: bytes, stats: Stats = None) -> DecodedFrame:
    stats = stats if stats is not None else Stats()
    seq = None
    hdr = None
    fd = None
    tiles_done = 0
    for obu in O.split_obus(data):
        if obu.type == O.OBU_SEQUENCE_HEADER:
            if seq is None:
                seq = O.parse_sequence_header(obu.data)
            continue
        if obu.type in (O.OBU_TEMPORAL_DELIMITER, O.OBU_PADDING,
                        O.OBU_METADATA, O.OBU_TILE_LIST):
            continue
        if seq is None:
            raise O.AV1Error("AV1: a frame before the sequence header")
        idc = seq.operating_point_idc[0] if seq.operating_point_idc else 0
        if idc and obu.has_extension:
            in_t = (idc >> obu.temporal_id) & 1
            in_s = (idc >> (obu.spatial_id + 8)) & 1
            if not in_t or not in_s:
                continue
        if obu.type in (O.OBU_FRAME_HEADER, O.OBU_REDUNDANT_FRAME_HEADER,
                        O.OBU_FRAME):
            if hdr is not None and obu.type != O.OBU_FRAME:
                continue        # a copy of the frame header
            hdr = O.parse_frame_header(obu.data, seq, obu)
            if not hdr.show_frame:
                raise NotImplementedError(
                    "AV1: a frame that is not shown (show_frame 0) in the "
                    "first temporal unit")
            if seq.operating_point_idc and seq.operating_point_idc[0]:
                raise NotImplementedError(
                    "AV1: a layered (scalable) stream, operating point 0 "
                    "with idc 0x%x" % seq.operating_point_idc[0])
            fd = FrameDecoder(seq, hdr, stats)
            stats.hit("bitdepth_%d" % seq.BitDepth)
            stats.hit("mono" if seq.mono_chrome else "subsampling_%d%d" % (
                seq.subsampling_x, seq.subsampling_y))
            tiles_done = 0
            if obu.type == O.OBU_FRAME:
                tiles_done = _tile_group(fd, obu.data, hdr.header_bytes,
                                         tiles_done)
        elif obu.type == O.OBU_TILE_GROUP:
            if fd is None:
                raise O.AV1Error("AV1: a tile group before its frame header")
            tiles_done = _tile_group(fd, obu.data, 0, tiles_done)
        if fd is not None and tiles_done == hdr.TileCols * hdr.TileRows:
            break
    if fd is None or tiles_done != hdr.TileCols * hdr.TileRows:
        raise O.AV1Error("AV1: no complete frame in the data")
    planes = finish_frame(fd)
    return DecodedFrame(planes, seq, hdr, stats)


def _tile_group(fd, data, pos, tiles_done):
    hdr = fd.hdr
    num_tiles = hdr.TileCols * hdr.TileRows
    r = O.BitReader(data, pos)
    flag = r.f(1) if num_tiles > 1 else 0
    if num_tiles == 1 or not flag:
        tg_start, tg_end = 0, num_tiles - 1
    else:
        bits = hdr.TileColsLog2 + hdr.TileRowsLog2
        tg_start, tg_end = r.f(bits), r.f(bits)
    r.byte_alignment()
    pos = r.pos
    if tg_start != tiles_done:
        raise O.AV1Error("AV1: tile groups out of order")
    if num_tiles > 1:
        fd.stats.hit("tiles")
    for tile in range(tg_start, tg_end + 1):
        row, col = divmod(tile, hdr.TileCols)
        if tile == tg_end:
            size = len(data) - pos
        else:
            if pos + hdr.TileSizeBytes > len(data):
                raise O.AV1Error("AV1: truncated tile size")
            size = int.from_bytes(data[pos:pos + hdr.TileSizeBytes],
                                  "little") + 1
            pos += hdr.TileSizeBytes
        if pos + size > len(data) or size < 1:
            raise O.AV1Error("AV1: a tile runs past its tile group")
        fd.decode_tile(data, pos, size, row, col)
        pos += size
    return tg_end + 1


def finish_frame(fd):
    """The post-decode filters, then the crop to the frame size."""
    from . import av1_cdef, av1_grain, av1_loopfilter, av1_restoration
    seq, hdr = fd.seq, fd.hdr
    av1_loopfilter.loop_filter_frame(fd)
    pre_cdef = [p.copy() for p in fd.frame]
    av1_cdef.cdef_frame(fd)
    planes = av1_restoration.superres_and_restore(fd, pre_cdef)
    out = []
    for p, arr in enumerate(planes):
        sx = seq.subsampling_x if p else 0
        sy = seq.subsampling_y if p else 0
        w = (hdr.UpscaledWidth + sx) >> sx
        h = (hdr.FrameHeight + sy) >> sy
        out.append(np.ascontiguousarray(arr[:h, :w]).astype(np.uint16))
    if hdr.film_grain.apply_grain:
        fd.stats.hit("film_grain")
        out = av1_grain.apply_film_grain(out, seq, hdr)
    return out
