"""Intel DCX decoding, as PIL 12.1's DcxImagePlugin reads it: the first
page of its directory, read by `pcx.py` as a PCX at its offset (the
256-colour palette is still looked for at the end of the whole file, as
PIL looks for it)."""
from __future__ import annotations

import struct

from .imagemode import ModeImage, NotThisFormat
from .pcx import decode_pcx, probe as pcx_probe


def accepts(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] == 0x3ADE68B1


def probe(data: bytes) -> int:
    """DcxImageFile._open: the first page's offset (its PCX header checked
    as PcxImageFile checks it)."""
    if not accepts(data) or len(data) < 8:
        raise NotThisFormat("not a DCX file")
    offset, = struct.unpack_from("<I", data, 4)
    if not offset:
        raise NotThisFormat("DCX: an empty page directory")
    pcx_probe(data, offset)
    return offset


def decode_dcx(data: bytes) -> ModeImage:
    """DCX bytes -> its first page in PIL's mode."""
    return decode_pcx(data, probe(data))
