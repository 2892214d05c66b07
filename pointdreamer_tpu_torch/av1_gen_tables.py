"""Writes `av1_cdf.py` and `av1_data.py`, the AV1 specification's tables
that are not defined by a formula (default CDFs, quantizer lookups and
matrices, the film-grain Gaussian sequence, filter taps), copied from the
read-only data of AV1 libraries built from the reference sources.

Not imported by the package.  Run it where the libraries are, naming each:

    python -m pointdreamer_tpu_torch.av1_gen_tables \\
        --libaom <libaom.so.3 (3.6.0)> --libdav1d <libdav1d.so.6> \\
        --libavif <a libavif with aom 3.12.1 linked in (Pillow 12.1's)>

Each table is read at a fixed file offset of the build named; the script
checks the leading values the specification gives before it writes, so
another build of a library fails loudly instead of writing wrong tables.
libaom keeps CDFs as 32768 - cdf, one array per context, sometimes padded
to a larger alphabet, with a trailing 0 and an adaptation counter; the
written tables are in the specification's form: the N - 1 cumulative
values, 32768, then the counter 0.
"""
from __future__ import annotations

import argparse
import base64
import os
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, library, offset, spec shape without the last axis, stride in
#  uint16 between contexts, number of symbols N)
CDFS = [
    ("Default_Intra_Frame_Y_Mode_Cdf", "aom", 0x444080, (5, 5), 14, 13),
    ("Default_Uv_Mode_Cfl_Not_Allowed_Cdf", "aom", 0x443D60, (13,), 15, 13),
    ("Default_Uv_Mode_Cfl_Allowed_Cdf", "aom", 0x443EE6, (13,), 15, 14),
    ("Default_Angle_Delta_Cdf", "aom", 0x444460, (8,), 8, 7),
    ("Default_Partition_W8_Cdf", "aom", 0x443BA0, (4,), 11, 4),
    ("Default_Partition_W16_Cdf", "aom", 0x443BA0 + 2 * 44, (4,), 11, 10),
    ("Default_Partition_W32_Cdf", "aom", 0x443BA0 + 2 * 88, (4,), 11, 10),
    ("Default_Partition_W64_Cdf", "aom", 0x443BA0 + 2 * 132, (4,), 11, 10),
    ("Default_Partition_W128_Cdf", "aom", 0x443BA0 + 2 * 176, (4,), 11, 8),
    # libaom's intra_ext_tx_cdf[set][square size][mode][17]: set 1 holds
    # the seven-type set (sizes 4x4 and 8x8 used), set 2 the five-type set
    ("Default_Intra_Tx_Type_Set1_Cdf", "aom", 0x442DC8, (2, 13), 17, 7),
    ("Default_Intra_Tx_Type_Set2_Cdf", "aom", 0x4434B0, (3, 13), 17, 5),
    ("Default_Cfl_Sign_Cdf", "aom", 0x444C50, (), 9, 8),
    ("Default_Cfl_Alpha_Cdf", "avif", 0x4426E0, (6,), 17, 16),
    ("Default_Filter_Intra_Mode_Cdf", "avif", 0x478CE0, (), 8, 5),
    # this build stores the six unused 16384 contexts (10..15) once: the
    # stride is a list of each context's word index
    ("Default_Filter_Intra_Cdfs", "aom", 0x444A20, (22,),
     [3 * i for i in range(10)] + [30] * 6 + [32, 35, 38, 41, 44, 47], 2),
    ("Default_Palette_Y_Mode_Cdf", "aom", 0x444550, (7, 3),
     [3 * i for i in range(19)] + [58, 61], 2),
    ("Default_Palette_Uv_Mode_Cdf", "avif", 0x47941C, (2,), 2, 2),
    ("Default_Palette_Y_Size_Cdf", "aom", 0x444380, (7,), 8, 7),
    ("Default_Palette_Uv_Size_Cdf", "aom", 0x4443F0, (7,), 8, 7),
    ("Default_Intrabc_Cdf", "avif", 0x479424, (), 2, 2),
    ("Default_Skip_Cdf", "aom", 0x444B80, (3,), 3, 2),
    ("Default_Segment_Id_Cdf", "aom", 0x444BA0, (3,), 8, 8),
    ("Default_Tx_8x8_Cdf", "aom", 0x444BD0, (3,), 4, 2),
    ("Default_Tx_16x16_Cdf", "aom", 0x444BD0 + 2 * 12, (3,), 4, 3),
    ("Default_Tx_32x32_Cdf", "aom", 0x444BD0 + 2 * 24, (3,), 4, 3),
    ("Default_Tx_64x64_Cdf", "aom", 0x444BD0 + 2 * 36, (3,), 4, 3),
    ("Default_Delta_Q_Cdf", "aom", 0x444C30, (), 5, 4),
    ("Default_Delta_Lf_Cdf", "aom", 0x444C3A, (), 5, 4),
    ("Default_Restoration_Type_Cdf", "avif", 0x4792F0, (), 4, 3),
    ("Default_Use_Wiener_Cdf", "avif", 0x4792F8, (), 2, 2),
    ("Default_Use_Sgrproj_Cdf", "avif", 0x4792FC, (), 2, 2),
    ("Default_Mv_Joint_Cdf", "aom", 0x444D40, (), 5, 4),
    ("Default_Mv_Class_Cdf", "aom", 0x444D4A, (), 12, 11),
    ("Default_Mv_Sign_Cdf", "aom", 0x444D80, (), 3, 2),
    ("Default_Mv_Class0_Bit_Cdf", "aom", 0x444D92, (), 3, 2),
    ("Default_Mv_Bit_Cdf", "aom", 0x444D98, (10,), 3, 2),
    ("Default_Inter_Tx_Type_Set1_Cdf", "aom", 0x442548, (2,), 17, 16),
    ("Default_Inter_Tx_Type_Set2_Cdf", "aom", 0x4425D0 + 2 * 34, (), 17,
     12),
    ("Default_Inter_Tx_Type_Set3_Cdf", "aom", 0x442658, (4,), 17, 2),
    ("Default_Txfm_Split_Cdf", "avif", 0x479368, (21,), 2, 2),
] + [
    ("Default_Palette_Size_%d_%s_Color_Cdf" % (n, yuv), "aom",
     base + (n - 2) * 5 * 9 * 2, (5,), 9, n)
    for yuv, base in (("Y", 0x441F40), ("Uv", 0x441CC0))
    for n in range(2, 9)
] + [
    ("Default_Txb_Skip_Cdf", "aom", 0x441440, (4, 5, 13), 3, 2),
    ("Default_Eob_Pt_16_Cdf", "aom", 0x440B00, (4, 2, 2), 6, 5),
    ("Default_Eob_Pt_32_Cdf", "aom", 0x440A20, (4, 2, 2), 7, 6),
    ("Default_Eob_Pt_64_Cdf", "aom", 0x440920, (4, 2, 2), 8, 7),
    ("Default_Eob_Pt_128_Cdf", "aom", 0x440800, (4, 2, 2), 9, 8),
    ("Default_Eob_Pt_256_Cdf", "aom", 0x4406C0, (4, 2, 2), 10, 9),
    # libaom keeps [q][plane][2]; only context 0 is read at 512 and 1024
    ("Default_Eob_Pt_512_Cdf", "aom", 0x440560, (4, 2, 2), 11, 10),
    ("Default_Eob_Pt_1024_Cdf", "aom", 0x4403E0, (4, 2, 2), 12, 11),
    ("Default_Eob_Extra_Cdf", "aom", 0x440BC0, (4, 5, 2, 9), 3, 2),
    ("Default_Dc_Sign_Cdf", "aom", 0x441A60, (4, 2, 3), 3, 2),
    ("Default_Coeff_Base_Eob_Cdf", "aom", 0x439C60, (4, 5, 2, 4), 4, 3),
    ("Default_Coeff_Base_Cdf", "aom", 0x43A160, (4, 5, 2, 42), 5, 4),
    ("Default_Coeff_Br_Cdf", "aom", 0x43E300, (4, 5, 2, 21), 5, 4),
]

# leading cumulative values the specification gives, checked before writing
CHECK = {
    "Default_Intra_Frame_Y_Mode_Cdf": (15588, 17027, 19338),
    "Default_Uv_Mode_Cfl_Not_Allowed_Cdf": (22631, 24152, 25378),
    "Default_Uv_Mode_Cfl_Allowed_Cdf": (10407, 11208, 12900),
    "Default_Angle_Delta_Cdf": (2180, 5032, 7567),
    "Default_Partition_W8_Cdf": (19132, 25510, 30392),
    "Default_Intra_Tx_Type_Set1_Cdf": (1535, 8035, 9461),
    "Default_Intra_Tx_Type_Set2_Cdf": (6554, 13107, 19661),
    "Default_Cfl_Sign_Cdf": (1418, 2123, 13340),
    "Default_Cfl_Alpha_Cdf": (7637, 20719, 31401),
    "Default_Filter_Intra_Mode_Cdf": (8949, 12776, 17211),
    "Default_Filter_Intra_Cdfs": (4621,),
    "Default_Palette_Y_Mode_Cdf": (31676,),
    "Default_Palette_Uv_Mode_Cdf": (32461,),
    "Default_Palette_Y_Size_Cdf": (7952, 13000, 18149),
    "Default_Palette_Uv_Size_Cdf": (8713, 19979, 27128),
    "Default_Intrabc_Cdf": (30531,),
    "Default_Skip_Cdf": (31671,),
    "Default_Segment_Id_Cdf": (5622, 7893, 16093),
    "Default_Tx_8x8_Cdf": (19968,),
    "Default_Tx_16x16_Cdf": (12272, 30172),
    "Default_Delta_Q_Cdf": (28160, 32120, 32677),
    "Default_Delta_Lf_Cdf": (28160, 32120, 32677),
    "Default_Restoration_Type_Cdf": (9413, 22581),
    "Default_Use_Wiener_Cdf": (11570,),
    "Default_Use_Sgrproj_Cdf": (16855,),
    "Default_Mv_Joint_Cdf": (4096, 11264, 19328),
    "Default_Mv_Class_Cdf": (28672, 30976, 31858),
    "Default_Mv_Sign_Cdf": (16384,),
    "Default_Mv_Class0_Bit_Cdf": (27648,),
    "Default_Mv_Bit_Cdf": (17408,),
    "Default_Txb_Skip_Cdf": (31849,),
    "Default_Inter_Tx_Type_Set1_Cdf": (4458, 5560, 7695),
    "Default_Inter_Tx_Type_Set2_Cdf": (770, 2421, 5225),
    "Default_Inter_Tx_Type_Set3_Cdf": (16384, 32768, 0, 4167),
    "Default_Txfm_Split_Cdf": (28581, 32768, 0, 23846),
    "Default_Palette_Size_2_Y_Color_Cdf": (28710, 32768, 0, 16384),
    "Default_Palette_Size_2_Uv_Color_Cdf": (29089, 32768, 0, 16384),
    "Default_Eob_Pt_16_Cdf": (840, 1039, 1980),
    "Default_Eob_Extra_Cdf": (16961,),
    "Default_Dc_Sign_Cdf": (16000,),
    "Default_Coeff_Base_Eob_Cdf": (17837, 29055),
    "Default_Coeff_Base_Cdf": (4034, 8930, 12727),
}

# (name, library, offset, dtype, shape)
DATA = [
    ("Dc_Qlookup_8", "aom", 0x477660, "<i2", (256,)),
    ("Dc_Qlookup_10", "aom", 0x477460, "<i2", (256,)),
    ("Dc_Qlookup_12", "aom", 0x477260, "<i2", (256,)),
    ("Ac_Qlookup_8", "aom", 0x477060, "<i2", (256,)),
    ("Ac_Qlookup_10", "aom", 0x476E60, "<i2", (256,)),
    ("Ac_Qlookup_12", "aom", 0x476C60, "<i2", (256,)),
    ("Quantizer_Matrix", "aom", 0x445CA0, "u1", (15, 2, 3344)),
    ("Gaussian_Sequence", "dav1d", 0x17AB00, "<i2", (2048,)),
    ("Upscale_Filter", "aom", 0x479240, "<i2", (64, 8)),
    ("Sm_Weights", "aom", 0x42D9A8, "u1", (124,)),
    ("Dr_Intra_Derivative", "aom", 0x478A80, "<u2", (90,)),
    # libaom pads each row of seven taps to eight
    ("Intra_Filter_Taps", "aom", 0x478920, "i1", (5, 8, 8)),
    # libaom keeps {r0, r1, s0, s1}
    ("Sgr_Params", "aom", 0x47B6E0, "<i4", (16, 4)),
]

DATA_CHECK = {
    "Dc_Qlookup_8": (4, 8, 8, 9, 10), "Dc_Qlookup_10": (4, 9, 10, 13, 15),
    "Dc_Qlookup_12": (4, 12, 18, 25, 33), "Ac_Qlookup_8": (4, 8, 9, 10, 11),
    "Ac_Qlookup_10": (4, 9, 11, 13, 16), "Ac_Qlookup_12": (4, 13, 19, 27, 35),
    "Quantizer_Matrix": (32, 43, 73, 97, 43, 67),
    "Gaussian_Sequence": (56, 568, -180, 172),
    "Upscale_Filter": (0, 0, 0, 128, 0, 0, 0, 0, 0, 0, -1, 128, 2, -1),
    "Sm_Weights": (255, 149, 85, 64, 255, 197, 146, 105),
    "Dr_Intra_Derivative": (0, 0, 0, 1023, 0, 0, 547),
    "Intra_Filter_Taps": (-6, 10, 0, 0, 0, 12, 0, 0),
    "Sgr_Params": (2, 1, 140, 3236),
}

LIBNAMES = {"aom": "libaom 3.6.0 (libaom.so.3)",
            "dav1d": "dav1d (libdav1d.so.6.6.0)",
            "avif": "Pillow 12.1's libavif 1.3.0 (aom 3.12.1 inside)"}


def read_cdf(blob, offset, shape, stride, n):
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if isinstance(stride, list):
        words = np.frombuffer(blob, "<u2", max(stride) + n, offset)
        raw = np.stack([words[i:i + n] for i in stride]).astype(np.int64)
    else:
        raw = np.frombuffer(blob, "<u2", count * stride, offset).reshape(
            count, stride).astype(np.int64)
    vals = 32768 - raw[:, :n - 1]
    if (np.diff(vals, axis=1) < 0).any() or (vals <= 0).any() or \
            (vals >= 32768).any():
        raise ValueError("not a CDF at 0x%x" % offset)
    full = np.concatenate([vals, np.full((count, 1), 32768),
                           np.zeros((count, 1), np.int64)], axis=1)
    return full.reshape(tuple(shape) + (n + 1,))


def _pack(arr):
    return base64.b64encode(zlib.compress(
        np.ascontiguousarray(arr).tobytes(), 9)).decode()


def generate(libs):
    blobs = {k: open(v, "rb").read() for k, v in libs.items()}
    cdfs = {}
    for name, lib, off, shape, stride, n in CDFS:
        cdfs[name] = read_cdf(blobs[lib], off, shape, stride, n)
        want = CHECK.get(name)
        if want and tuple(cdfs[name].reshape(-1)[:len(want)]) != want:
            raise ValueError("%s: leading values %s, not %s" % (
                name, cdfs[name].reshape(-1)[:len(want)], want))
    # only context 0 of the largest eob tables is in the specification
    for big in ("Default_Eob_Pt_512_Cdf", "Default_Eob_Pt_1024_Cdf"):
        cdfs[big] = cdfs[big][:, :, 0]
    data = {}
    for name, lib, off, dtype, shape in DATA:
        n = int(np.prod(shape))
        data[name] = np.frombuffer(blobs[lib], dtype, n, off).reshape(shape)
        want = DATA_CHECK[name]
        if tuple(data[name].reshape(-1)[:len(want)]) != want:
            raise ValueError("%s: leading values differ" % name)
    data["Intra_Filter_Taps"] = data["Intra_Filter_Taps"][:, :, :7]
    r0, r1, s0, s1 = data["Sgr_Params"].T
    data["Sgr_Params"] = np.stack([r0, s0, r1, s1], axis=1)
    src = {name: (lib, off) for name, lib, off, *_ in CDFS + DATA}

    head = ['"""AV1 default CDFs in the specification\'s form (the N - 1',
            'cumulative values, 32768, the counter 0), generated by',
            '`python -m pointdreamer_tpu_torch.av1_gen_tables`: do not edit.',
            '',
            'Source of each table (library, file offset):', '']
    for name in cdfs:
        lib, off = src[name]
        head.append("- %s: %s, 0x%x" % (name, LIBNAMES[lib], off))
    head += ["- Default_Segment_Id_Predicted_Cdf and Default_Delta_Lf_Multi",
             "  are the specification's 128 * 128 and Default_Delta_Lf_Cdf",
             "  copies.", '"""']
    lines = head + ["import base64", "import zlib", "", "import numpy as np",
                    "", "", "def _t(shape, packed):",
                    "    return np.frombuffer(zlib.decompress(base64."
                    "b64decode(packed)), np.int32).reshape(shape)", "", ""]
    for name, arr in cdfs.items():
        lines.append("%s = _t(%r, %r)" % (name, tuple(arr.shape),
                                         _pack(arr.astype(np.int32))))
    lines.append("Default_Segment_Id_Predicted_Cdf = np.array("
                 "[[128 * 128, 32768, 0]] * 3, np.int32)")
    lines.append("Default_Delta_Lf_Multi_Cdf = np.repeat("
                 "Default_Delta_Lf_Cdf[None], 4, axis=0)")
    with open(os.path.join(HERE, "av1_cdf.py"), "w") as f:
        f.write("\n".join(lines) + "\n")

    head = ['"""AV1 tables other than CDFs that the specification lists',
            'rather than derives, generated by',
            '`python -m pointdreamer_tpu_torch.av1_gen_tables`: do not edit.',
            '',
            'Source of each table (library, file offset):', '']
    for name in data:
        lib, off = src[name]
        head.append("- %s: %s, 0x%x" % (name, LIBNAMES[lib], off))
    head += ["", "Sgr_Params is reordered to the specification's",
             "{r0, s0, r1, s1}; Intra_Filter_Taps drops libaom's padding.",
             '"""']
    lines = head + ["import base64", "import zlib", "", "import numpy as np",
                    "", "", "def _t(shape, dtype, packed):",
                    "    return np.frombuffer(zlib.decompress(base64."
                    "b64decode(packed)), dtype).reshape(shape).astype("
                    "np.int32)", "", ""]
    for name, arr in data.items():
        arr = np.ascontiguousarray(arr)
        lines.append("%s = _t(%r, %r, %r)" % (name, tuple(arr.shape),
                                             arr.dtype.str, _pack(arr)))
    with open(os.path.join(HERE, "av1_data.py"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--libaom", required=True)
    ap.add_argument("--libdav1d", required=True)
    ap.add_argument("--libavif", required=True)
    a = ap.parse_args(argv)
    generate({"aom": a.libaom, "dav1d": a.libdav1d, "avif": a.libavif})


if __name__ == "__main__":
    main()
