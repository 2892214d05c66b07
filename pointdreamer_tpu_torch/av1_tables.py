"""AV1 tables that the specification defines by a formula or lists in a few
values: block and transform sizes, scans, Cos128 / Sin128, the mode and
transform-type maps, the coefficient contexts, the loop-filter, CDEF and
restoration constants.  The long listed tables (default CDFs, quantizer
lookups and matrices, filter taps, the Gaussian sequence) are generated
into `av1_cdf.py` and `av1_data.py` by `av1_gen_tables.py`.
"""
from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# block sizes (BLOCK_4X4 = 0 ... BLOCK_64X16 = 21), width and height in 4x4s

BLOCK_WH4 = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (4, 4), (4, 8),
             (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
             (32, 32), (1, 4), (4, 1), (2, 8), (8, 2), (4, 16), (16, 4)]
BLOCK_INVALID = 22
BLOCK_4X4, BLOCK_8X8, BLOCK_16X16, BLOCK_32X32, BLOCK_64X64 = 0, 3, 6, 9, 12
BLOCK_128X128 = 15
_BS_OF = {wh: i for i, wh in enumerate(BLOCK_WH4)}
Num_4x4_Blocks_Wide = [w for w, _ in BLOCK_WH4]
Num_4x4_Blocks_High = [h for _, h in BLOCK_WH4]
Block_Width = [4 * w for w in Num_4x4_Blocks_Wide]
Block_Height = [4 * h for h in Num_4x4_Blocks_High]
Mi_Width_Log2 = [w.bit_length() - 1 for w in Num_4x4_Blocks_Wide]
Mi_Height_Log2 = [h.bit_length() - 1 for h in Num_4x4_Blocks_High]


def block_of(w4: int, h4: int) -> int:
    return _BS_OF.get((w4, h4), BLOCK_INVALID)


# partitions
(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
 PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
 PARTITION_HORZ_4, PARTITION_VERT_4) = range(10)


def _subsize(p: int, b: int) -> int:
    w, h = BLOCK_WH4[b]
    if w != h:
        return BLOCK_INVALID
    if p == PARTITION_NONE:
        return b
    if p in (PARTITION_HORZ, PARTITION_HORZ_A, PARTITION_HORZ_B):
        return block_of(w, h // 2) if h > 1 else BLOCK_INVALID
    if p in (PARTITION_VERT, PARTITION_VERT_A, PARTITION_VERT_B):
        return block_of(w // 2, h) if w > 1 else BLOCK_INVALID
    if p == PARTITION_SPLIT:
        return block_of(w // 2, h // 2) if w > 1 else BLOCK_INVALID
    if p == PARTITION_HORZ_4:
        return block_of(w, h // 4) if h >= 4 else BLOCK_INVALID
    return block_of(w // 4, h) if w >= 4 else BLOCK_INVALID


Partition_Subsize = [[_subsize(p, b) for b in range(22)] for p in range(10)]


def subsampled_size(b: int, ssx: int, ssy: int) -> int:
    """Subsampled_Size[b][ssx][ssy]."""
    if b == BLOCK_INVALID:
        return b
    w, h = BLOCK_WH4[b]
    if ssx and not ssy and h > w:
        return BLOCK_INVALID
    if ssy and not ssx and w > h:
        return BLOCK_INVALID
    return block_of(max(1, w >> ssx), max(1, h >> ssy))


# ---------------------------------------------------------------------------
# transform sizes

TX_WH = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
         (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32), (4, 16),
         (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]
(TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16,
 TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4,
 TX_8X32, TX_32X8, TX_16X64, TX_64X16) = range(19)
_TX_OF = {wh: i for i, wh in enumerate(TX_WH)}
Tx_Width = [w for w, _ in TX_WH]
Tx_Height = [h for _, h in TX_WH]
Tx_Width_Log2 = [w.bit_length() - 1 for w in Tx_Width]
Tx_Height_Log2 = [h.bit_length() - 1 for h in Tx_Height]
_SQ = {4: TX_4X4, 8: TX_8X8, 16: TX_16X16, 32: TX_32X32, 64: TX_64X64}
Tx_Size_Sqr = [_SQ[min(w, h)] for w, h in TX_WH]
Tx_Size_Sqr_Up = [_SQ[max(w, h)] for w, h in TX_WH]


def tx_of(w: int, h: int) -> int:
    return _TX_OF[(w, h)]


Max_Tx_Size_Rect = [tx_of(min(64, 4 * w), min(64, 4 * h))
                    for w, h in BLOCK_WH4]
Max_Tx_Depth = [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3,
                4, 4]


def _split(t: int) -> int:
    w, h = TX_WH[t]
    if w == h:
        return tx_of(max(4, w // 2), max(4, h // 2))
    if w > h:
        return tx_of(w // 2, h) if w // 2 >= h else tx_of(w // 2, h)
    return tx_of(w, h // 2)


Split_Tx_Size = [TX_4X4 if t == TX_4X4 else _split(t) for t in range(19)]
Adjusted_Tx_Size = [tx_of(min(32, w), min(32, h)) for w, h in TX_WH]
Transform_Row_Shift = [0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
                       2]
Qm_Offset = {TX_4X4: 0, TX_8X8: 16, TX_16X16: 80, TX_32X32: 336,
             TX_4X8: 1360, TX_8X4: 1392, TX_8X16: 1424, TX_16X8: 1552,
             TX_16X32: 1680, TX_32X16: 2192, TX_4X16: 2704, TX_16X4: 2768,
             TX_8X32: 2832, TX_32X8: 3088}

# transform types
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
 FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
 V_ADST, H_ADST, V_FLIPADST, H_FLIPADST) = range(16)
# (vertical 1D type, horizontal 1D type): 0 DCT, 1 ADST, 2 FLIPADST, 3 identity
TX_1D = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2), (1, 2),
         (2, 1), (3, 3), (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2)]
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2


def tx_class(t: int) -> int:
    if t in (V_DCT, V_ADST, V_FLIPADST):
        return TX_CLASS_VERT
    if t in (H_DCT, H_ADST, H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 = 0, 1, 2
TX_SET_INTER_1, TX_SET_INTER_2, TX_SET_INTER_3 = 1, 2, 3
Tx_Type_Intra_Inv_Set1 = [IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT,
                          DCT_ADST]
Tx_Type_Intra_Inv_Set2 = [IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST]
Tx_Type_Inter_Inv_Set1 = [IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
                          H_FLIPADST, DCT_DCT, ADST_DCT, DCT_ADST,
                          FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                          FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST]
Tx_Type_Inter_Inv_Set2 = [IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST,
                          FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                          FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST]
Tx_Type_Inter_Inv_Set3 = [IDTX, DCT_DCT]
TX_TYPES_IN_INTRA_SET = {0: {DCT_DCT}, 1: set(Tx_Type_Intra_Inv_Set1),
                         2: set(Tx_Type_Intra_Inv_Set2)}
TX_TYPES_IN_INTER_SET = {0: {DCT_DCT}, 1: set(Tx_Type_Inter_Inv_Set1),
                         2: set(Tx_Type_Inter_Inv_Set2),
                         3: set(Tx_Type_Inter_Inv_Set3)}

# intra modes
(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
 D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED,
 UV_CFL_PRED) = range(14)
Intra_Mode_Context = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]
Mode_To_Angle = [0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0]
Mode_To_Txfm = [DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT,
                DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                ADST_ADST, DCT_DCT]
Filter_Intra_Mode_To_Intra_Dir = [DC_PRED, V_PRED, H_PRED, D157_PRED,
                                  DC_PRED]
Palette_Color_Context = [-1, -1, 0, -1, -1, 4, 3, 2, 1]
Intra_Edge_Kernel = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]]
SM_WEIGHT_OFFSET = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}

# ---------------------------------------------------------------------------
# scans (the specification's Default / Mrow / Mcol scans, by formula)


def default_scan(w: int, h: int) -> np.ndarray:
    out = []
    for s in range(w + h - 1):
        cells = [(r, s - r) for r in range(h) if 0 <= s - r < w]
        if (w == h and s % 2 == 0) or w > h:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return np.array(out, np.int64)


def mrow_scan(w: int, h: int) -> np.ndarray:
    return np.arange(w * h, dtype=np.int64)


def mcol_scan(w: int, h: int) -> np.ndarray:
    i = np.arange(w * h)
    return ((i % h) * w + i // h).astype(np.int64)


# ---------------------------------------------------------------------------
# coefficient contexts

SIG_COEF_CONTEXTS = 42
SIG_COEF_CONTEXTS_2D = 26
Coeff_Base_Pos_Ctx_Offset = [26, 31, 36]
Sig_Ref_Diff_Offset = [[(0, 1), (1, 0), (1, 1), (0, 2), (2, 0)],
                       [(0, 1), (1, 0), (0, 2), (0, 3), (0, 4)],
                       [(0, 1), (1, 0), (2, 0), (3, 0), (4, 0)]]
Mag_Ref_Offset_With_Tx_Class = [[(0, 1), (1, 0), (1, 1)],
                                [(0, 1), (1, 0), (0, 2)],
                                [(0, 1), (1, 0), (2, 0)]]
_SQUARE_CTX = [[0, 1, 6, 6, 21], [1, 6, 6, 21, 21], [6, 6, 21, 21, 21],
               [6, 21, 21, 21, 21], [21, 21, 21, 21, 21]]
_WIDE_CTX = [[0, 16, 6, 6, 21], [16, 16, 6, 21, 21], [16, 16, 21, 21, 21],
             [16, 16, 21, 21, 21], [16, 16, 21, 21, 21]]
_TALL_CTX = [[0, 11, 11, 11, 11], [11, 11, 11, 11, 11], [6, 6, 21, 21, 21],
             [6, 21, 21, 21, 21], [21, 21, 21, 21, 21]]
Coeff_Base_Ctx_Offset = [
    _SQUARE_CTX if w == h else (_WIDE_CTX if w > h else _TALL_CTX)
    for w, h in TX_WH]

# ---------------------------------------------------------------------------
# transforms

Cos128_Lookup = [int(math.floor(4096 * math.cos(i * math.pi / 128) + 0.5))
                 for i in range(65)]
SINPI = (1321, 2482, 3344, 3803)


def cos128(angle: int) -> int:
    a = angle & 255
    if a <= 64:
        return Cos128_Lookup[a]
    if a <= 128:
        return -Cos128_Lookup[128 - a]
    if a <= 192:
        return -Cos128_Lookup[a - 128]
    return Cos128_Lookup[256 - a]


def sin128(angle: int) -> int:
    return cos128(angle - 64)


def brev(n: int, x: int) -> int:
    return int(format(x, "0%db" % n)[::-1], 2) if n else 0


# ---------------------------------------------------------------------------
# segmentation, loop filter, CDEF, restoration

Segmentation_Feature_Bits = [8, 6, 6, 6, 6, 3, 0, 0]
Segmentation_Feature_Signed = [1, 1, 1, 1, 1, 0, 0, 0]
Segmentation_Feature_Max = [255, 63, 63, 63, 63, 7, 0, 0]
SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V, SEG_LVL_REF_FRAME, SEG_LVL_SKIP = 0, 1, 5, 6

Cdef_Uv_Dir = [[[0, 1, 2, 3, 4, 5, 6, 7], [1, 2, 2, 2, 3, 4, 6, 0]],
               [[7, 0, 2, 4, 5, 6, 6, 6], [0, 1, 2, 3, 4, 5, 6, 7]]]
Cdef_Directions = [[[-1, 1], [-2, 2]], [[0, 1], [-1, 2]], [[0, 1], [0, 2]],
                   [[0, 1], [1, 2]], [[1, 1], [2, 2]], [[1, 0], [2, 1]],
                   [[1, 0], [2, 0]], [[1, 0], [2, -1]]]
Cdef_Pri_Taps = [[4, 2], [3, 3]]
Cdef_Sec_Taps = [[2, 1], [2, 1]]
Div_Table = [0, 840, 420, 280, 210, 168, 140, 120, 105]

RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
Remap_Lr_Type = [RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                 RESTORE_SGRPROJ]
Wiener_Taps_Min = [-5, -23, -17]
Wiener_Taps_Max = [10, 8, 46]
Wiener_Taps_K = [1, 2, 3]
Wiener_Taps_Mid = [3, -7, 15]
Sgrproj_Xqd_Min = [-96, -32]
Sgrproj_Xqd_Max = [31, 95]
Sgrproj_Xqd_Mid = [-32, 31]
