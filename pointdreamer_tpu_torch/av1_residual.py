"""AV1 coefficients (specification sections 5.11.39 and 7.12.3): all_zero,
the end of block, base levels, the range and Golomb remainders, the DC
sign, each with its context; and dequantisation (Dc/Ac lookups at 8, 10
and 12 bits, the quantizer matrices, dqDenom and the clamps).
"""
from __future__ import annotations

import numpy as np

from . import av1_data as D
from . import av1_tables as T

_DC_Q = {8: D.Dc_Qlookup_8, 10: D.Dc_Qlookup_10, 12: D.Dc_Qlookup_12}
_AC_Q = {8: D.Ac_Qlookup_8, 10: D.Ac_Qlookup_10, 12: D.Ac_Qlookup_12}


def dc_q(bit_depth: int, b: int) -> int:
    return int(_DC_Q[bit_depth][max(0, min(255, b))])


def ac_q(bit_depth: int, b: int) -> int:
    return int(_AC_Q[bit_depth][max(0, min(255, b))])


_SCANS = {}


def get_scan(tx_size: int, tx_type: int) -> np.ndarray:
    key = (tx_size, tx_type)
    s = _SCANS.get(key)
    if s is not None:
        return s
    if tx_size == T.TX_16X64:
        w, h = 16, 32
    elif tx_size == T.TX_64X16:
        w, h = 32, 16
    elif T.Tx_Size_Sqr_Up[tx_size] == T.TX_64X64:
        w, h = 32, 32
    else:
        w, h = T.Tx_Width[tx_size], T.Tx_Height[tx_size]
    if tx_type in (T.V_DCT, T.V_ADST, T.V_FLIPADST):
        s = T.mrow_scan(w, h)
    elif tx_type in (T.H_DCT, T.H_ADST, T.H_FLIPADST):
        s = T.mcol_scan(w, h)
    else:
        s = T.default_scan(w, h)
    s = [int(v) for v in s]
    _SCANS[key] = s
    return s


def _dq_denom_shift(tx_size: int) -> int:
    pels = T.Tx_Width[tx_size] * T.Tx_Height[tx_size]
    return int(pels > 256) + int(pels > 1024)


def read_coeffs(td, plane, start_x, start_y, tx_size, blk):
    """coeffs(): returns (eob, Quant as a dict pos -> signed level,
    PlaneTxType)."""
    sd = td.sd
    cdf = td.cdf
    x4, y4 = start_x >> 2, start_y >> 2
    w4, h4 = T.Tx_Width[tx_size] >> 2, T.Tx_Height[tx_size] >> 2
    tx_sz_ctx = (T.Tx_Size_Sqr[tx_size] + T.Tx_Size_Sqr_Up[tx_size] + 1) >> 1
    ptype = int(plane > 0)
    above_l = td.above_level[plane]
    left_l = td.left_level[plane]
    above_d = td.above_dc[plane]
    left_d = td.left_dc[plane]
    ssx = td.ssx if plane else 0
    ssy = td.ssy if plane else 0
    max_x4 = td.hdr.MiCols >> ssx if plane else td.hdr.MiCols
    max_y4 = td.hdr.MiRows >> ssy if plane else td.hdr.MiRows
    lx4, ly4 = x4, y4                     # context columns / rows
    # all_zero context
    bsize = T.subsampled_size(blk.mi_size, ssx, ssy)
    w, h = T.Tx_Width[tx_size], T.Tx_Height[tx_size]
    nx = max(0, min(w4, max_x4 - x4))
    ny = max(0, min(h4, max_y4 - y4))
    if plane == 0:
        top = max(above_l[lx4:lx4 + nx], default=0)
        left = max(left_l[ly4:ly4 + ny], default=0)
        top, left = min(top, 255), min(left, 255)
        if T.Block_Width[bsize] == w and T.Block_Height[bsize] == h:
            ctx = 0
        elif top == 0 and left == 0:
            ctx = 1
        elif top == 0 or left == 0:
            ctx = 2 + (max(top, left) > 3)
        elif max(top, left) <= 3:
            ctx = 4
        elif min(top, left) <= 3:
            ctx = 5
        else:
            ctx = 6
    else:
        above = 0
        for k in range(nx):
            above |= above_l[lx4 + k] | above_d[lx4 + k]
        left = 0
        for k in range(ny):
            left |= left_l[ly4 + k] | left_d[ly4 + k]
        ctx = 7 + (above != 0) + (left != 0)
        if T.Block_Width[bsize] * T.Block_Height[bsize] > w * h:
            ctx += 3
    all_zero = sd.read_symbol(cdf["txb_skip"][tx_sz_ctx][ctx])
    quant = {}
    eob = 0
    cul_level = 0
    dc_category = 0
    plane_tx_type = T.DCT_DCT
    if all_zero:
        if plane == 0:
            td.set_tx_types(x4, y4, w4, h4, T.DCT_DCT)
    else:
        if plane == 0:
            td.read_tx_type(x4, y4, tx_size, blk)
        plane_tx_type = td.compute_tx_type(plane, tx_size, x4, y4, blk)
        scan = get_scan(tx_size, plane_tx_type)
        eob_multi = min(T.Tx_Width_Log2[tx_size], 5) + \
            min(T.Tx_Height_Log2[tx_size], 5) - 4
        cls = T.tx_class(plane_tx_type)
        ectx = 0 if cls == T.TX_CLASS_2D else 1
        if eob_multi <= 4:
            c = cdf["eob_pt_%d" % (16 << eob_multi)][ptype][ectx]
        else:
            c = cdf["eob_pt_%d" % (16 << eob_multi)][ptype]
        eob_pt = sd.read_symbol(c) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        eob_shift = eob_pt - 3
        if eob_shift >= 0:
            if sd.read_symbol(cdf["eob_extra"][tx_sz_ctx][ptype][eob_pt - 3]):
                eob += 1 << eob_shift
            for i in range(1, max(0, eob_pt - 2)):
                eob_shift = max(0, eob_pt - 2) - 1 - i
                if sd.read_bool():
                    eob += 1 << eob_shift
        adj = T.Adjusted_Tx_Size[tx_size]
        bwl = T.Tx_Width_Log2[adj]
        txw = 1 << bwl
        txh = T.Tx_Height[adj]
        base_cdf = cdf["coeff_base"][tx_sz_ctx][ptype]
        eob_cdf = cdf["coeff_base_eob"][tx_sz_ctx][ptype]
        br_cdf = cdf["coeff_br"][min(tx_sz_ctx, 3)][ptype]
        ctx_off = T.Coeff_Base_Ctx_Offset[tx_size]
        sig = T.Sig_Ref_Diff_Offset[cls]
        mag_ref = T.Mag_Ref_Offset_With_Tx_Class[cls]
        area = txh << bwl
        levels = [0] * (txw * txh)
        for c in range(eob - 1, -1, -1):
            pos = scan[c]
            row = pos >> bwl
            col = pos - (row << bwl)
            if c == eob - 1:
                if c == 0:
                    ectx2 = 0
                elif c <= area // 8:
                    ectx2 = 1
                elif c <= area // 4:
                    ectx2 = 2
                else:
                    ectx2 = 3
                level = sd.read_symbol(eob_cdf[ectx2]) + 1
            else:
                mag = 0
                for dr, dc in sig:
                    rr, cc = row + dr, col + dc
                    if rr < txh and cc < txw:
                        v = levels[(rr << bwl) + cc]
                        mag += v if v < 3 else 3
                bctx = min((mag + 1) >> 1, 4)
                if cls == T.TX_CLASS_2D:
                    if row == 0 and col == 0:
                        bctx = 0
                    else:
                        bctx += ctx_off[min(row, 4)][min(col, 4)]
                else:
                    idx = row if cls == T.TX_CLASS_VERT else col
                    bctx += T.Coeff_Base_Pos_Ctx_Offset[min(idx, 2)]
                level = sd.read_symbol(base_cdf[bctx])
            if level > 2:
                mag = 0
                for dr, dc in mag_ref:
                    rr, cc = row + dr, col + dc
                    if rr < txh and cc < txw:
                        v = levels[(rr << bwl) + cc]
                        mag += v if v < 15 else 15
                mag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    rctx = mag
                elif cls == T.TX_CLASS_2D:
                    rctx = mag + 7 if (row < 2 and col < 2) else mag + 14
                elif cls == T.TX_CLASS_HORIZ:
                    rctx = mag + 7 if col == 0 else mag + 14
                else:
                    rctx = mag + 7 if row == 0 else mag + 14
                bc = br_cdf[rctx]
                for _ in range(4):
                    br = sd.read_symbol(bc)
                    level += br
                    if br < 3:
                        break
            levels[pos] = level
        # signs and Golomb remainders, in scan order
        dc_cdf = cdf["dc_sign"][ptype]
        for c in range(eob):
            pos = scan[c]
            lv = levels[pos]
            if lv == 0:
                continue
            if c == 0:
                dc_sign = 0
                for k in range(nx):
                    s = above_d[lx4 + k]
                    dc_sign += -1 if s == 1 else (1 if s == 2 else 0)
                for k in range(ny):
                    s = left_d[ly4 + k]
                    dc_sign += -1 if s == 1 else (1 if s == 2 else 0)
                sctx = 1 if dc_sign < 0 else (2 if dc_sign > 0 else 0)
                sign = sd.read_symbol(dc_cdf[sctx])
            else:
                sign = sd.read_bool()
            if lv > 14:
                lv = sd.read_golomb() + 15
            if pos == 0:
                dc_category = 1 if sign else 2
            lv &= 0xFFFFF
            cul_level += lv
            quant[pos] = -lv if sign else lv
        cul_level = min(63, cul_level)
    for k in range(w4):
        if lx4 + k < len(above_l):
            above_l[lx4 + k] = cul_level
            above_d[lx4 + k] = dc_category
    for k in range(h4):
        if ly4 + k < len(left_l):
            left_l[ly4 + k] = cul_level
            left_d[ly4 + k] = dc_category
    return eob, quant, plane_tx_type


def dequantize(td, plane, tx_size, tx_type, quant, blk, lossless):
    """Dequant[i][j] of the coded (at most 32 x 32) region."""
    hdr = td.hdr
    bd = td.bit_depth
    q_index = td.qindex_of(blk)
    if plane == 0:
        dcq = dc_q(bd, q_index + hdr.DeltaQYDc)
        acq = ac_q(bd, q_index)
    elif plane == 1:
        dcq = dc_q(bd, q_index + hdr.DeltaQUDc)
        acq = ac_q(bd, q_index + hdr.DeltaQUAc)
    else:
        dcq = dc_q(bd, q_index + hdr.DeltaQVDc)
        acq = ac_q(bd, q_index + hdr.DeltaQVAc)
    w, h = T.Tx_Width[tx_size], T.Tx_Height[tx_size]
    tw, th = min(32, w), min(32, h)
    out = np.zeros((th, tw), np.int64)
    qm = None
    if hdr.using_qmatrix and not lossless and tx_type < T.IDTX:
        level = hdr.SegQMLevel[plane][blk.segment_id]
        if level < 15:
            adj = T.Adjusted_Tx_Size[tx_size]
            off = T.Qm_Offset[adj]
            qm = D.Quantizer_Matrix[level][int(plane > 0)][off:off + tw * th]
    shift = _dq_denom_shift(tx_size)
    lim = 1 << (7 + bd)
    for pos, v in quant.items():
        i, j = divmod(pos, tw)
        q = dcq if pos == 0 else acq
        if qm is not None:
            q = (q * int(qm[pos]) + 16) >> 5
        dq = (abs(v) * q) & 0xFFFFFF
        dq >>= shift
        if v < 0:
            dq = -dq
        out[i, j] = max(-lim, min(lim - 1, dq))
    return out
