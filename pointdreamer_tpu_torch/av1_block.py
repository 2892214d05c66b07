"""AV1 tile decoding (specification sections 5.11 and 7.11): superblocks and
partitions (all ten types, 64x64 and 128x128), intra frame mode info
(segment id, skip, cdef_idx, delta q / lf, the y and uv modes, angle
deltas, filter intra, CFL alphas, palette with its colour cache and the
wavefront colour-index contexts), IntraBC (its DV and the intra frame's
part of the MV-stack process), tx_size, loop-restoration coefficients,
then each transform block's prediction and reconstruction.
"""
from __future__ import annotations

import copy

import numpy as np

from . import av1_cdf as C
from . import av1_intra as P
from . import av1_residual as R
from . import av1_tables as T
from .av1_obu import TX_MODE_SELECT, qindex
from .av1_symbol import SymbolDecoder
from .av1_transform import inverse_transform_2d


def _cdf_tree(arr):
    return np.asarray(arr).tolist()


def default_cdfs(base_q_idx: int) -> dict:
    """The frame's initial CDFs (init_non_coeff_cdfs, init_coeff_cdfs)."""
    q = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else \
        2 if base_q_idx <= 120 else 3
    c = {
        "y_mode": _cdf_tree(C.Default_Intra_Frame_Y_Mode_Cdf),
        "uv_mode_cfl_not_allowed": _cdf_tree(
            C.Default_Uv_Mode_Cfl_Not_Allowed_Cdf),
        "uv_mode_cfl_allowed": _cdf_tree(C.Default_Uv_Mode_Cfl_Allowed_Cdf),
        "angle_delta": _cdf_tree(C.Default_Angle_Delta_Cdf),
        "partition": [_cdf_tree(C.Default_Partition_W8_Cdf),
                      _cdf_tree(C.Default_Partition_W16_Cdf),
                      _cdf_tree(C.Default_Partition_W32_Cdf),
                      _cdf_tree(C.Default_Partition_W64_Cdf),
                      _cdf_tree(C.Default_Partition_W128_Cdf)],
        "intra_tx_set1": _cdf_tree(C.Default_Intra_Tx_Type_Set1_Cdf),
        "intra_tx_set2": _cdf_tree(C.Default_Intra_Tx_Type_Set2_Cdf),
        "inter_tx_set1": _cdf_tree(C.Default_Inter_Tx_Type_Set1_Cdf),
        "inter_tx_set2": _cdf_tree(C.Default_Inter_Tx_Type_Set2_Cdf),
        "inter_tx_set3": _cdf_tree(C.Default_Inter_Tx_Type_Set3_Cdf),
        "cfl_sign": _cdf_tree(C.Default_Cfl_Sign_Cdf),
        "cfl_alpha": _cdf_tree(C.Default_Cfl_Alpha_Cdf),
        "filter_intra_mode": _cdf_tree(C.Default_Filter_Intra_Mode_Cdf),
        "filter_intra": _cdf_tree(C.Default_Filter_Intra_Cdfs),
        "palette_y_mode": _cdf_tree(C.Default_Palette_Y_Mode_Cdf),
        "palette_uv_mode": _cdf_tree(C.Default_Palette_Uv_Mode_Cdf),
        "palette_y_size": _cdf_tree(C.Default_Palette_Y_Size_Cdf),
        "palette_uv_size": _cdf_tree(C.Default_Palette_Uv_Size_Cdf),
        "palette_y_color": [_cdf_tree(getattr(
            C, "Default_Palette_Size_%d_Y_Color_Cdf" % n)) for n in
            range(2, 9)],
        "palette_uv_color": [_cdf_tree(getattr(
            C, "Default_Palette_Size_%d_Uv_Color_Cdf" % n)) for n in
            range(2, 9)],
        "intrabc": _cdf_tree(C.Default_Intrabc_Cdf),
        "skip": _cdf_tree(C.Default_Skip_Cdf),
        "segment_id": _cdf_tree(C.Default_Segment_Id_Cdf),
        "segment_id_predicted": _cdf_tree(
            C.Default_Segment_Id_Predicted_Cdf),
        "tx": [None, _cdf_tree(C.Default_Tx_8x8_Cdf),
               _cdf_tree(C.Default_Tx_16x16_Cdf),
               _cdf_tree(C.Default_Tx_32x32_Cdf),
               _cdf_tree(C.Default_Tx_64x64_Cdf)],
        "txfm_split": _cdf_tree(C.Default_Txfm_Split_Cdf),
        "delta_q": _cdf_tree(C.Default_Delta_Q_Cdf),
        "delta_lf": _cdf_tree(C.Default_Delta_Lf_Cdf),
        "delta_lf_multi": _cdf_tree(C.Default_Delta_Lf_Multi_Cdf),
        "restoration_type": _cdf_tree(C.Default_Restoration_Type_Cdf),
        "use_wiener": _cdf_tree(C.Default_Use_Wiener_Cdf),
        "use_sgrproj": _cdf_tree(C.Default_Use_Sgrproj_Cdf),
        "mv_joint": _cdf_tree(C.Default_Mv_Joint_Cdf),
        "mv_class": [_cdf_tree(C.Default_Mv_Class_Cdf) for _ in range(2)],
        "mv_sign": [_cdf_tree(C.Default_Mv_Sign_Cdf) for _ in range(2)],
        "mv_class0_bit": [_cdf_tree(C.Default_Mv_Class0_Bit_Cdf)
                          for _ in range(2)],
        "mv_bit": [_cdf_tree(C.Default_Mv_Bit_Cdf) for _ in range(2)],
        "txb_skip": _cdf_tree(C.Default_Txb_Skip_Cdf[q]),
        "eob_extra": _cdf_tree(C.Default_Eob_Extra_Cdf[q]),
        "dc_sign": _cdf_tree(C.Default_Dc_Sign_Cdf[q]),
        "coeff_base_eob": _cdf_tree(C.Default_Coeff_Base_Eob_Cdf[q]),
        "coeff_base": _cdf_tree(C.Default_Coeff_Base_Cdf[q]),
        "coeff_br": _cdf_tree(C.Default_Coeff_Br_Cdf[q]),
    }
    for n in (16, 32, 64, 128, 256, 512, 1024):
        c["eob_pt_%d" % n] = _cdf_tree(getattr(C, "Default_Eob_Pt_%d_Cdf"
                                                % n)[q])
    return c


class Block:
    """One decoded block's mode info (what neighbours and the filters read)."""
    __slots__ = ("mi_row", "mi_col", "mi_size", "skip", "is_inter",
                 "segment_id", "y_mode", "uv_mode", "angle_delta_y",
                 "angle_delta_uv", "use_filter_intra", "filter_intra_mode",
                 "cfl_alpha_u", "cfl_alpha_v", "palette_size", "palette",
                 "tx_size", "delta_lf", "lossless", "mv", "has_chroma",
                 "qindex")

    def __init__(self):
        self.palette_size = [0, 0]
        self.palette = [[], [], []]
        self.use_filter_intra = 0
        self.is_inter = 0
        self.mv = (0, 0)


class Stats(dict):
    """Counts of the coding tools a decode ran (for coverage)."""

    def hit(self, key):
        self[key] = self.get(key, 0) + 1


class FrameDecoder:
    """Decodes the tiles of one intra frame into `frame[plane]` (int32)."""

    def __init__(self, seq, hdr, stats=None):
        self.seq, self.hdr = seq, hdr
        self.stats = stats if stats is not None else Stats()
        self.bit_depth = seq.BitDepth
        self.ssx, self.ssy = seq.subsampling_x, seq.subsampling_y
        self.num_planes = seq.NumPlanes
        self.sb128 = seq.use_128x128_superblock
        mi_rows, mi_cols = hdr.MiRows, hdr.MiCols
        pad = 32
        self.mi_rows, self.mi_cols = mi_rows, mi_cols
        rows = (mi_rows + pad) * 4
        cols = (mi_cols + pad) * 4
        self.frame = []
        for p in range(self.num_planes):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            self.frame.append(np.zeros((rows >> sy, cols >> sx), np.int32))
        self.block_map = np.full((mi_rows + pad, mi_cols + pad), -1,
                                 np.int32)
        self.blocks = []
        self.tx_types = np.zeros((mi_rows + pad, mi_cols + pad), np.int8)
        self.inter_tx_sizes = np.zeros((mi_rows + pad, mi_cols + pad),
                                       np.int8)
        self.lf_tx_size = [np.zeros(((mi_rows + pad), (mi_cols + pad)),
                                    np.int8) for _ in range(3)]
        self.cdef_idx = {}
        self.lr = [dict() for _ in range(3)]
        self.defaults = default_cdfs(hdr.base_q_idx)
        n4 = mi_cols + pad
        self.above_level = [[0] * n4 for _ in range(3)]
        self.above_dc = [[0] * n4 for _ in range(3)]
        self.left_level = [[0] * (mi_rows + pad) for _ in range(3)]
        self.left_dc = [[0] * (mi_rows + pad) for _ in range(3)]

    # ------------------------------------------------------------------
    def decode_tile(self, data, start, size, tile_row, tile_col):
        hdr = self.hdr
        self.sd = SymbolDecoder(data, start, size, hdr.disable_cdf_update)
        self.cdf = copy.deepcopy(self.defaults)
        self.mi_row_start = hdr.MiRowStarts[tile_row]
        self.mi_row_end = hdr.MiRowStarts[tile_row + 1]
        self.mi_col_start = hdr.MiColStarts[tile_col]
        self.mi_col_end = hdr.MiColStarts[tile_col + 1]
        self.current_q = hdr.base_q_idx
        for p in range(3):
            for i in range(len(self.above_level[p])):
                self.above_level[p][i] = 0
                self.above_dc[p][i] = 0
        self.delta_lf = [0, 0, 0, 0]
        self.ref_sgr_xqd = [list(T.Sgrproj_Xqd_Mid) for _ in range(3)]
        self.ref_lr_wiener = [[list(T.Wiener_Taps_Mid) for _ in range(2)]
                              for _ in range(3)]
        sb4 = 32 if self.sb128 else 16
        sb_size = T.BLOCK_128X128 if self.sb128 else T.BLOCK_64X64
        for r in range(self.mi_row_start, self.mi_row_end, sb4):
            for p in range(3):
                for i in range(len(self.left_level[p])):
                    self.left_level[p][i] = 0
                    self.left_dc[p][i] = 0
            for c in range(self.mi_col_start, self.mi_col_end, sb4):
                self.read_deltas = hdr.delta_q_present
                self.clear_cdef(r, c)
                self.clear_block_decoded(r, c, sb4)
                self.read_lr(r, c, sb_size)
                self.decode_partition(r, c, sb_size)

    def clear_cdef(self, r, c):
        self.cdef_idx[(r >> 4, c >> 4)] = -1
        if self.sb128:
            for dr, dc in ((0, 1), (1, 0), (1, 1)):
                self.cdef_idx[((r >> 4) + dr, (c >> 4) + dc)] = -1

    def clear_block_decoded(self, r, c, sb4):
        self.block_decoded = []
        for p in range(self.num_planes):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            w4 = (self.mi_col_end - c) >> sx
            h4 = (self.mi_row_end - r) >> sy
            n = (sb4 >> min(sx, sy)) + 3
            bd = np.zeros((n + 2, n + 2), bool)    # index offset 1
            ys = sb4 >> sy
            xs = sb4 >> sx
            for y in range(-1, ys + 1):
                for x in range(-1, xs + 1):
                    if y < 0 and x < w4:
                        bd[y + 1, x + 1] = True
                    elif x < 0 and y < h4:
                        bd[y + 1, x + 1] = True
            bd[ys + 1, 0] = False
            self.block_decoded.append(bd)

    # ------------------------------------------------------------------
    def is_inside(self, r, c):
        return (self.mi_col_start <= c < self.mi_col_end and
                self.mi_row_start <= r < self.mi_row_end)

    def blk_at(self, r, c):
        return self.blocks[self.block_map[r, c]]

    def decode_partition(self, r, c, bsize):
        hdr = self.hdr
        if r >= hdr.MiRows or c >= hdr.MiCols:
            return
        avail_u = self.is_inside(r - 1, c)
        avail_l = self.is_inside(r, c - 1)
        num4 = T.Num_4x4_Blocks_Wide[bsize]
        half = num4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < hdr.MiRows
        has_cols = (c + half) < hdr.MiCols
        bsl = T.Mi_Width_Log2[bsize]
        if bsize < T.BLOCK_8X8:
            partition = T.PARTITION_NONE
        else:
            above = avail_u and T.Mi_Width_Log2[
                self.blk_at(r - 1, c).mi_size] < bsl
            left = avail_l and T.Mi_Height_Log2[
                self.blk_at(r, c - 1).mi_size] < bsl
            ctx = int(left) * 2 + int(above)
            cdf = self.cdf["partition"][bsl - 1][ctx]
            if has_rows and has_cols:
                partition = self.sd.read_symbol(cdf)
            elif has_cols:
                partition = T.PARTITION_SPLIT if self._split_or(
                    cdf, bsize, True) else T.PARTITION_HORZ
            elif has_rows:
                partition = T.PARTITION_SPLIT if self._split_or(
                    cdf, bsize, False) else T.PARTITION_VERT
            else:
                partition = T.PARTITION_SPLIT
        self.stats.hit("partition_%d" % partition)
        if bsize == T.BLOCK_128X128:
            self.stats.hit("sb128")
        sub = T.Partition_Subsize[partition][bsize]
        split = T.Partition_Subsize[T.PARTITION_SPLIT][bsize]
        db = self.decode_block
        if partition == T.PARTITION_NONE:
            db(r, c, sub)
        elif partition == T.PARTITION_HORZ:
            db(r, c, sub)
            if has_rows:
                db(r + half, c, sub)
        elif partition == T.PARTITION_VERT:
            db(r, c, sub)
            if has_cols:
                db(r, c + half, sub)
        elif partition == T.PARTITION_SPLIT:
            self.decode_partition(r, c, sub)
            self.decode_partition(r, c + half, sub)
            self.decode_partition(r + half, c, sub)
            self.decode_partition(r + half, c + half, sub)
        elif partition == T.PARTITION_HORZ_A:
            db(r, c, split)
            db(r, c + half, split)
            db(r + half, c, sub)
        elif partition == T.PARTITION_HORZ_B:
            db(r, c, sub)
            db(r + half, c, split)
            db(r + half, c + half, split)
        elif partition == T.PARTITION_VERT_A:
            db(r, c, split)
            db(r + half, c, split)
            db(r, c + half, sub)
        elif partition == T.PARTITION_VERT_B:
            db(r, c, sub)
            db(r, c + half, split)
            db(r + half, c + half, split)
        elif partition == T.PARTITION_HORZ_4:
            for i in range(4):
                if i == 0 or r + quarter * i < hdr.MiRows:
                    db(r + quarter * i, c, sub)
        else:
            for i in range(4):
                if i == 0 or c + quarter * i < hdr.MiCols:
                    db(r, c + quarter * i, sub)

    def _split_or(self, cdf, bsize, horz):
        """split_or_horz (horz) / split_or_vert: the chance of SPLIT is that
        of every partition splitting the other way."""
        def prob(e):
            return cdf[e] - (cdf[e - 1] if e > 0 else 0)
        if horz:
            parts = [T.PARTITION_VERT, T.PARTITION_SPLIT, T.PARTITION_HORZ_A,
                     T.PARTITION_VERT_A, T.PARTITION_VERT_B]
            if bsize != T.BLOCK_128X128:
                parts.append(T.PARTITION_VERT_4)
        else:
            parts = [T.PARTITION_HORZ, T.PARTITION_SPLIT, T.PARTITION_HORZ_A,
                     T.PARTITION_HORZ_B, T.PARTITION_VERT_A]
            if bsize != T.BLOCK_128X128:
                parts.append(T.PARTITION_HORZ_4)
        psum = sum(prob(e) for e in parts)
        return self._bool_cdf(32768 - psum)

    def _bool_cdf(self, c0):
        save = self.sd.disable_update
        self.sd.disable_update = True
        v = self.sd.read_symbol([c0, 32768, 0])
        self.sd.disable_update = save
        return v

    # ------------------------------------------------------------------
    def decode_block(self, r, c, bsize):
        hdr = self.hdr
        sd = self.sd
        cdf = self.cdf
        b = Block()
        b.mi_row, b.mi_col, b.mi_size = r, c, bsize
        bw4 = T.Num_4x4_Blocks_Wide[bsize]
        bh4 = T.Num_4x4_Blocks_High[bsize]
        if bh4 == 1 and self.ssy and (r & 1) == 0:
            has_chroma = 0
        elif bw4 == 1 and self.ssx and (c & 1) == 0:
            has_chroma = 0
        else:
            has_chroma = int(self.num_planes > 1)
        b.has_chroma = has_chroma
        avail_u = self.is_inside(r - 1, c)
        avail_l = self.is_inside(r, c - 1)
        avail_uc, avail_lc = avail_u, avail_l
        if has_chroma:
            if self.ssy and bh4 == 1:
                avail_uc = self.is_inside(r - 2, c)
            if self.ssx and bw4 == 1:
                avail_lc = self.is_inside(r, c - 2)
        else:
            avail_uc = avail_lc = False
        self.avail = (avail_u, avail_l, avail_uc, avail_lc)
        above = self.blk_at(r - 1, c) if avail_u else None
        left = self.blk_at(r, c - 1) if avail_l else None
        # intra_frame_mode_info
        b.skip = 0
        if hdr.SegIdPreSkip:
            self.intra_segment_id(b, r, c, avail_u, avail_l, bw4, bh4)
        if hdr.SegIdPreSkip and self.seg_feature(b.segment_id,
                                                 T.SEG_LVL_SKIP):
            b.skip = 1
        else:
            ctx = (above.skip if above else 0) + (left.skip if left else 0)
            b.skip = sd.read_symbol(cdf["skip"][ctx])
        if not hdr.SegIdPreSkip:
            self.intra_segment_id(b, r, c, avail_u, avail_l, bw4, bh4)
        b.lossless = hdr.LosslessArray[b.segment_id]
        self.read_cdef(b, r, c, bw4, bh4)
        self.read_delta_qindex(b)
        self.read_delta_lf(b)
        self.read_deltas = 0
        b.qindex = self.current_q
        b.delta_lf = list(self.delta_lf)
        use_intrabc = 0
        if hdr.allow_intrabc:
            use_intrabc = sd.read_symbol(cdf["intrabc"])
        if use_intrabc:
            b.is_inter = 1
            b.y_mode = T.DC_PRED
            b.uv_mode = T.DC_PRED
            b.angle_delta_y = b.angle_delta_uv = 0
            self.stats.hit("intrabc")
            self.read_intrabc_mv(b, r, c, bw4, bh4)
        else:
            actx = T.Intra_Mode_Context[above.y_mode if above else 0]
            lctx = T.Intra_Mode_Context[left.y_mode if left else 0]
            b.y_mode = sd.read_symbol(cdf["y_mode"][actx][lctx])
            self.stats.hit("y_mode_%d" % b.y_mode)
            b.angle_delta_y = 0
            use_angle = bsize >= T.BLOCK_8X8
            if use_angle and 1 <= b.y_mode <= 8:
                b.angle_delta_y = sd.read_symbol(
                    cdf["angle_delta"][b.y_mode - 1]) - 3
                self.stats.hit("angle_delta_%s" % (
                    "neg" if b.angle_delta_y < 0 else
                    "pos" if b.angle_delta_y > 0 else "zero"))
            b.uv_mode = T.DC_PRED
            b.angle_delta_uv = 0
            if has_chroma:
                if b.lossless and T.subsampled_size(
                        bsize, self.ssx, self.ssy) == T.BLOCK_4X4:
                    cfl_allowed = 1
                elif not b.lossless and max(T.Block_Width[bsize],
                                            T.Block_Height[bsize]) <= 32:
                    cfl_allowed = 1
                else:
                    cfl_allowed = 0
                key = "uv_mode_cfl_allowed" if cfl_allowed else \
                    "uv_mode_cfl_not_allowed"
                b.uv_mode = sd.read_symbol(cdf[key][b.y_mode])
                if b.uv_mode == T.UV_CFL_PRED:
                    self.read_cfl_alphas(b)
                    self.stats.hit("cfl")
                if use_angle and 1 <= b.uv_mode <= 8:
                    b.angle_delta_uv = sd.read_symbol(
                        cdf["angle_delta"][b.uv_mode - 1]) - 3
            if (bsize >= T.BLOCK_8X8 and T.Block_Width[bsize] <= 64 and
                    T.Block_Height[bsize] <= 64 and
                    hdr.allow_screen_content_tools):
                self.palette_mode_info(b, above, left, has_chroma, r)
            if (self.seq.enable_filter_intra and b.y_mode == T.DC_PRED and
                    b.palette_size[0] == 0 and
                    max(T.Block_Width[bsize], T.Block_Height[bsize]) <= 32):
                b.use_filter_intra = sd.read_symbol(
                    cdf["filter_intra"][bsize])
                if b.use_filter_intra:
                    b.filter_intra_mode = sd.read_symbol(
                        cdf["filter_intra_mode"])
                    self.stats.hit("filter_intra_%d" % b.filter_intra_mode)
        # store the block before reading its palette tokens and tx size
        idx = len(self.blocks)
        self.blocks.append(b)
        self.block_map[r:r + bh4, c:c + bw4] = idx
        color_maps = self.palette_tokens(b, r, c, bsize)
        self.read_block_tx_size(b, r, c, bsize, bw4, bh4, above, left)
        if b.skip:
            self.reset_block_context(b, r, c, bw4, bh4)
        if b.is_inter:
            self.predict_intrabc(b, r, c, bsize)
        self.residual(b, r, c, bsize, color_maps)

    # ------------------------------------------------------------------
    def seg_feature(self, seg, feature):
        h = self.hdr
        return h.segmentation_enabled and h.FeatureEnabled[seg][feature]

    def intra_segment_id(self, b, r, c, avail_u, avail_l, bw4, bh4):
        hdr = self.hdr
        if not hdr.segmentation_enabled:
            b.segment_id = 0
            return
        prev_ul = self.blk_at(r - 1, c - 1).segment_id if (
            avail_u and avail_l) else -1
        prev_u = self.blk_at(r - 1, c).segment_id if avail_u else -1
        prev_l = self.blk_at(r, c - 1).segment_id if avail_l else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if b.skip:
            b.segment_id = pred
            return
        if prev_ul < 0:
            ctx = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            ctx = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            ctx = 1
        else:
            ctx = 0
        v = self.sd.read_symbol(self.cdf["segment_id"][ctx])
        mx = hdr.LastActiveSegId + 1
        v = _neg_deinterleave(v, pred, mx)
        b.segment_id = max(0, min(hdr.LastActiveSegId, v))
        self.stats.hit("segmentation")

    def read_cdef(self, b, r, c, bw4, bh4):
        hdr = self.hdr
        if (b.skip or hdr.CodedLossless or not self.seq.enable_cdef or
                hdr.allow_intrabc):
            return
        key = (r >> 4, c >> 4)
        if self.cdef_idx.get(key, -1) == -1:
            v = self.sd.read_literal(hdr.cdef_bits)
            for y in range(r >> 4, ((r + bh4 - 1) >> 4) + 1):
                for x in range(c >> 4, ((c + bw4 - 1) >> 4) + 1):
                    self.cdef_idx[(y, x)] = v

    def read_delta_qindex(self, b):
        hdr = self.hdr
        sb_size = T.BLOCK_128X128 if self.sb128 else T.BLOCK_64X64
        if b.mi_size == sb_size and b.skip:
            return
        if self.read_deltas:
            v = self.sd.read_symbol(self.cdf["delta_q"])
            if v == 3:
                rem = self.sd.read_literal(3) + 1
                v = self.sd.read_literal(rem) + (1 << rem) + 1
            if v:
                if self.sd.read_literal(1):
                    v = -v
                self.current_q = max(1, min(255, self.current_q +
                                            (v << hdr.delta_q_res)))
                self.stats.hit("delta_q")

    def read_delta_lf(self, b):
        hdr = self.hdr
        sb_size = T.BLOCK_128X128 if self.sb128 else T.BLOCK_64X64
        if b.mi_size == sb_size and b.skip:
            return
        if self.read_deltas and hdr.delta_lf_present:
            count = 1
            if hdr.delta_lf_multi:
                count = 2 if self.num_planes == 1 else 4
            for i in range(count):
                c = self.cdf["delta_lf_multi"][i] if hdr.delta_lf_multi \
                    else self.cdf["delta_lf"]
                v = self.sd.read_symbol(c)
                if v == 3:
                    rem = self.sd.read_literal(3) + 1
                    v = self.sd.read_literal(rem) + (1 << rem) + 1
                if v:
                    if self.sd.read_literal(1):
                        v = -v
                    self.delta_lf[i] = max(-63, min(63, self.delta_lf[i] +
                                                    (v << hdr.delta_lf_res)))
                    self.stats.hit("delta_lf")

    def read_cfl_alphas(self, b):
        sd, cdf = self.sd, self.cdf
        signs = sd.read_symbol(cdf["cfl_sign"])
        sign_u = (signs + 1) // 3
        sign_v = (signs + 1) % 3
        b.cfl_alpha_u = b.cfl_alpha_v = 0
        if sign_u:
            a = sd.read_symbol(cdf["cfl_alpha"][(sign_u - 1) * 3 + sign_v]) + 1
            b.cfl_alpha_u = -a if sign_u == 1 else a
        if sign_v:
            a = sd.read_symbol(cdf["cfl_alpha"][(sign_v - 1) * 3 + sign_u]) + 1
            b.cfl_alpha_v = -a if sign_v == 1 else a

    # ------------------------------------------------------------------
    def palette_mode_info(self, b, above, left, has_chroma, r):
        sd, cdf = self.sd, self.cdf
        bd = self.bit_depth
        bsize_ctx = T.Mi_Width_Log2[b.mi_size] + \
            T.Mi_Height_Log2[b.mi_size] - 2
        if b.y_mode == T.DC_PRED:
            ctx = int(bool(above and above.palette_size[0] > 0)) + \
                int(bool(left and left.palette_size[0] > 0))
            if sd.read_symbol(cdf["palette_y_mode"][bsize_ctx][ctx]):
                n = sd.read_symbol(cdf["palette_y_size"][bsize_ctx]) + 2
                b.palette_size[0] = n
                cache = self.palette_cache(0, above, left, r)
                colors = []
                for v in cache:
                    if len(colors) >= n:
                        break
                    if sd.read_literal(1):
                        colors.append(v)
                if len(colors) < n:
                    colors.append(sd.read_literal(bd))
                    if len(colors) < n:
                        bits = bd - 3 + sd.read_literal(2)
                        while len(colors) < n:
                            d = sd.read_literal(bits) + 1
                            v = min(colors[-1] + d, (1 << bd) - 1)
                            colors.append(v)
                            rng = (1 << bd) - v - 1
                            bits = min(bits, _ceil_log2(rng))
                b.palette[0] = sorted(colors)
                self.stats.hit("palette_y")
        if has_chroma and b.uv_mode == T.DC_PRED:
            ctx = int(b.palette_size[0] > 0)
            if sd.read_symbol(cdf["palette_uv_mode"][ctx]):
                n = sd.read_symbol(cdf["palette_uv_size"][bsize_ctx]) + 2
                b.palette_size[1] = n
                cache = self.palette_cache(1, above, left, r)
                colors = []
                for v in cache:
                    if len(colors) >= n:
                        break
                    if sd.read_literal(1):
                        colors.append(v)
                if len(colors) < n:
                    colors.append(sd.read_literal(bd))
                    if len(colors) < n:
                        bits = bd - 3 + sd.read_literal(2)
                        while len(colors) < n:
                            d = sd.read_literal(bits)
                            v = min(colors[-1] + d, (1 << bd) - 1)
                            colors.append(v)
                            rng = (1 << bd) - v
                            bits = min(bits, _ceil_log2(rng))
                b.palette[1] = sorted(colors)
                if sd.read_literal(1):          # delta_encode_palette_v
                    bits = bd - 4 + sd.read_literal(2)
                    mx = 1 << bd
                    vs = [sd.read_literal(bd)]
                    for _ in range(1, n):
                        d = sd.read_literal(bits)
                        if d and sd.read_literal(1):
                            d = -d
                        v = vs[-1] + d
                        if v < 0:
                            v += mx
                        if v >= mx:
                            v -= mx
                        vs.append(max(0, min(mx - 1, v)))
                    b.palette[2] = vs
                else:
                    b.palette[2] = [sd.read_literal(bd) for _ in range(n)]
                self.stats.hit("palette_uv")

    def palette_cache(self, plane, above, left, r):
        above_n = 0
        if (r * 4) % 64 != 0 and above is not None:
            above_n = above.palette_size[plane]
        left_n = left.palette_size[plane] if left is not None else 0
        a = above.palette[plane][:above_n] if above_n else []
        lft = left.palette[plane][:left_n] if left_n else []
        ai = li = 0
        out = []
        while ai < above_n and li < left_n:
            ac, lc = a[ai], lft[li]
            if lc < ac:
                if not out or lc != out[-1]:
                    out.append(lc)
                li += 1
            else:
                if not out or ac != out[-1]:
                    out.append(ac)
                ai += 1
                if lc == ac:
                    li += 1
        for v in a[ai:above_n]:
            if not out or v != out[-1]:
                out.append(v)
        for v in lft[li:left_n]:
            if not out or v != out[-1]:
                out.append(v)
        return out

    def palette_tokens(self, b, r, c, bsize):
        maps = [None, None]
        if not (b.palette_size[0] or b.palette_size[1]):
            return maps
        bh, bw = T.Block_Height[bsize], T.Block_Width[bsize]
        on_h = min(bh, (self.hdr.MiRows - r) * 4)
        on_w = min(bw, (self.hdr.MiCols - c) * 4)
        if b.palette_size[0]:
            maps[0] = self._color_map(b.palette_size[0], bw, bh, on_w, on_h,
                                      "palette_y_color")
        if b.palette_size[1]:
            bw2, bh2 = bw >> self.ssx, bh >> self.ssy
            ow2, oh2 = on_w >> self.ssx, on_h >> self.ssy
            if bw2 < 4:
                bw2 += 2
                ow2 += 2
            if bh2 < 4:
                bh2 += 2
                oh2 += 2
            maps[1] = self._color_map(b.palette_size[1], bw2, bh2, ow2, oh2,
                                      "palette_uv_color")
        return maps

    def _color_map(self, n, bw, bh, on_w, on_h, key):
        sd = self.sd
        cdfs = self.cdf[key][n - 2]
        m = np.zeros((bh, bw), np.int64)
        m[0, 0] = sd.read_ns(n)
        mm = [[0] * on_w for _ in range(on_h)]
        mm[0][0] = int(m[0, 0])
        for i in range(1, on_h + on_w - 1):
            for j in range(min(i, on_w - 1), max(0, i - on_h + 1) - 1, -1):
                rr, cc = i - j, j
                scores = [0] * 8
                order = list(range(8))
                if cc > 0:
                    scores[mm[rr][cc - 1]] += 2
                if rr > 0 and cc > 0:
                    scores[mm[rr - 1][cc - 1]] += 1
                if rr > 0:
                    scores[mm[rr - 1][cc]] += 2
                for k in range(3):
                    mx, mi = scores[k], k
                    for l in range(k + 1, n):
                        if scores[l] > mx:
                            mx, mi = scores[l], l
                    if mi != k:
                        mo = order[mi]
                        for l in range(mi, k, -1):
                            scores[l] = scores[l - 1]
                            order[l] = order[l - 1]
                        scores[k] = mx
                        order[k] = mo
                hsh = scores[0] + 2 * scores[1] + 2 * scores[2]
                ctx = T.Palette_Color_Context[hsh]
                idx = sd.read_symbol(cdfs[ctx])
                mm[rr][cc] = order[idx]
        m[:on_h, :on_w] = np.array(mm, np.int64)
        if on_w < bw:
            m[:on_h, on_w:] = m[:on_h, on_w - 1:on_w]
        if on_h < bh:
            m[on_h:, :] = m[on_h - 1:on_h, :]
        return m

    # ------------------------------------------------------------------
    def read_block_tx_size(self, b, r, c, bsize, bw4, bh4, above, left):
        hdr = self.hdr
        if (hdr.TxMode == TX_MODE_SELECT and bsize > T.BLOCK_4X4 and
                b.is_inter and not b.skip and not b.lossless):
            self.read_var_tx_size(b, r, c, bsize, bw4, bh4)
            return
        if b.lossless:
            b.tx_size = T.TX_4X4
        else:
            max_rect = T.Max_Tx_Size_Rect[bsize]
            max_depth = T.Max_Tx_Depth[bsize]
            b.tx_size = max_rect
            allow_select = not b.skip or not b.is_inter
            if (bsize > T.BLOCK_4X4 and allow_select and
                    hdr.TxMode == TX_MODE_SELECT):
                ctx = self._tx_depth_ctx(r, c, max_rect, above, left)
                cat = min(max_depth, 4)
                depth = self.sd.read_symbol(self.cdf["tx"][cat][ctx])
                for _ in range(depth):
                    b.tx_size = T.Split_Tx_Size[b.tx_size]
        self.inter_tx_sizes[r:r + bh4, c:c + bw4] = b.tx_size

    def _tx_depth_ctx(self, r, c, max_rect, above, left):
        max_w = T.Tx_Width[max_rect]
        max_h = T.Tx_Height[max_rect]
        if above is not None:
            if above.is_inter:
                above_w = T.Block_Width[above.mi_size]
            else:
                above_w = T.Tx_Width[int(self.inter_tx_sizes[r - 1, c])]
        else:
            above_w = 0
        if left is not None:
            if left.is_inter:
                left_h = T.Block_Height[left.mi_size]
            else:
                left_h = T.Tx_Height[int(self.inter_tx_sizes[r, c - 1])]
        else:
            left_h = 0
        return int(above_w >= max_w) + int(left_h >= max_h)

    def read_var_tx_size(self, b, r, c, bsize, bw4, bh4):
        max_tx = T.Max_Tx_Size_Rect[bsize]
        w4 = T.Tx_Width[max_tx] >> 2
        h4 = T.Tx_Height[max_tx] >> 2
        for row in range(r, r + bh4, h4):
            for col in range(c, c + bw4, w4):
                self._read_var_tx(b, row, col, max_tx, 0)
        b.tx_size = max_tx

    def _read_var_tx(self, b, row, col, tx_sz, depth):
        hdr = self.hdr
        if row >= hdr.MiRows or col >= hdr.MiCols:
            return
        if tx_sz == T.TX_4X4 or depth == 2:
            split = 0
        else:
            ctx = self._txfm_split_ctx(b, row, col, tx_sz)
            split = self.sd.read_symbol(self.cdf["txfm_split"][ctx])
        w4 = T.Tx_Width[tx_sz] >> 2
        h4 = T.Tx_Height[tx_sz] >> 2
        if split:
            sub = T.Split_Tx_Size[tx_sz]
            sw4 = T.Tx_Width[sub] >> 2
            sh4 = T.Tx_Height[sub] >> 2
            for i in range(0, h4, sh4):
                for j in range(0, w4, sw4):
                    self._read_var_tx(b, row + i, col + j, sub, depth + 1)
        else:
            self.inter_tx_sizes[row:row + h4, col:col + w4] = tx_sz

    def _txfm_split_ctx(self, b, row, col, tx_sz):
        above = self.is_inside(row - 1, col)
        left = self.is_inside(row, col - 1)
        above_w = left_h = 0
        if above:
            ab = self.blk_at(row - 1, col)
            if ab.skip and ab.is_inter:
                above_w = T.Block_Width[ab.mi_size]
            else:
                above_w = T.Tx_Width[int(self.inter_tx_sizes[row - 1, col])]
        if left:
            lb = self.blk_at(row, col - 1)
            if lb.skip and lb.is_inter:
                left_h = T.Block_Height[lb.mi_size]
            else:
                left_h = T.Tx_Height[int(self.inter_tx_sizes[row, col - 1])]
        above_ = int(above_w < T.Tx_Width[tx_sz]) if above else 0
        left_ = int(left_h < T.Tx_Height[tx_sz]) if left else 0
        size = min(64, max(T.Block_Width[b.mi_size],
                           T.Block_Height[b.mi_size]))
        max_tx_sz = T.tx_of(size, size)
        tx_sz_sqr_up = T.Tx_Size_Sqr_Up[tx_sz]
        return (tx_sz_sqr_up != max_tx_sz) * 3 + \
            (4 - max_tx_sz) * 6 + above_ + left_

    def reset_block_context(self, b, r, c, bw4, bh4):
        for p in range(1 + 2 * b.has_chroma):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            for i in range(c >> sx, (c + bw4) >> sx):
                self.above_level[p][i] = 0
                self.above_dc[p][i] = 0
            for i in range(r >> sy, (r + bh4) >> sy):
                self.left_level[p][i] = 0
                self.left_dc[p][i] = 0

    # ------------------------------------------------------------------
    def read_lr(self, r, c, bsize):
        hdr = self.hdr
        if hdr.allow_intrabc:
            return
        w = T.Num_4x4_Blocks_Wide[bsize]
        h = T.Num_4x4_Blocks_High[bsize]
        for p in range(self.num_planes):
            if hdr.FrameRestorationType[p] == T.RESTORE_NONE:
                continue
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            unit = hdr.LoopRestorationSize[p]
            rows = _count_units(unit, _round2(hdr.FrameHeight, sy))
            cols = _count_units(unit, _round2(hdr.UpscaledWidth, sx))
            row_start = (r * (4 >> sy) + unit - 1) // unit
            row_end = min(rows, ((r + h) * (4 >> sy) + unit - 1) // unit)
            if hdr.use_superres:
                num = (4 >> sx) * hdr.SuperresDenom
                den = unit * 8
            else:
                num = 4 >> sx
                den = unit
            col_start = (c * num + den - 1) // den
            col_end = min(cols, ((c + w) * num + den - 1) // den)
            for ur in range(row_start, row_end):
                for uc in range(col_start, col_end):
                    self.read_lr_unit(p, ur, uc)

    def read_lr_unit(self, p, ur, uc):
        sd, cdf, hdr = self.sd, self.cdf, self.hdr
        ft = hdr.FrameRestorationType[p]
        if ft == T.RESTORE_WIENER:
            t = T.RESTORE_WIENER if sd.read_symbol(cdf["use_wiener"]) else \
                T.RESTORE_NONE
        elif ft == T.RESTORE_SGRPROJ:
            t = T.RESTORE_SGRPROJ if sd.read_symbol(cdf["use_sgrproj"]) \
                else T.RESTORE_NONE
        else:
            t = sd.read_symbol(cdf["restoration_type"])
        unit = {"type": t}
        if t == T.RESTORE_WIENER:
            coef = [[0, 0, 0], [0, 0, 0]]
            for pas in range(2):
                first = 1 if p else 0
                for j in range(first, 3):
                    v = self._subexp_signed(
                        T.Wiener_Taps_Min[j], T.Wiener_Taps_Max[j] + 1,
                        T.Wiener_Taps_K[j], self.ref_lr_wiener[p][pas][j])
                    coef[pas][j] = v
                    self.ref_lr_wiener[p][pas][j] = v
            unit["wiener"] = coef
            self.stats.hit("lr_wiener")
        elif t == T.RESTORE_SGRPROJ:
            from . import av1_data as D
            s = sd.read_literal(4)
            xqd = [0, 0]
            for i in range(2):
                radius = int(D.Sgr_Params[s][i * 2])
                mn, mx = T.Sgrproj_Xqd_Min[i], T.Sgrproj_Xqd_Max[i]
                if radius:
                    v = self._subexp_signed(mn, mx + 1, 4,
                                            self.ref_sgr_xqd[p][i])
                else:
                    v = 0
                    if i == 1:
                        v = max(mn, min(mx, (1 << 7) -
                                        self.ref_sgr_xqd[p][0]))
                xqd[i] = v
                self.ref_sgr_xqd[p][i] = v
            unit["set"] = s
            unit["xqd"] = xqd
            self.stats.hit("lr_sgrproj")
        self.lr[p][(ur, uc)] = unit

    def _subexp_signed(self, low, high, k, ref):
        x = self._subexp_unsigned_ref(high - low, k, ref - low)
        return x + low

    def _subexp_unsigned_ref(self, mx, k, r):
        v = self._subexp(mx, k)
        if (r << 1) <= mx:
            return _inverse_recenter(r, v)
        return mx - 1 - _inverse_recenter(mx - 1 - r, v)

    def _subexp(self, num_syms, k):
        sd = self.sd
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num_syms <= mk + 3 * a:
                return sd.read_ns(num_syms - mk) + mk
            if sd.read_literal(1):
                i += 1
                mk += a
            else:
                return sd.read_literal(b2) + mk

    # ------------------------------------------------------------------
    def get_tx_size(self, plane, tx_size, bsize):
        if plane == 0:
            return tx_size
        uv = T.Max_Tx_Size_Rect[T.subsampled_size(bsize, self.ssx, self.ssy)]
        if T.Tx_Width[uv] == 64 or T.Tx_Height[uv] == 64:
            if T.Tx_Width[uv] == 16:
                return T.TX_16X32
            if T.Tx_Height[uv] == 16:
                return T.TX_32X16
            return T.TX_32X32
        return uv

    def residual(self, b, r, c, bsize, color_maps):
        width_chunks = max(1, T.Block_Width[bsize] >> 6)
        height_chunks = max(1, T.Block_Height[bsize] >> 6)
        for cy in range(height_chunks):
            for cx in range(width_chunks):
                mi_row_chunk = r + (cy << 4)
                mi_col_chunk = c + (cx << 4)
                for p in range(1 + 2 * b.has_chroma):
                    tx_sz = T.TX_4X4 if b.lossless else \
                        self.get_tx_size(p, b.tx_size, bsize)
                    step_x = T.Tx_Width[tx_sz] >> 2
                    step_y = T.Tx_Height[tx_sz] >> 2
                    sx = self.ssx if p else 0
                    sy = self.ssy if p else 0
                    psz = T.subsampled_size(bsize, sx, sy)
                    n4w = T.Num_4x4_Blocks_Wide[psz]
                    n4h = T.Num_4x4_Blocks_High[psz]
                    if b.is_inter and not b.lossless and p == 0:
                        self._transform_tree_var(b, mi_row_chunk,
                                                 mi_col_chunk, bsize)
                        continue
                    base_x = (c >> sx) * 4
                    base_y = (r >> sy) * 4
                    for y in range(0, min(n4h, 16 >> sy), step_y):
                        for x in range(0, min(n4w, 16 >> sx), step_x):
                            self.transform_block(
                                b, p, base_x, base_y, tx_sz,
                                x + ((cx << 4) >> sx),
                                y + ((cy << 4) >> sy), color_maps)

    def _transform_tree_var(self, b, mi_row_chunk, mi_col_chunk, bsize):
        """transform_tree over one 64 x 64 chunk of an IntraBC block's luma."""
        self._transform_tree(b, mi_col_chunk * 4, mi_row_chunk * 4,
                             min(64, T.Block_Width[bsize]),
                             min(64, T.Block_Height[bsize]))

    def _transform_tree(self, b, start_x, start_y, w, h):
        if start_x >= self.hdr.MiCols * 4 or start_y >= self.hdr.MiRows * 4:
            return
        tx_sz = int(self.inter_tx_sizes[start_y >> 2, start_x >> 2])
        if w <= T.Tx_Width[tx_sz] and h <= T.Tx_Height[tx_sz]:
            self.transform_block(b, 0, start_x, start_y, T.tx_of(w, h), 0,
                                 0, [None, None])
            return
        if w > h:
            parts = [(0, 0, w // 2, h), (w // 2, 0, w // 2, h)]
        elif w < h:
            parts = [(0, 0, w, h // 2), (0, h // 2, w, h // 2)]
        else:
            parts = [(0, 0, w // 2, h // 2), (w // 2, 0, w // 2, h // 2),
                     (0, h // 2, w // 2, h // 2),
                     (w // 2, h // 2, w // 2, h // 2)]
        for dx, dy, ww, hh in parts:
            self._transform_tree(b, start_x + dx, start_y + dy, ww, hh)

    def transform_block(self, b, plane, base_x, base_y, tx_sz, x, y,
                        color_maps):
        hdr = self.hdr
        start_x = base_x + 4 * x
        start_y = base_y + 4 * y
        sx = self.ssx if plane else 0
        sy = self.ssy if plane else 0
        row = (start_y << sy) >> 2
        col = (start_x << sx) >> 2
        sb_mask = 31 if self.sb128 else 15
        sub_row = row & sb_mask
        sub_col = col & sb_mask
        step_x = T.Tx_Width[tx_sz] >> 2
        step_y = T.Tx_Height[tx_sz] >> 2
        max_x = (hdr.MiCols * 4) >> sx
        max_y = (hdr.MiRows * 4) >> sy
        if start_x >= max_x or start_y >= max_y:
            return
        frame = self.frame[plane]
        w, h = T.Tx_Width[tx_sz], T.Tx_Height[tx_sz]
        bdec = self.block_decoded[plane]
        self.stats.hit("tx_size_%d" % tx_sz)
        if not b.is_inter:
            if b.palette_size[int(plane > 0)]:
                m = color_maps[int(plane > 0)]
                pal = np.array(b.palette[plane], np.int64)
                frame[start_y:start_y + h, start_x:start_x + w] = \
                    pal[m[y * 4:y * 4 + h, x * 4:x * 4 + w]]
            else:
                is_cfl = plane > 0 and b.uv_mode == T.UV_CFL_PRED
                if plane == 0:
                    mode = b.y_mode
                else:
                    mode = T.DC_PRED if is_cfl else b.uv_mode
                avail_u, avail_l, avail_uc, avail_lc = self.avail
                have_left = (avail_l if plane == 0 else avail_lc) or x > 0
                have_above = (avail_u if plane == 0 else avail_uc) or y > 0
                ar = bdec[(sub_row >> sy) - 1 + 1, (sub_col >> sx) + step_x
                          + 1]
                bl = bdec[(sub_row >> sy) + step_y + 1, (sub_col >> sx)
                          - 1 + 1]
                self.predict_intra(b, plane, start_x, start_y, have_left,
                                   have_above, bool(ar), bool(bl), mode,
                                   w, h)
                if is_cfl:
                    alpha = b.cfl_alpha_u if plane == 1 else b.cfl_alpha_v
                    P.cfl_pred(self.frame[0], frame, start_x, start_y, w, h,
                               self.ssx, self.ssy, self.max_luma_w,
                               self.max_luma_h, alpha, self.bit_depth)
            if plane == 0:
                self.max_luma_w = start_x + step_x * 4
                self.max_luma_h = start_y + step_y * 4
        if not b.skip:
            eob, quant, tx_type = R.read_coeffs(self, plane, start_x,
                                                start_y, tx_sz, b)
            if eob > 0:
                if not b.is_inter:
                    self.stats.hit("tx_type_%d" % tx_type)
                if b.lossless:
                    self.stats.hit("lossless")
                if self.hdr.using_qmatrix:
                    self.stats.hit("qm")
                deq = R.dequantize(self, plane, tx_sz, tx_type, quant, b,
                                   b.lossless)
                res = inverse_transform_2d(deq, tx_sz, tx_type, b.lossless,
                                           self.bit_depth)
                blk = frame[start_y:start_y + h, start_x:start_x + w]
                frame[start_y:start_y + h, start_x:start_x + w] = np.clip(
                    blk + res, 0, (1 << self.bit_depth) - 1)
        lf = self.lf_tx_size[plane]
        lf[(row >> sy):(row >> sy) + step_y,
           (col >> sx):(col >> sx) + step_x] = tx_sz
        bdec[(sub_row >> sy) + 1:(sub_row >> sy) + step_y + 1,
             (sub_col >> sx) + 1:(sub_col >> sx) + step_x + 1] = True

    def predict_intra(self, b, plane, x, y, have_left, have_above,
                      have_above_right, have_below_left, mode, w, h):
        hdr = self.hdr
        sx = self.ssx if plane else 0
        sy = self.ssy if plane else 0
        max_x = ((hdr.MiCols * 4) >> sx) - 1
        max_y = ((hdr.MiRows * 4) >> sy) - 1
        frame = self.frame[plane]
        bd = self.bit_depth
        above, left = P.edges(frame, x, y, w, h, have_left, have_above,
                              have_above_right, have_below_left, max_x,
                              max_y, bd)
        if plane == 0 and b.use_filter_intra:
            pred = P.filter_intra_pred(above, left, w, h,
                                       b.filter_intra_mode, bd)
        elif 1 <= mode <= 8:
            delta = b.angle_delta_y if plane == 0 else b.angle_delta_uv
            p_angle = T.Mode_To_Angle[mode] + delta * 3
            ft = self.filter_type(b, plane)
            pred = P.directional_pred(
                above, left, w, h, p_angle, have_left, have_above,
                self.seq.enable_intra_edge_filter, ft, max_x - x + 1,
                max_y - y + 1, bd)
        elif mode in (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED):
            pred = P.smooth_pred(above, left, w, h, mode)
        elif mode == T.DC_PRED:
            pred = P.dc_pred(above, left, w, h, have_left, have_above, bd)
        else:
            pred = P.paeth_pred(above, left, w, h)
        frame[y:y + h, x:x + w] = pred

    def filter_type(self, b, plane):
        avail_u, avail_l, avail_uc, avail_lc = self.avail
        r, c = b.mi_row, b.mi_col
        above_smooth = left_smooth = False
        if avail_u if plane == 0 else avail_uc:
            rr, cc = r - 1, c
            if plane > 0:
                if self.ssx and not (c & 1):
                    cc += 1
                if self.ssy and (r & 1):
                    rr -= 1
            above_smooth = self._is_smooth(rr, cc, plane)
        if avail_l if plane == 0 else avail_lc:
            rr, cc = r, c - 1
            if plane > 0:
                if self.ssx and (c & 1):
                    cc -= 1
                if self.ssy and not (r & 1):
                    rr += 1
            left_smooth = self._is_smooth(rr, cc, plane)
        return int(above_smooth or left_smooth)

    def _is_smooth(self, r, c, plane):
        nb = self.blk_at(r, c)
        if plane == 0:
            mode = nb.y_mode
        else:
            if nb.is_inter:
                return False
            mode = nb.uv_mode
        return mode in (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED)

    # ------------------------------------------------------------------
    def set_tx_types(self, x4, y4, w4, h4, t):
        self.tx_types[y4:y4 + h4, x4:x4 + w4] = t

    def get_tx_set(self, tx_sz, b):
        sqr = T.Tx_Size_Sqr[tx_sz]
        up = T.Tx_Size_Sqr_Up[tx_sz]
        if up > T.TX_32X32:
            return T.TX_SET_DCTONLY
        if b.is_inter:
            if self.hdr.reduced_tx_set or up == T.TX_32X32:
                return T.TX_SET_INTER_3
            if sqr == T.TX_16X16:
                return T.TX_SET_INTER_2
            return T.TX_SET_INTER_1
        if up == T.TX_32X32:
            return T.TX_SET_DCTONLY
        if self.hdr.reduced_tx_set or sqr == T.TX_16X16:
            return T.TX_SET_INTRA_2
        return T.TX_SET_INTRA_1

    def qindex_of(self, b):
        return qindex(self.hdr, b.segment_id, b.qindex)

    def read_tx_type(self, x4, y4, tx_sz, b):
        tset = self.get_tx_set(tx_sz, b)
        t = T.DCT_DCT
        q = qindex(self.hdr, b.segment_id, None) if \
            self.hdr.segmentation_enabled else self.hdr.base_q_idx
        if tset > 0 and q > 0:
            sqr = T.Tx_Size_Sqr[tx_sz]
            if b.is_inter:
                if tset == T.TX_SET_INTER_1:
                    v = self.sd.read_symbol(self.cdf["inter_tx_set1"][sqr])
                    t = T.Tx_Type_Inter_Inv_Set1[v]
                elif tset == T.TX_SET_INTER_2:
                    v = self.sd.read_symbol(self.cdf["inter_tx_set2"])
                    t = T.Tx_Type_Inter_Inv_Set2[v]
                else:
                    v = self.sd.read_symbol(self.cdf["inter_tx_set3"][sqr])
                    t = T.Tx_Type_Inter_Inv_Set3[v]
            else:
                intra_dir = T.Filter_Intra_Mode_To_Intra_Dir[
                    b.filter_intra_mode] if b.use_filter_intra else b.y_mode
                if tset == T.TX_SET_INTRA_1:
                    v = self.sd.read_symbol(
                        self.cdf["intra_tx_set1"][sqr][intra_dir])
                    t = T.Tx_Type_Intra_Inv_Set1[v]
                else:
                    v = self.sd.read_symbol(
                        self.cdf["intra_tx_set2"][sqr][intra_dir])
                    t = T.Tx_Type_Intra_Inv_Set2[v]
        self.set_tx_types(x4, y4, T.Tx_Width[tx_sz] >> 2,
                          T.Tx_Height[tx_sz] >> 2, t)

    def compute_tx_type(self, plane, tx_sz, x4, y4, b):
        if b.lossless or T.Tx_Size_Sqr_Up[tx_sz] > T.TX_32X32:
            return T.DCT_DCT
        tset = self.get_tx_set(tx_sz, b)
        if plane == 0:
            return int(self.tx_types[y4, x4])
        if b.is_inter:
            xx = max(b.mi_col, x4 << self.ssx)
            yy = max(b.mi_row, y4 << self.ssy)
            t = int(self.tx_types[yy, xx])
            return t if t in T.TX_TYPES_IN_INTER_SET[tset] else T.DCT_DCT
        t = T.Mode_To_Txfm[b.uv_mode]
        return t if t in T.TX_TYPES_IN_INTRA_SET[tset] else T.DCT_DCT

    # ------------------------------------------------------------------
    def read_intrabc_mv(self, b, r, c, bw4, bh4):
        from .av1_intrabc import read_dv
        read_dv(self, b, r, c, bw4, bh4)

    def predict_intrabc(self, b, r, c, bsize):
        from .av1_intrabc import predict
        predict(self, b, r, c, bsize)


def _neg_deinterleave(diff, ref, mx):
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        if diff & 1:
            return ref + ((diff + 1) >> 1)
        return ref - (diff >> 1)
    return mx - (diff + 1)


def _ceil_log2(x):
    if x < 2:
        return 0
    return (x - 1).bit_length()


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def _count_units(unit, size):
    return max((size + (unit >> 1)) // unit, 1)


def _inverse_recenter(r, v):
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)
