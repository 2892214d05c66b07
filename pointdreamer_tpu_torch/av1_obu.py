"""AV1 OBUs and headers (specification sections 5 and 6): OBU headers and
extensions, the sequence header (with `reduced_still_picture_header` and
the colour config), the uncompressed header of a key or intra-only frame,
`tile_info` and the tile groups of operating point 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import av1_tables as T

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER = 1, 2, 3
OBU_TILE_GROUP, OBU_METADATA, OBU_FRAME = 4, 5, 6
OBU_REDUNDANT_FRAME_HEADER, OBU_TILE_LIST, OBU_PADDING = 7, 8, 15
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = range(4)
PRIMARY_REF_NONE = 7
ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT = range(3)


class AV1Error(ValueError):
    """The AV1 data breaks the specification."""


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.bit = pos * 8

    def f(self, n: int) -> int:
        x = 0
        for _ in range(n):
            byte = self.bit >> 3
            if byte >= len(self.data):
                raise AV1Error("header runs past its OBU")
            x = (x << 1) | ((self.data[byte] >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        sign = 1 << (n - 1)
        return v - 2 * sign if v & sign else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1

    def byte_alignment(self):
        while self.bit & 7:
            self.f(1)

    @property
    def pos(self) -> int:
        return self.bit >> 3


def leb128(data: bytes, pos: int):
    value = 0
    for i in range(8):
        if pos + i >= len(data):
            raise AV1Error("truncated leb128")
        b = data[pos + i]
        value |= (b & 0x7F) << (i * 7)
        if not b & 0x80:
            return value, pos + i + 1
    raise AV1Error("leb128 too long")


@dataclass
class Obu:
    type: int
    temporal_id: int
    spatial_id: int
    has_extension: bool
    data: bytes          # the payload


def split_obus(data: bytes):
    """The OBUs of a low-overhead bitstream (AVIF keeps them so)."""
    pos, out = 0, []
    while pos < len(data):
        h = data[pos]
        if h & 0x80:
            raise AV1Error("obu_forbidden_bit set")
        typ = (h >> 3) & 15
        ext = (h >> 2) & 1
        has_size = (h >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            if pos >= len(data):
                raise AV1Error("truncated OBU extension")
            tid, sid = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise AV1Error("OBU runs past the data")
        out.append(Obu(typ, tid, sid, bool(ext), data[pos:pos + size]))
        pos += size
    return out


@dataclass
class SequenceHeader:
    seq_profile: int = 0
    still_picture: int = 0
    reduced_still_picture_header: int = 0
    operating_point_idc: list = field(default_factory=list)
    decoder_model_info_present: int = 0
    equal_picture_interval: int = 0
    buffer_removal_time_length_minus_1: int = 0
    frame_presentation_time_length_minus_1: int = 0
    decoder_model_present_for_this_op: list = field(default_factory=list)
    frame_width_bits_minus_1: int = 0
    frame_height_bits_minus_1: int = 0
    max_frame_width_minus_1: int = 0
    max_frame_height_minus_1: int = 0
    frame_id_numbers_present_flag: int = 0
    delta_frame_id_length_minus_2: int = 0
    additional_frame_id_length_minus_1: int = 0
    use_128x128_superblock: int = 0
    enable_filter_intra: int = 0
    enable_intra_edge_filter: int = 0
    enable_order_hint: int = 0
    enable_warped_motion: int = 0
    seq_force_screen_content_tools: int = 2
    seq_force_integer_mv: int = 2
    OrderHintBits: int = 0
    enable_superres: int = 0
    enable_cdef: int = 0
    enable_restoration: int = 0
    BitDepth: int = 8
    mono_chrome: int = 0
    NumPlanes: int = 3
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: int = 0
    film_grain_params_present: int = 0


def parse_sequence_header(data: bytes) -> SequenceHeader:
    r = BitReader(data)
    s = SequenceHeader()
    s.seq_profile = r.f(3)
    if s.seq_profile > 2:
        raise AV1Error("seq_profile %d" % s.seq_profile)
    s.still_picture = r.f(1)
    s.reduced_still_picture_header = r.f(1)
    if s.reduced_still_picture_header:
        s.operating_point_idc = [0]
        r.f(5)                              # seq_level_idx[0]
        s.decoder_model_present_for_this_op = [0]
    else:
        timing = r.f(1)
        buffer_delay_len = 0
        if timing:
            r.f(32)
            r.f(32)
            s.equal_picture_interval = r.f(1)
            if s.equal_picture_interval:
                r.uvlc()
            s.decoder_model_info_present = r.f(1)
            if s.decoder_model_info_present:
                buffer_delay_len = r.f(5) + 1
                r.f(32)
                s.buffer_removal_time_length_minus_1 = r.f(5)
                s.frame_presentation_time_length_minus_1 = r.f(5)
        initial_display_delay_present = r.f(1)
        cnt = r.f(5) + 1
        for _ in range(cnt):
            s.operating_point_idc.append(r.f(12))
            level = r.f(5)
            if level > 7:
                r.f(1)
            present = 0
            if s.decoder_model_info_present:
                present = r.f(1)
                if present:
                    r.f(buffer_delay_len)
                    r.f(buffer_delay_len)
                    r.f(1)
            s.decoder_model_present_for_this_op.append(present)
            if initial_display_delay_present:
                if r.f(1):
                    r.f(4)
    s.frame_width_bits_minus_1 = r.f(4)
    s.frame_height_bits_minus_1 = r.f(4)
    s.max_frame_width_minus_1 = r.f(s.frame_width_bits_minus_1 + 1)
    s.max_frame_height_minus_1 = r.f(s.frame_height_bits_minus_1 + 1)
    if not s.reduced_still_picture_header:
        s.frame_id_numbers_present_flag = r.f(1)
    if s.frame_id_numbers_present_flag:
        s.delta_frame_id_length_minus_2 = r.f(4)
        s.additional_frame_id_length_minus_1 = r.f(3)
    s.use_128x128_superblock = r.f(1)
    s.enable_filter_intra = r.f(1)
    s.enable_intra_edge_filter = r.f(1)
    if not s.reduced_still_picture_header:
        r.f(1)                              # enable_interintra_compound
        r.f(1)                              # enable_masked_compound
        s.enable_warped_motion = r.f(1)
        r.f(1)                              # enable_dual_filter
        s.enable_order_hint = r.f(1)
        if s.enable_order_hint:
            r.f(1)                          # enable_jnt_comp
            r.f(1)                          # enable_ref_frame_mvs
        if r.f(1):                          # seq_choose_screen_content_tools
            s.seq_force_screen_content_tools = 2
        else:
            s.seq_force_screen_content_tools = r.f(1)
        if s.seq_force_screen_content_tools > 0:
            if r.f(1):                      # seq_choose_integer_mv
                s.seq_force_integer_mv = 2
            else:
                s.seq_force_integer_mv = r.f(1)
        else:
            s.seq_force_integer_mv = 2
        if s.enable_order_hint:
            s.OrderHintBits = r.f(3) + 1
    s.enable_superres = r.f(1)
    s.enable_cdef = r.f(1)
    s.enable_restoration = r.f(1)
    # color_config
    high = r.f(1)
    if s.seq_profile == 2 and high:
        s.BitDepth = 12 if r.f(1) else 10
    else:
        s.BitDepth = 10 if high else 8
    s.mono_chrome = 0 if s.seq_profile == 1 else r.f(1)
    s.NumPlanes = 1 if s.mono_chrome else 3
    if r.f(1):
        s.color_primaries = r.f(8)
        s.transfer_characteristics = r.f(8)
        s.matrix_coefficients = r.f(8)
    if s.mono_chrome:
        s.color_range = r.f(1)
        s.subsampling_x = s.subsampling_y = 1
        s.separate_uv_delta_q = 0
    elif (s.color_primaries == 1 and s.transfer_characteristics == 13
          and s.matrix_coefficients == 0):
        s.color_range = 1
        s.subsampling_x = s.subsampling_y = 0
        s.separate_uv_delta_q = r.f(1)
    else:
        s.color_range = r.f(1)
        if s.seq_profile == 0:
            s.subsampling_x = s.subsampling_y = 1
        elif s.seq_profile == 1:
            s.subsampling_x = s.subsampling_y = 0
        elif s.BitDepth == 12:
            s.subsampling_x = r.f(1)
            s.subsampling_y = r.f(1) if s.subsampling_x else 0
        else:
            s.subsampling_x, s.subsampling_y = 1, 0
        if s.subsampling_x and s.subsampling_y:
            s.chroma_sample_position = r.f(2)
        s.separate_uv_delta_q = r.f(1)
    s.film_grain_params_present = r.f(1)
    return s


@dataclass
class FilmGrain:
    apply_grain: int = 0
    grain_seed: int = 0
    point_y_value: list = field(default_factory=list)
    point_y_scaling: list = field(default_factory=list)
    chroma_scaling_from_luma: int = 0
    point_cb_value: list = field(default_factory=list)
    point_cb_scaling: list = field(default_factory=list)
    point_cr_value: list = field(default_factory=list)
    point_cr_scaling: list = field(default_factory=list)
    grain_scaling_minus_8: int = 0
    ar_coeff_lag: int = 0
    ar_coeffs_y_plus_128: list = field(default_factory=list)
    ar_coeffs_cb_plus_128: list = field(default_factory=list)
    ar_coeffs_cr_plus_128: list = field(default_factory=list)
    ar_coeff_shift_minus_6: int = 0
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: int = 0
    clip_to_restricted_range: int = 0


@dataclass
class FrameHeader:
    frame_type: int = KEY_FRAME
    show_frame: int = 1
    showable_frame: int = 0
    error_resilient_mode: int = 1
    disable_cdf_update: int = 0
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 1
    frame_size_override_flag: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    FrameWidth: int = 0
    FrameHeight: int = 0
    UpscaledWidth: int = 0
    RenderWidth: int = 0
    RenderHeight: int = 0
    use_superres: int = 0
    SuperresDenom: int = 8
    MiCols: int = 0
    MiRows: int = 0
    allow_intrabc: int = 0
    disable_frame_end_update_cdf: int = 1
    # tile info
    MiColStarts: list = field(default_factory=list)
    MiRowStarts: list = field(default_factory=list)
    TileCols: int = 1
    TileRows: int = 1
    TileColsLog2: int = 0
    TileRowsLog2: int = 0
    context_update_tile_id: int = 0
    TileSizeBytes: int = 4
    # quantization
    base_q_idx: int = 0
    DeltaQYDc: int = 0
    DeltaQUDc: int = 0
    DeltaQUAc: int = 0
    DeltaQVDc: int = 0
    DeltaQVAc: int = 0
    using_qmatrix: int = 0
    qm_y: int = 15
    qm_u: int = 15
    qm_v: int = 15
    # segmentation
    segmentation_enabled: int = 0
    FeatureEnabled: list = field(default_factory=lambda: [[0] * 8
                                                          for _ in range(8)])
    FeatureData: list = field(default_factory=lambda: [[0] * 8
                                                       for _ in range(8)])
    SegIdPreSkip: int = 0
    LastActiveSegId: int = 0
    # deltas
    delta_q_present: int = 0
    delta_q_res: int = 0
    delta_lf_present: int = 0
    delta_lf_res: int = 0
    delta_lf_multi: int = 0
    CodedLossless: int = 0
    AllLossless: int = 0
    LosslessArray: list = field(default_factory=lambda: [0] * 8)
    SegQMLevel: list = field(default_factory=lambda: [[15] * 8
                                                      for _ in range(3)])
    # loop filter
    loop_filter_level: list = field(default_factory=lambda: [0, 0, 0, 0])
    loop_filter_sharpness: int = 0
    loop_filter_delta_enabled: int = 0
    loop_filter_ref_deltas: list = field(
        default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])
    loop_filter_mode_deltas: list = field(default_factory=lambda: [0, 0])
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_pri_strength: list = field(default_factory=lambda: [0])
    cdef_y_sec_strength: list = field(default_factory=lambda: [0])
    cdef_uv_pri_strength: list = field(default_factory=lambda: [0])
    cdef_uv_sec_strength: list = field(default_factory=lambda: [0])
    # loop restoration
    FrameRestorationType: list = field(default_factory=lambda: [0, 0, 0])
    LoopRestorationSize: list = field(default_factory=lambda: [64, 64, 64])
    UsesLr: int = 0
    TxMode: int = TX_MODE_LARGEST
    reduced_tx_set: int = 0
    film_grain: FilmGrain = field(default_factory=FilmGrain)
    header_bytes: int = 0


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _read_delta_q(r: BitReader) -> int:
    return r.su(7) if r.f(1) else 0


def parse_frame_header(data: bytes, seq: SequenceHeader, obu: Obu,
                       trace=None) -> FrameHeader:
    """uncompressed_header() of an intra frame; `header_bytes` is where the
    header ends, after its byte alignment."""
    r = BitReader(data)
    h = FrameHeader()
    if seq.reduced_still_picture_header:
        h.frame_type, h.show_frame, h.showable_frame = KEY_FRAME, 1, 0
    else:
        if r.f(1):
            raise NotImplementedError(
                "AV1: show_existing_frame in the first temporal unit")
        h.frame_type = r.f(2)
        if h.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
            raise NotImplementedError(
                "AV1: an inter frame in the first temporal unit")
        h.show_frame = r.f(1)
        if (h.show_frame and seq.decoder_model_info_present
                and not seq.equal_picture_interval):
            r.f(seq.frame_presentation_time_length_minus_1 + 1)
        if h.show_frame:
            h.showable_frame = int(h.frame_type != KEY_FRAME)
        else:
            h.showable_frame = r.f(1)
        if h.frame_type == KEY_FRAME and h.show_frame:
            h.error_resilient_mode = 1
        else:
            h.error_resilient_mode = r.f(1)
    h.disable_cdf_update = r.f(1)
    if seq.seq_force_screen_content_tools == 2:
        h.allow_screen_content_tools = r.f(1)
    else:
        h.allow_screen_content_tools = seq.seq_force_screen_content_tools
    if h.allow_screen_content_tools and seq.seq_force_integer_mv == 2:
        r.f(1)
    h.force_integer_mv = 1
    if seq.frame_id_numbers_present_flag:
        r.f(seq.additional_frame_id_length_minus_1 +
            seq.delta_frame_id_length_minus_2 + 3)
    if seq.reduced_still_picture_header:
        h.frame_size_override_flag = 0
    else:
        h.frame_size_override_flag = r.f(1)
    r.f(seq.OrderHintBits)
    h.primary_ref_frame = PRIMARY_REF_NONE
    if seq.decoder_model_info_present:
        if r.f(1):                          # buffer_removal_time_present
            for op, idc in enumerate(seq.operating_point_idc):
                if seq.decoder_model_present_for_this_op[op]:
                    in_t = (idc >> obu.temporal_id) & 1
                    in_s = (idc >> (obu.spatial_id + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        r.f(seq.buffer_removal_time_length_minus_1 + 1)
    if h.frame_type == KEY_FRAME and h.show_frame:
        h.refresh_frame_flags = 0xFF
    else:
        h.refresh_frame_flags = r.f(8)
    if h.refresh_frame_flags != 0xFF and h.error_resilient_mode and \
            seq.enable_order_hint:
        for _ in range(8):
            r.f(seq.OrderHintBits)
    # frame_size, superres_params, render_size
    if h.frame_size_override_flag:
        h.FrameWidth = r.f(seq.frame_width_bits_minus_1 + 1) + 1
        h.FrameHeight = r.f(seq.frame_height_bits_minus_1 + 1) + 1
    else:
        h.FrameWidth = seq.max_frame_width_minus_1 + 1
        h.FrameHeight = seq.max_frame_height_minus_1 + 1
    h.use_superres = r.f(1) if seq.enable_superres else 0
    h.SuperresDenom = r.f(3) + 9 if h.use_superres else 8
    h.UpscaledWidth = h.FrameWidth
    h.FrameWidth = (h.UpscaledWidth * 8 + h.SuperresDenom // 2) // \
        h.SuperresDenom
    h.MiCols = 2 * ((h.FrameWidth + 7) >> 3)
    h.MiRows = 2 * ((h.FrameHeight + 7) >> 3)
    if r.f(1):
        h.RenderWidth = r.f(16) + 1
        h.RenderHeight = r.f(16) + 1
    else:
        h.RenderWidth, h.RenderHeight = h.UpscaledWidth, h.FrameHeight
    if h.allow_screen_content_tools and h.UpscaledWidth == h.FrameWidth:
        h.allow_intrabc = r.f(1)
    if seq.reduced_still_picture_header or h.disable_cdf_update:
        h.disable_frame_end_update_cdf = 1
    else:
        h.disable_frame_end_update_cdf = r.f(1)
    _tile_info(r, h, seq)
    # quantization_params
    h.base_q_idx = r.f(8)
    h.DeltaQYDc = _read_delta_q(r)
    if seq.NumPlanes > 1:
        diff_uv = r.f(1) if seq.separate_uv_delta_q else 0
        h.DeltaQUDc = _read_delta_q(r)
        h.DeltaQUAc = _read_delta_q(r)
        if diff_uv:
            h.DeltaQVDc = _read_delta_q(r)
            h.DeltaQVAc = _read_delta_q(r)
        else:
            h.DeltaQVDc, h.DeltaQVAc = h.DeltaQUDc, h.DeltaQUAc
    h.using_qmatrix = r.f(1)
    if h.using_qmatrix:
        h.qm_y = r.f(4)
        h.qm_u = r.f(4)
        h.qm_v = r.f(4) if seq.separate_uv_delta_q else h.qm_u
    # segmentation_params
    h.segmentation_enabled = r.f(1)
    if h.segmentation_enabled:
        for i in range(8):
            for j in range(8):
                if r.f(1):
                    h.FeatureEnabled[i][j] = 1
                    bits = T.Segmentation_Feature_Bits[j]
                    lim = T.Segmentation_Feature_Max[j]
                    if T.Segmentation_Feature_Signed[j]:
                        v = max(-lim, min(lim, r.su(1 + bits)))
                    else:
                        v = max(0, min(lim, r.f(bits)))
                    h.FeatureData[i][j] = v
    for i in range(8):
        for j in range(8):
            if h.FeatureEnabled[i][j]:
                h.LastActiveSegId = i
                if j >= T.SEG_LVL_REF_FRAME:
                    h.SegIdPreSkip = 1
    # delta_q_params, delta_lf_params
    if h.base_q_idx > 0:
        h.delta_q_present = r.f(1)
    if h.delta_q_present:
        h.delta_q_res = r.f(2)
        if not h.allow_intrabc:
            h.delta_lf_present = r.f(1)
        if h.delta_lf_present:
            h.delta_lf_res = r.f(2)
            h.delta_lf_multi = r.f(1)
    h.CodedLossless = 1
    for seg in range(8):
        q = qindex(h, seg, None)
        lossless = (q == 0 and h.DeltaQYDc == 0 and h.DeltaQUAc == 0 and
                    h.DeltaQUDc == 0 and h.DeltaQVAc == 0 and
                    h.DeltaQVDc == 0)
        h.LosslessArray[seg] = int(lossless)
        if not lossless:
            h.CodedLossless = 0
        if h.using_qmatrix:
            if lossless:
                for p in range(3):
                    h.SegQMLevel[p][seg] = 15
            else:
                h.SegQMLevel[0][seg] = h.qm_y
                h.SegQMLevel[1][seg] = h.qm_u
                h.SegQMLevel[2][seg] = h.qm_v
    h.AllLossless = int(h.CodedLossless and h.FrameWidth == h.UpscaledWidth)
    # loop_filter_params
    if not (h.CodedLossless or h.allow_intrabc):
        h.loop_filter_level[0] = r.f(6)
        h.loop_filter_level[1] = r.f(6)
        if seq.NumPlanes > 1 and (h.loop_filter_level[0] or
                                  h.loop_filter_level[1]):
            h.loop_filter_level[2] = r.f(6)
            h.loop_filter_level[3] = r.f(6)
        h.loop_filter_sharpness = r.f(3)
        h.loop_filter_delta_enabled = r.f(1)
        if h.loop_filter_delta_enabled:
            if r.f(1):                      # loop_filter_delta_update
                for i in range(8):
                    if r.f(1):
                        h.loop_filter_ref_deltas[i] = r.su(7)
                for i in range(2):
                    if r.f(1):
                        h.loop_filter_mode_deltas[i] = r.su(7)
    # cdef_params
    if not (h.CodedLossless or h.allow_intrabc or not seq.enable_cdef):
        h.cdef_damping = r.f(2) + 3
        h.cdef_bits = r.f(2)
        h.cdef_y_pri_strength, h.cdef_y_sec_strength = [], []
        h.cdef_uv_pri_strength, h.cdef_uv_sec_strength = [], []
        for _ in range(1 << h.cdef_bits):
            h.cdef_y_pri_strength.append(r.f(4))
            s = r.f(2)
            h.cdef_y_sec_strength.append(4 if s == 3 else s)
            if seq.NumPlanes > 1:
                h.cdef_uv_pri_strength.append(r.f(4))
                s = r.f(2)
                h.cdef_uv_sec_strength.append(4 if s == 3 else s)
            else:
                h.cdef_uv_pri_strength.append(0)
                h.cdef_uv_sec_strength.append(0)
    # lr_params
    if not (h.AllLossless or h.allow_intrabc or not seq.enable_restoration):
        uses_chroma = 0
        for i in range(seq.NumPlanes):
            h.FrameRestorationType[i] = T.Remap_Lr_Type[r.f(2)]
            if h.FrameRestorationType[i] != T.RESTORE_NONE:
                h.UsesLr = 1
                if i > 0:
                    uses_chroma = 1
        if h.UsesLr:
            if seq.use_128x128_superblock:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            size = 256 >> (2 - shift)
            uv_shift = 0
            if seq.subsampling_x and seq.subsampling_y and uses_chroma:
                uv_shift = r.f(1)
            h.LoopRestorationSize = [size, size >> uv_shift,
                                     size >> uv_shift]
    # read_tx_mode
    if h.CodedLossless:
        h.TxMode = ONLY_4X4
    else:
        h.TxMode = TX_MODE_SELECT if r.f(1) else TX_MODE_LARGEST
    h.reduced_tx_set = r.f(1)
    _film_grain_params(r, h, seq)
    r.byte_alignment()
    h.header_bytes = r.pos
    return h


def qindex(h: FrameHeader, seg: int, current) -> int:
    """get_qindex(ignoreDeltaQ = current is None, segmentId)."""
    if h.segmentation_enabled and h.FeatureEnabled[seg][T.SEG_LVL_ALT_Q]:
        data = h.FeatureData[seg][T.SEG_LVL_ALT_Q]
        q = h.base_q_idx + data
        if current is not None and h.delta_q_present:
            q = current + data
        return max(0, min(255, q))
    if current is not None and h.delta_q_present:
        return current
    return h.base_q_idx


def _tile_info(r: BitReader, h: FrameHeader, seq: SequenceHeader):
    big = seq.use_128x128_superblock
    sb_cols = (h.MiCols + 31) >> 5 if big else (h.MiCols + 15) >> 4
    sb_rows = (h.MiRows + 31) >> 5 if big else (h.MiRows + 15) >> 4
    sb_shift = 5 if big else 4
    sb_size = sb_shift + 2
    max_w_sb = 4096 >> sb_size
    max_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_w_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_area_sb,
                                                   sb_rows * sb_cols))
    h.MiColStarts, h.MiRowStarts = [], []
    if r.f(1):                              # uniform_tile_spacing_flag
        h.TileColsLog2 = min_log2_cols
        while h.TileColsLog2 < max_log2_cols:
            if r.f(1):
                h.TileColsLog2 += 1
            else:
                break
        w_sb = (sb_cols + (1 << h.TileColsLog2) - 1) >> h.TileColsLog2
        for start in range(0, sb_cols, w_sb):
            h.MiColStarts.append(start << sb_shift)
        h.MiColStarts.append(h.MiCols)
        h.TileCols = len(h.MiColStarts) - 1
        min_log2_rows = max(min_log2_tiles - h.TileColsLog2, 0)
        h.TileRowsLog2 = min_log2_rows
        while h.TileRowsLog2 < max_log2_rows:
            if r.f(1):
                h.TileRowsLog2 += 1
            else:
                break
        h_sb = (sb_rows + (1 << h.TileRowsLog2) - 1) >> h.TileRowsLog2
        for start in range(0, sb_rows, h_sb):
            h.MiRowStarts.append(start << sb_shift)
        h.MiRowStarts.append(h.MiRows)
        h.TileRows = len(h.MiRowStarts) - 1
    else:
        widest = 0
        start = 0
        while start < sb_cols:
            h.MiColStarts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_w_sb)) + 1
            widest = max(widest, size)
            start += size
        h.MiColStarts.append(h.MiCols)
        h.TileCols = len(h.MiColStarts) - 1
        h.TileColsLog2 = _tile_log2(1, h.TileCols)
        if min_log2_tiles > 0:
            area = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            area = sb_rows * sb_cols
        max_h_sb = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            h.MiRowStarts.append(start << sb_shift)
            size = r.ns(min(sb_rows - start, max_h_sb)) + 1
            start += size
        h.MiRowStarts.append(h.MiRows)
        h.TileRows = len(h.MiRowStarts) - 1
        h.TileRowsLog2 = _tile_log2(1, h.TileRows)
    if h.TileColsLog2 > 0 or h.TileRowsLog2 > 0:
        h.context_update_tile_id = r.f(h.TileRowsLog2 + h.TileColsLog2)
        h.TileSizeBytes = r.f(2) + 1


def _film_grain_params(r: BitReader, h: FrameHeader, seq: SequenceHeader):
    g = h.film_grain
    if not seq.film_grain_params_present or (not h.show_frame and
                                             not h.showable_frame):
        return
    g.apply_grain = r.f(1)
    if not g.apply_grain:
        return
    g.grain_seed = r.f(16)
    # update_grain is 1 on intra frames
    n = r.f(4)
    for _ in range(n):
        g.point_y_value.append(r.f(8))
        g.point_y_scaling.append(r.f(8))
    g.chroma_scaling_from_luma = 0 if seq.mono_chrome else r.f(1)
    if (seq.mono_chrome or g.chroma_scaling_from_luma or
            (seq.subsampling_x == 1 and seq.subsampling_y == 1 and n == 0)):
        pass
    else:
        for _ in range(r.f(4)):
            g.point_cb_value.append(r.f(8))
            g.point_cb_scaling.append(r.f(8))
        for _ in range(r.f(4)):
            g.point_cr_value.append(r.f(8))
            g.point_cr_scaling.append(r.f(8))
    g.grain_scaling_minus_8 = r.f(2)
    g.ar_coeff_lag = r.f(2)
    num_pos_luma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    if g.point_y_value:
        num_pos_chroma = num_pos_luma + 1
        g.ar_coeffs_y_plus_128 = [r.f(8) for _ in range(num_pos_luma)]
    else:
        num_pos_chroma = num_pos_luma
    if g.chroma_scaling_from_luma or g.point_cb_value:
        g.ar_coeffs_cb_plus_128 = [r.f(8) for _ in range(num_pos_chroma)]
    if g.chroma_scaling_from_luma or g.point_cr_value:
        g.ar_coeffs_cr_plus_128 = [r.f(8) for _ in range(num_pos_chroma)]
    g.ar_coeff_shift_minus_6 = r.f(2)
    g.grain_scale_shift = r.f(2)
    if g.point_cb_value:
        g.cb_mult, g.cb_luma_mult, g.cb_offset = r.f(8), r.f(8), r.f(9)
    if g.point_cr_value:
        g.cr_mult, g.cr_luma_mult, g.cr_offset = r.f(8), r.f(8), r.f(9)
    g.overlap_flag = r.f(1)
    g.clip_to_restricted_range = r.f(1)
