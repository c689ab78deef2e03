"""Minimal conformant HEVC subset: IDR I-slices of IPCM CTUs.

The reference framework carries real HEVC sub-streams (in-process HM,
PCCHMLibVideoEncoderImpl.cpp:92-193) and parses them with a full NAL
parser (dependencies/PccLibHevcParser).  Without an HEVC binary, the
foreign transcode route (transcoder/foreign.py) could only ever meet mock
store-raw codecs.  This module closes that gap with an
ORIGINAL, spec-derived (ISO/IEC 23008-2) HEVC writer/reader pair for the
smallest conformant subset that carries real pixels:

 * 16x16 CTUs == minimum coding block == PCM block: the coding quadtree
   never splits, so the only context-coded bin per CTU is part_mode
   (PART_2Nx2N), followed by the pcm_flag terminate bin, CABAC flush,
   raw PCM samples, engine re-init, and the end_of_slice terminate bin.
 * 8-bit 4:2:0 or monochrome, one IDR slice per frame, SAO and deblocking
   off (plus pcm_loop_filter_disabled), so reconstruction is EXACTLY the
   PCM samples — lossless, closed-loop trivial.

The bitstream is standard Annex-B: start codes, 2-byte NAL headers,
emulation prevention, VPS/SPS/PPS + IDR_W_RADL slices.  Real HEVC syntax
end-to-end: CABAC-coded slice data, profile_tier_level, ue(v)/se(v)
headers — enough for the foreign route, the SPS probe (hevc_probe.py) and
the SHVC layer filter to be exercised against genuine NAL/slice syntax.
"""

from __future__ import annotations

import numpy as np

from ..core.image import Video
from ..utils.enums import ColorFormat

# NAL unit types (H.265 Table 7-1)
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34

_CTU = 16


# ===========================================================================
# Bit I/O with Exp-Golomb (header-level; CABAC below has its own writer)
# ===========================================================================
class _BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def u(self, n: int, v: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.buf.append(self.acc)
                self.acc = 0
                self.nbits = 0

    def ue(self, v: int) -> None:
        v += 1
        nbits = v.bit_length()
        self.u(2 * nbits - 1, v)

    def se(self, v: int) -> None:
        self.ue(2 * abs(v) - 1 if v > 0 else -2 * v)

    def rbsp_trailing(self) -> None:
        self.u(1, 1)
        while self.nbits:
            self.u(1, 0)

    def byte_align_zero(self) -> None:
        while self.nbits:
            self.u(1, 0)

    def write_bytes(self, data: bytes) -> None:
        assert self.nbits == 0
        self.buf.extend(data)

    def data(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.bit = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
        return ((1 << zeros) | self.u(zeros)) - 1 if zeros else 0

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_align(self) -> None:
        if self.bit:
            self.bit = 0
            self.pos += 1

    def read_bytes(self, n: int) -> bytes:
        assert self.bit == 0
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


# ===========================================================================
# CABAC (9.3): only what the IPCM subset needs — one context (part_mode),
# terminate bins, flush, and re-init after PCM samples.
# ===========================================================================
_LPS_TABLE = [  # Table 9-46 rangeTabLps[pState][qRangeIdx]
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [28, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
]
_TRANS_MPS = [min(i + 1, 62) for i in range(63)] + [63]
_TRANS_LPS = [
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 23, 22, 23, 24, 24, 25, 26, 26, 27,
    27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35,
    35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
]

# renormalisation bit counts indexed by (lps >> 3) (HM sm_aucRenormTable)
_RENORM = [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2] + [1] * 16

# part_mode initValue for I slices (initType 0): 184 (Table 9-15/9-16)
_PART_MODE_INIT = 184


def _ctx_init(init_value: int, qp: int) -> list:
    """[pStateIdx, valMps] per 9.3.2.2."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * min(max(qp, 0), 51)) >> 4) + offset), 126)
    if pre <= 63:
        return [63 - pre, 0]
    return [pre - 64, 1]


class _CabacEncoder:
    """9.3.4 arithmetic encoder, mirroring HM's TEncBinCABAC exactly
    (32-bit low window, 23 spare bits, carry-buffered byte output)."""

    def __init__(self, bw: _BitWriter) -> None:
        self.bw = bw
        self._start()

    def _start(self) -> None:
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.buffered_byte = 0xFF
        self.num_buffered = 0

    def _write_out(self) -> None:
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead >> 8
            self.bw.u(8, (self.buffered_byte + carry) & 0xFF)
            fill = (0xFF + carry) & 0xFF
            while self.num_buffered > 1:
                self.bw.u(8, fill)
                self.num_buffered -= 1
            self.buffered_byte = lead & 0xFF
        else:
            self.num_buffered = 1
            self.buffered_byte = lead & 0xFF

    def _test_and_write(self) -> None:
        if self.bits_left < 12:
            self._write_out()

    def encode_bin(self, ctx: list, bin_val: int) -> None:
        p_state, val_mps = ctx
        lps = _LPS_TABLE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        if bin_val != val_mps:
            num = _RENORM[lps >> 3]
            self.low = (self.low + self.range) << num
            self.range = lps << num
            if p_state == 0:
                ctx[1] = 1 - val_mps
            ctx[0] = _TRANS_LPS[p_state]
            self.bits_left -= num
        else:
            ctx[0] = _TRANS_MPS[p_state]
            if self.range >= 256:
                return
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_and_write()

    def encode_bin_trm(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low = (self.low + self.range) << 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_and_write()

    def finish(self) -> None:
        """HM TEncBinCABAC::finish."""
        if self.low >> (32 - self.bits_left):
            self.bw.u(8, (self.buffered_byte + 1) & 0xFF)
            while self.num_buffered > 1:
                self.bw.u(8, 0x00)
                self.num_buffered -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.bw.u(8, self.buffered_byte)
            while self.num_buffered > 1:
                self.bw.u(8, 0xFF)
                self.num_buffered -= 1
        self.bw.u(24 - self.bits_left, (self.low >> 8) & ((1 << (24 - self.bits_left)) - 1))
        self.num_buffered = 0

    def pcm_align(self) -> None:
        """pcm_flag==1 was just coded: flush the engine, write the stop bit
        and alignment zeros (HM encodePCMAlignBits); caller writes samples
        then calls restart()."""
        self.finish()
        self.bw.u(1, 1)
        self.bw.byte_align_zero()

    def restart(self) -> None:
        self._start()

    def terminate_slice(self) -> None:
        self.finish()
        self.bw.u(1, 1)
        self.bw.byte_align_zero()


class _CabacDecoder:
    """9.3.3 arithmetic decoder, mirroring HM's TDecBinCABAC exactly."""

    def __init__(self, br: _BitReader) -> None:
        self.br = br
        self._start()

    def _read_byte(self) -> int:
        if self.br.pos < len(self.br.data):
            b = self.br.data[self.br.pos]
            self.br.pos += 1
            return b
        return 0

    def _start(self) -> None:
        assert self.br.bit == 0
        self.range = 510
        self.value = (self._read_byte() << 8) | self._read_byte()
        self.bits_needed = -8

    def decode_bin(self, ctx: list) -> int:
        p_state, val_mps = ctx
        lps = _LPS_TABLE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        scaled = self.range << 7
        if self.value < scaled:
            bin_val = val_mps
            ctx[0] = _TRANS_MPS[p_state]
            if scaled >= (256 << 7):
                return bin_val
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._read_byte()
        else:
            num = _RENORM[lps >> 3]
            self.value = (self.value - scaled) << num
            self.range = lps << num
            bin_val = 1 - val_mps
            if p_state == 0:
                ctx[1] = 1 - val_mps
            ctx[0] = _TRANS_LPS[p_state]
            self.bits_needed += num
            if self.bits_needed >= 0:
                self.value += self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        return bin_val

    def decode_bin_trm(self) -> int:
        self.range -= 2
        scaled = self.range << 7
        if self.value >= scaled:
            return 1
        if scaled < (256 << 7):
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._read_byte()
        return 0

    def pcm_align(self) -> None:
        """pcm_flag==1 was just decoded.  HM's decodePCMAlignBits only
        byte-aligns the raw reader — the engine's byte-granular reads mean
        the reader already sits exactly past the encoder's flushed word
        (finish + stop bit + zero pad), i.e. at the first PCM sample."""
        self.br.byte_align()

    def restart(self) -> None:
        self._start()

# ===========================================================================
# NAL plumbing
# ===========================================================================
def _emulation_prevent(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _emulation_strip(data: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 < n and data[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def _nal(nal_type: int, rbsp: bytes, first: bool = False) -> bytes:
    start = b"\x00\x00\x00\x01" if first else b"\x00\x00\x01"
    header = bytes([(nal_type << 1) & 0x7E, 1])  # layer 0, tid+1 = 1
    return start + header + _emulation_prevent(rbsp)


def _split_nals(data: bytes):
    """Annex-B -> [(nal_type, rbsp_bytes_with_header)]."""
    out = []
    i = 0
    n = len(data)
    while i + 3 <= n:
        if data[i:i + 3] == b"\x00\x00\x01":
            start = i + 3
            j = start
            while j + 3 <= n and data[j:j + 3] != b"\x00\x00\x01":
                j += 1
            end = j if j + 3 <= n else n
            # trim the trailing zero of a 4-byte start code that follows
            while end > start and data[end - 1] == 0 and \
                    data[end:end + 3] == b"\x00\x00\x01"[: n - end or 3]:
                if data[end:end + 2] == b"\x00\x01"[:max(0, n - end)]:
                    break
                end -= 1
            nal = data[start:end]
            if len(nal) >= 2:
                out.append(((nal[0] >> 1) & 0x3F, nal))
            i = end
        else:
            i += 1
    return out


def _ptl(bw: _BitWriter) -> None:
    """profile_tier_level(1, 0): Main profile, level 6.2 (covers any
    dimensions this subset emits)."""
    bw.u(2, 0)            # general_profile_space
    bw.u(1, 0)            # general_tier_flag
    bw.u(5, 1)            # general_profile_idc: Main
    for i in range(32):   # compatibility flags: profile 1
        bw.u(1, 1 if i == 1 else 0)
    bw.u(1, 1)            # general_progressive_source_flag
    bw.u(1, 0)            # general_interlaced_source_flag
    bw.u(1, 0)            # general_non_packed_constraint_flag
    bw.u(1, 1)            # general_frame_only_constraint_flag
    bw.u(32, 0)           # reserved 43 bits
    bw.u(11, 0)
    bw.u(1, 0)            # general_inbld / reserved
    bw.u(8, 186)          # general_level_idc: 6.2


def _skip_ptl(br: _BitReader) -> None:
    br.u(2 + 1 + 5)
    br.u(32)
    br.u(4)
    br.u(32)
    br.u(11)
    br.u(1)
    br.u(8)


def _vps_rbsp() -> bytes:
    bw = _BitWriter()
    bw.u(4, 0)   # vps_video_parameter_set_id
    bw.u(1, 1)   # vps_base_layer_internal_flag
    bw.u(1, 1)   # vps_base_layer_available_flag
    bw.u(6, 0)   # vps_max_layers_minus1
    bw.u(3, 0)   # vps_max_sub_layers_minus1
    bw.u(1, 1)   # vps_temporal_id_nesting_flag
    bw.u(16, 0xFFFF)
    _ptl(bw)
    bw.u(1, 1)   # vps_sub_layer_ordering_info_present_flag
    bw.ue(1)     # vps_max_dec_pic_buffering_minus1
    bw.ue(0)     # vps_max_num_reorder_pics
    bw.ue(0)     # vps_max_latency_increase_plus1
    bw.u(6, 0)   # vps_max_layer_id
    bw.ue(0)     # vps_num_layer_sets_minus1
    bw.u(1, 0)   # vps_timing_info_present_flag
    bw.u(1, 0)   # vps_extension_flag
    bw.rbsp_trailing()
    return bw.data()


def _sps_rbsp(width: int, height: int, mono: bool) -> bytes:
    bw = _BitWriter()
    bw.u(4, 0)   # sps_video_parameter_set_id
    bw.u(3, 0)   # sps_max_sub_layers_minus1
    bw.u(1, 1)   # sps_temporal_id_nesting_flag
    _ptl(bw)
    bw.ue(0)     # sps_seq_parameter_set_id
    bw.ue(0 if mono else 1)  # chroma_format_idc
    pw = (width + _CTU - 1) // _CTU * _CTU
    ph = (height + _CTU - 1) // _CTU * _CTU
    bw.ue(pw)
    bw.ue(ph)
    crop_r, crop_b = pw - width, ph - height
    if crop_r or crop_b:
        bw.u(1, 1)  # conformance_window_flag
        sub = 1 if mono else 2
        bw.ue(0)
        bw.ue(crop_r // sub)
        bw.ue(0)
        bw.ue(crop_b // sub)
    else:
        bw.u(1, 0)
    bw.ue(0)     # bit_depth_luma_minus8
    bw.ue(0)     # bit_depth_chroma_minus8
    bw.ue(4)     # log2_max_pic_order_cnt_lsb_minus4
    bw.u(1, 1)   # sps_sub_layer_ordering_info_present_flag
    bw.ue(1)     # sps_max_dec_pic_buffering_minus1
    bw.ue(0)     # sps_max_num_reorder_pics
    bw.ue(0)     # sps_max_latency_increase_plus1
    bw.ue(1)     # log2_min_luma_coding_block_size_minus3 -> 16
    bw.ue(0)     # log2_diff_max_min_luma_coding_block_size -> CTU 16
    bw.ue(0)     # log2_min_luma_transform_block_size_minus2 -> 4
    bw.ue(2)     # log2_diff_max_min_luma_transform_block_size -> 16
    bw.ue(0)     # max_transform_hierarchy_depth_inter
    bw.ue(0)     # max_transform_hierarchy_depth_intra
    bw.u(1, 0)   # scaling_list_enabled_flag
    bw.u(1, 0)   # amp_enabled_flag
    bw.u(1, 0)   # sample_adaptive_offset_enabled_flag
    bw.u(1, 1)   # pcm_enabled_flag
    bw.u(4, 7)   # pcm_sample_bit_depth_luma_minus1
    bw.u(4, 7)   # pcm_sample_bit_depth_chroma_minus1
    bw.ue(1)     # log2_min_pcm_luma_coding_block_size_minus3 -> 16
    bw.ue(0)     # log2_diff_max_min_pcm_luma_coding_block_size
    bw.u(1, 1)   # pcm_loop_filter_disabled_flag
    bw.ue(0)     # num_short_term_ref_pic_sets
    bw.u(1, 0)   # long_term_ref_pics_present_flag
    bw.u(1, 0)   # sps_temporal_mvp_enabled_flag
    bw.u(1, 0)   # strong_intra_smoothing_enabled_flag
    bw.u(1, 0)   # vui_parameters_present_flag
    bw.u(1, 0)   # sps_extension_present_flag
    bw.rbsp_trailing()
    return bw.data()


def _parse_sps(rbsp: bytes) -> dict:
    br = _BitReader(rbsp[2:])  # skip NAL header
    br.u(4 + 3 + 1)
    _skip_ptl(br)
    br.ue()                       # sps id
    chroma = br.ue()
    pw = br.ue()
    ph = br.ue()
    crop_r = crop_b = 0
    if br.u(1):
        sub = 1 if chroma == 0 else 2
        br.ue()
        crop_r = br.ue() * sub
        br.ue()
        crop_b = br.ue() * sub
    br.ue()                       # bit_depth_luma_minus8
    br.ue()                       # bit_depth_chroma_minus8
    br.ue()                       # log2_max_poc_lsb
    if br.u(1):
        br.ue(); br.ue(); br.ue()
    br.ue(); br.ue(); br.ue(); br.ue(); br.ue(); br.ue()
    br.u(1)                       # scaling list
    br.u(1)                       # amp
    br.u(1)                       # sao
    pcm = br.u(1)
    if not pcm:
        raise ValueError("not an IPCM-subset stream (pcm disabled)")
    br.u(8)                       # pcm bit depths
    br.ue(); br.ue()
    br.u(1)                       # pcm_loop_filter_disabled
    return {
        "width": pw - crop_r, "height": ph - crop_b,
        "padded_width": pw, "padded_height": ph, "mono": chroma == 0,
    }


def _pps_rbsp() -> bytes:
    bw = _BitWriter()
    bw.ue(0)     # pps_pic_parameter_set_id
    bw.ue(0)     # pps_seq_parameter_set_id
    bw.u(1, 0)   # dependent_slice_segments_enabled_flag
    bw.u(1, 0)   # output_flag_present_flag
    bw.u(3, 0)   # num_extra_slice_header_bits
    bw.u(1, 0)   # sign_data_hiding_enabled_flag
    bw.u(1, 0)   # cabac_init_present_flag
    bw.ue(0)     # num_ref_idx_l0_default_active_minus1
    bw.ue(0)     # num_ref_idx_l1_default_active_minus1
    bw.se(0)     # init_qp_minus26
    bw.u(1, 0)   # constrained_intra_pred_flag
    bw.u(1, 0)   # transform_skip_enabled_flag
    bw.u(1, 0)   # cu_qp_delta_enabled_flag
    bw.se(0)     # pps_cb_qp_offset
    bw.se(0)     # pps_cr_qp_offset
    bw.u(1, 0)   # pps_slice_chroma_qp_offsets_present_flag
    bw.u(1, 0)   # weighted_pred_flag
    bw.u(1, 0)   # weighted_bipred_flag
    bw.u(1, 0)   # transquant_bypass_enabled_flag
    bw.u(1, 0)   # tiles_enabled_flag
    bw.u(1, 0)   # entropy_coding_sync_enabled_flag
    bw.u(1, 1)   # pps_loop_filter_across_slices_enabled_flag
    bw.u(1, 1)   # deblocking_filter_control_present_flag
    bw.u(1, 0)   # deblocking_filter_override_enabled_flag
    bw.u(1, 1)   # pps_deblocking_filter_disabled_flag
    bw.u(1, 0)   # pps_scaling_list_data_present_flag
    bw.u(1, 0)   # lists_modification_present_flag
    bw.ue(0)     # log2_parallel_merge_level_minus2
    bw.u(1, 0)   # slice_segment_header_extension_present_flag
    bw.u(1, 0)   # pps_extension_present_flag
    bw.rbsp_trailing()
    return bw.data()


# ===========================================================================
# Slice coding
# ===========================================================================
def _encode_slice(y: np.ndarray, cb, cr) -> bytes:
    """One IDR I-slice of IPCM CTUs.  y is the CTU-padded luma plane."""
    ph, pw = y.shape
    bw = _BitWriter()
    bw.u(1, 1)   # first_slice_segment_in_pic_flag
    bw.u(1, 0)   # no_output_of_prior_pics_flag
    bw.ue(0)     # slice_pic_parameter_set_id
    bw.ue(2)     # slice_type: I
    bw.se(0)     # slice_qp_delta
    bw.u(1, 1)   # byte_alignment: alignment bit
    bw.byte_align_zero()
    enc = _CabacEncoder(bw)
    part_ctx = _ctx_init(_PART_MODE_INIT, 26)
    n_ctu_y, n_ctu_x = ph // _CTU, pw // _CTU
    last = n_ctu_y * n_ctu_x - 1
    for ci in range(n_ctu_y * n_ctu_x):
        cy, cx = divmod(ci, n_ctu_x)
        # coding_unit(16x16): part_mode (PART_2Nx2N) then pcm_flag
        enc.encode_bin(part_ctx, 1)
        enc.encode_bin_trm(1)  # pcm_flag
        enc.pcm_align()
        blk = y[cy * _CTU:(cy + 1) * _CTU, cx * _CTU:(cx + 1) * _CTU]
        bw.write_bytes(blk.astype(np.uint8).tobytes())
        if cb is not None:
            half = _CTU // 2
            bw.write_bytes(
                cb[cy * half:(cy + 1) * half,
                   cx * half:(cx + 1) * half].astype(np.uint8).tobytes()
            )
            bw.write_bytes(
                cr[cy * half:(cy + 1) * half,
                   cx * half:(cx + 1) * half].astype(np.uint8).tobytes()
            )
        enc.restart()
        enc.encode_bin_trm(1 if ci == last else 0)
        if ci == last:
            enc.terminate_slice()
    return bw.data()


def _decode_slice(rbsp: bytes, pw: int, ph: int, mono: bool):
    br = _BitReader(rbsp[2:])
    br.u(1)      # first_slice_segment_in_pic_flag
    br.u(1)      # no_output_of_prior_pics_flag
    br.ue()      # slice_pic_parameter_set_id
    st = br.ue()
    if st != 2:
        raise ValueError(f"IPCM subset expects I slices, got type {st}")
    br.se()      # slice_qp_delta
    if br.u(1) != 1:
        raise ValueError("bad slice header alignment bit")
    br.byte_align()
    dec = _CabacDecoder(br)
    part_ctx = _ctx_init(_PART_MODE_INIT, 26)
    y = np.zeros((ph, pw), np.uint8)
    half = _CTU // 2
    cb = cr = None
    if not mono:
        cb = np.zeros((ph // 2, pw // 2), np.uint8)
        cr = np.zeros((ph // 2, pw // 2), np.uint8)
    n_ctu_y, n_ctu_x = ph // _CTU, pw // _CTU
    for ci in range(n_ctu_y * n_ctu_x):
        cy, cx = divmod(ci, n_ctu_x)
        if dec.decode_bin(part_ctx) != 1:
            raise ValueError("IPCM subset: unexpected part_mode NxN")
        if dec.decode_bin_trm() != 1:
            raise ValueError("IPCM subset: pcm_flag expected")
        dec.pcm_align()
        blk = np.frombuffer(br.read_bytes(_CTU * _CTU), np.uint8)
        y[cy * _CTU:(cy + 1) * _CTU, cx * _CTU:(cx + 1) * _CTU] = \
            blk.reshape(_CTU, _CTU)
        if not mono:
            cblk = np.frombuffer(br.read_bytes(half * half), np.uint8)
            cb[cy * half:(cy + 1) * half, cx * half:(cx + 1) * half] = \
                cblk.reshape(half, half)
            rblk = np.frombuffer(br.read_bytes(half * half), np.uint8)
            cr[cy * half:(cy + 1) * half, cx * half:(cx + 1) * half] = \
                rblk.reshape(half, half)
        dec.restart()
        end = dec.decode_bin_trm()
        if end != (1 if ci == n_ctu_y * n_ctu_x - 1 else 0):
            raise ValueError("IPCM subset: end_of_slice desync")
    return y, cb, cr


# ===========================================================================
# Public API
# ===========================================================================
def encode(video: Video) -> bytes:
    """Video (8-bit, YUV420 or YUV400) -> conformant Annex-B HEVC (IPCM)."""
    if video.bitdepth != 8:
        raise ValueError("HEVC IPCM subset carries 8-bit samples")
    mono = video.format == ColorFormat.YUV400
    if not mono and video.format != ColorFormat.YUV420:
        raise ValueError("HEVC IPCM subset: YUV400 or YUV420 only")
    w, h = video.width, video.height
    pw = (w + _CTU - 1) // _CTU * _CTU
    ph = (h + _CTU - 1) // _CTU * _CTU
    out = bytearray()
    out += _nal(NAL_VPS, _vps_rbsp(), first=True)
    out += _nal(NAL_SPS, _sps_rbsp(w, h, mono))
    out += _nal(NAL_PPS, _pps_rbsp())
    ylist = video.planes[0]
    for fi in range(video.frame_count):
        y = np.asarray(ylist[fi], np.uint8)
        y = np.pad(y, ((0, ph - h), (0, pw - w)), mode="edge")
        cbp = crp = None
        if not mono:
            cbp = np.pad(
                np.asarray(video.planes[1][fi], np.uint8),
                ((0, (ph - h) // 2), (0, (pw - w) // 2)), mode="edge",
            )
            crp = np.pad(
                np.asarray(video.planes[2][fi], np.uint8),
                ((0, (ph - h) // 2), (0, (pw - w) // 2)), mode="edge",
            )
        out += _nal(NAL_IDR_W_RADL, _encode_slice(y, cbp, crp))
    return bytes(out)


def decode(data: bytes) -> Video:
    """Annex-B HEVC (IPCM subset) -> Video.  Raises on anything outside
    the subset — callers fall back to external binaries / passthrough."""
    sps = None
    frames_y, frames_cb, frames_cr = [], [], []
    for nal_type, nal in _split_nals(data):
        rbsp = _emulation_strip(nal)
        if nal_type == NAL_SPS:
            sps = _parse_sps(rbsp)
        elif nal_type in (NAL_IDR_W_RADL, 20, 21):
            if sps is None:
                raise ValueError("slice before SPS")
            y, cb, cr = _decode_slice(
                rbsp, sps["padded_width"], sps["padded_height"], sps["mono"]
            )
            frames_y.append(y[:sps["height"], :sps["width"]])
            if cb is not None:
                frames_cb.append(cb[:sps["height"] // 2, :sps["width"] // 2])
                frames_cr.append(cr[:sps["height"] // 2, :sps["width"] // 2])
        elif nal_type in (NAL_VPS, NAL_PPS, 35, 39, 40):
            continue  # VPS/PPS/AUD/SEI: fixed layout in this subset
        elif nal_type < 32:
            raise ValueError(
                f"IPCM subset cannot decode slice NAL type {nal_type}"
            )
    if sps is None or not frames_y:
        raise ValueError("no decodable IPCM frames")
    planes = [np.stack(frames_y)]
    fmt = ColorFormat.YUV400
    if frames_cb:
        planes += [np.stack(frames_cb), np.stack(frames_cr)]
        fmt = ColorFormat.YUV420
    return Video(sps["width"], sps["height"], 8, fmt, planes)


def is_ipcm_subset(data: bytes) -> bool:
    """Cheap membership check: Annex-B HEVC whose SPS enables PCM at the
    16x16 no-split geometry this module writes, with only IDR slices.
    Used by transcoder/foreign.py to gate the in-tree fallback."""
    try:
        saw_sps = saw_slice = False
        for nal_type, nal in _split_nals(data):
            if nal_type == NAL_SPS:
                _parse_sps(_emulation_strip(nal))
                saw_sps = True
            elif nal_type < 32:
                if nal_type not in (NAL_IDR_W_RADL, 20):
                    return False
                saw_slice = True
        return saw_sps and saw_slice
    except Exception:
        return False
