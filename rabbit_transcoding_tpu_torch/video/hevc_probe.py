"""Minimal HEVC (H.265) bitstream probe.

Capability parity with the role PccLibHevcParser plays in the reference
(SURVEY.md §2.6): probing width/height/bitdepth/chroma out of an HEVC
sub-bitstream so the transcoder/parser can describe foreign V3C streams
(PCCHMAppVideoDecoder.cpp:60-61 uses it the same way).  This parses the SPS
(ITU-T H.265 §7.3.2.2) — only the fields up to the bit depths — after
removing emulation-prevention bytes.
"""

from __future__ import annotations

from ..bitstream.bitio import BitReader
from ..bitstream.video_bitstream import split_annexb

HEVC_NAL_SPS = 33


def _strip_emulation_prevention(data: bytes) -> bytes:
    """Remove 0x03 from 00 00 03 xx sequences (H.265 §7.4.2)."""
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _skip_profile_tier_level(br: BitReader, max_sub_layers_minus1: int) -> None:
    br.u(8)   # general_profile_space/tier/idc
    br.u(32)  # general_profile_compatibility_flags
    br.u(32)  # general constraint flags (48 bits total)
    br.u(16)
    br.u(8)   # general_level_idc
    # H.265 §7.3.3: the profile/level present flags are INTERLEAVED per
    # sub-layer, not grouped (misreading them breaks any SPS with >=2
    # sub-layers, a common HM temporal-layer config)
    sub_profile, sub_level = [], []
    for _ in range(max_sub_layers_minus1):
        sub_profile.append(bool(br.u(1)))
        sub_level.append(bool(br.u(1)))
    if max_sub_layers_minus1 > 0:
        for _ in range(8 - max_sub_layers_minus1):
            br.u(2)  # reserved
    for i in range(max_sub_layers_minus1):
        if sub_profile[i]:
            br.u(32)
            br.u(32)
            br.u(24)  # 88 bits
        if sub_level[i]:
            br.u(8)


def parse_sps(rbsp: bytes) -> dict:
    """SPS RBSP (emulation prevention already removed) -> stream params."""
    br = BitReader(rbsp)
    br.u(4)  # sps_video_parameter_set_id
    max_sub_layers_minus1 = br.u(3)
    br.u(1)  # sps_temporal_id_nesting_flag
    _skip_profile_tier_level(br, max_sub_layers_minus1)
    br.ue()  # sps_seq_parameter_set_id
    chroma_format_idc = br.ue()
    if chroma_format_idc == 3:
        br.u(1)  # separate_colour_plane_flag
    width = br.ue()
    height = br.ue()
    if br.u(1):  # conformance_window_flag
        left, right, top, bottom = br.ue(), br.ue(), br.ue(), br.ue()
        sub_w = 2 if chroma_format_idc in (1, 2) else 1
        sub_h = 2 if chroma_format_idc == 1 else 1
        width -= (left + right) * sub_w
        height -= (top + bottom) * sub_h
    bit_depth_luma = br.ue() + 8
    bit_depth_chroma = br.ue() + 8
    return {
        "width": width,
        "height": height,
        "bitdepth": bit_depth_luma,
        "bitdepth_chroma": bit_depth_chroma,
        "chroma_format_idc": chroma_format_idc,
    }


# --- AVC (H.264) probe ------------------------------------------------------
AVC_NAL_SPS = 7

_AVC_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139,
                      134, 135}


def parse_avc_sps(rbsp: bytes) -> dict:
    """AVC SPS (H.264 §7.3.2.1.1) -> stream params (frame-coded streams)."""
    br = BitReader(rbsp)
    profile_idc = br.u(8)
    br.u(8)   # constraint flags + reserved
    br.u(8)   # level_idc
    br.ue()   # seq_parameter_set_id
    chroma_format_idc = 1
    bit_depth_luma = 8
    if profile_idc in _AVC_HIGH_PROFILES:
        chroma_format_idc = br.ue()
        if chroma_format_idc == 3:
            br.u(1)  # separate_colour_plane_flag
        bit_depth_luma = br.ue() + 8
        br.ue()      # bit_depth_chroma_minus8
        br.u(1)      # qpprime_y_zero_transform_bypass_flag
        if br.u(1):  # seq_scaling_matrix_present_flag
            raise ValueError("scaling matrices unsupported in probe")
    br.ue()  # log2_max_frame_num_minus4
    pic_order_cnt_type = br.ue()
    if pic_order_cnt_type == 0:
        br.ue()
    elif pic_order_cnt_type == 1:
        br.u(1)
        br.se()
        br.se()
        for _ in range(br.ue()):
            br.se()
    br.ue()  # max_num_ref_frames
    br.u(1)  # gaps_in_frame_num_value_allowed_flag
    width_mbs = br.ue() + 1
    height_units = br.ue() + 1
    frame_mbs_only = br.u(1)
    width = width_mbs * 16
    height = height_units * 16 * (1 if frame_mbs_only else 2)
    return {
        "width": width,
        "height": height,
        "bitdepth": bit_depth_luma,
        "chroma_format_idc": chroma_format_idc,
    }


def probe_avc(data: bytes) -> dict | None:
    """Annex-B AVC elementary stream -> params from the first SPS, or None."""
    for nal in split_annexb(data):
        if len(nal) < 2:
            continue
        if (nal[0] & 0x1F) == AVC_NAL_SPS:
            rbsp = _strip_emulation_prevention(nal[1:])
            try:
                return parse_avc_sps(rbsp)
            except (EOFError, ValueError):
                return None
    return None


def probe_hevc(data: bytes) -> dict | None:
    """Annex-B HEVC elementary stream -> params from the first SPS, or None."""
    for nal in split_annexb(data):
        if len(nal) < 3:
            continue
        nal_type = (nal[0] >> 1) & 0x3F
        if nal_type == HEVC_NAL_SPS:
            rbsp = _strip_emulation_prevention(nal[2:])
            try:
                return parse_sps(rbsp)
            except (EOFError, ValueError):
                return None
    return None


# ---------------------------------------------------------------------------
# SHVC (scalable HEVC) layer handling
# ---------------------------------------------------------------------------
def hevc_layer_ids(data: bytes) -> set[int]:
    """All nuh_layer_id values present in an Annex-B HEVC stream (H.265
    §7.3.1.2: 6 bits straddling the two NAL header bytes).  An SHVC stream
    carries >1 layer; a plain HEVC stream only layer 0."""
    layers: set[int] = set()
    for nal in split_annexb(data):
        if len(nal) < 2:
            continue
        layers.add(((nal[0] & 0x01) << 5) | (nal[1] >> 3))
    return layers


def filter_hevc_layers(data: bytes, max_layer_id: int) -> bytes:
    """Drop NAL units with nuh_layer_id > max_layer_id (SHVC enhancement-
    layer discard).  This is RABBIT's SHVC spatial-layer transcode: keeping
    only layers <= N yields a conforming lower-resolution sub-bitstream with
    NO pixel re-encode (the role shvcLayerIndex plays in the reference's
    transcoder, SURVEY.md §2.6 PccShvcParser)."""
    out = bytearray()
    for nal in split_annexb(data):
        if len(nal) < 2:
            continue
        layer = ((nal[0] & 0x01) << 5) | (nal[1] >> 3)
        if layer <= max_layer_id:
            out += b"\x00\x00\x00\x01" + nal
    return bytes(out)
