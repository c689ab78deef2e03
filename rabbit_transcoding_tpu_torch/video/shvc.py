"""SHVC (scalable HEVC, H.265 Annex F) parameter-set parse.

Capability parity with PccLibShvcParser::getVideoSize (dependencies/
PccLibShvcParser/source/PccShvcParser.cpp:151-210): extract
per-layer (width, height, bitdepth, is444) from an SHVC stream's VPS +
layer SPSs.  An enhancement-layer SPS usually carries NO picture format at
all (MultiLayerExtSpsFlag: sps_ext_or_max_sub_layers_minus1 == 7); the
format lives in the VPS extension's rep_format() table, indexed per layer
(vps_rep_format_idx / update_rep_format_flag) — this is the "SPS-extension
parse" the plain HEVC probe cannot do.

Writer and parser live adjacent (repo invariant: syntax structs keep their
read/write paired so they cannot drift); the writer doubles as the
writer of test vectors, since no SHM binary is at hand.

Exotic branches raise ValueError("... unsupported in probe") rather than
misparse: splitting_flag, additional layer sets, HRD parameter lists.
"""

from __future__ import annotations

import dataclasses
import math

from ..bitstream.bitio import BitReader, BitWriter
from .hevc_probe import _strip_emulation_prevention

HEVC_NAL_VPS = 32
HEVC_NAL_SPS = 33


# ===========================================================================
# Syntax structs (paired write/parse)
# ===========================================================================
@dataclasses.dataclass
class RepFormat:
    """rep_format() — F.7.3.2.1.2."""
    width: int = 0
    height: int = 0
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8

    def write(self, bw: BitWriter) -> None:
        bw.u(16, self.width)
        bw.u(16, self.height)
        bw.u(1, 1)  # chroma_and_bit_depth_vps_present_flag
        bw.u(2, self.chroma_format_idc)
        if self.chroma_format_idc == 3:
            bw.u(1, 0)  # separate_colour_plane_vps_flag
        bw.u(4, self.bit_depth_luma - 8)
        bw.u(4, self.bit_depth_chroma - 8)
        bw.u(1, 0)  # conformance_window_vps_flag

    @classmethod
    def parse(cls, br: BitReader) -> "RepFormat":
        rf = cls()
        rf.width = br.u(16)
        rf.height = br.u(16)
        if br.u(1):  # chroma_and_bit_depth_vps_present_flag
            rf.chroma_format_idc = br.u(2)
            if rf.chroma_format_idc == 3:
                br.u(1)
            rf.bit_depth_luma = br.u(4) + 8
            rf.bit_depth_chroma = br.u(4) + 8
        if br.u(1):  # conformance_window_vps_flag
            br.ue(), br.ue(), br.ue(), br.ue()
        return rf


def _write_ptl(bw: BitWriter, max_sub_layers_minus1: int,
               profile_present: bool = True) -> None:
    """profile_tier_level(profilePresentFlag, n) with no sub-layer info."""
    if profile_present:
        bw.u(8, (1 << 5) | 1)  # space/tier/profile_idc=1 (Main)
        bw.u(32, 1 << 30)      # compatibility flags
        bw.u(32, 0)            # constraint flags (48 bits)
        bw.u(16, 0)
    bw.u(8, 120)           # general_level_idc
    for _ in range(max_sub_layers_minus1):
        bw.u(1, 0)  # sub_layer_profile_present_flag
        bw.u(1, 0)  # sub_layer_level_present_flag
    if max_sub_layers_minus1 > 0:
        for _ in range(8 - max_sub_layers_minus1):
            bw.u(2, 0)


def _skip_ptl(br: BitReader, max_sub_layers_minus1: int,
              profile_present: bool = True) -> None:
    """profile_tier_level(profilePresentFlag, n) — H.265 §7.3.3 (flags
    interleaved per sub-layer)."""
    if profile_present:
        br.u(8)
        br.u(32)
        br.u(32)
        br.u(16)
    br.u(8)  # general_level_idc
    sub_profile, sub_level = [], []
    for _ in range(max_sub_layers_minus1):
        sub_profile.append(bool(br.u(1)))
        sub_level.append(bool(br.u(1)))
    if max_sub_layers_minus1 > 0:
        for _ in range(8 - max_sub_layers_minus1):
            br.u(2)
    for i in range(max_sub_layers_minus1):
        if sub_profile[i]:
            br.u(32), br.u(32), br.u(24)
        if sub_level[i]:
            br.u(8)


@dataclasses.dataclass
class ShvcVps:
    """VPS with the Annex-F extension fields getVideoSize needs.  Models the
    common SHM scalable configuration: one spatial/quality scalability
    dimension, layer i depends on layer i-1, one layer set per prefix."""
    max_layers: int = 2
    max_sub_layers_minus1: int = 0
    rep_formats: list[RepFormat] = dataclasses.field(default_factory=list)
    rep_format_idx: list[int] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    def write(self, bw: BitWriter) -> None:
        n_layers = self.max_layers
        bw.u(4, 0)               # vps_video_parameter_set_id
        bw.u(1, 1)               # vps_base_layer_internal_flag
        bw.u(1, 1)               # vps_base_layer_available_flag
        bw.u(6, n_layers - 1)    # vps_max_layers_minus1
        bw.u(3, self.max_sub_layers_minus1)
        bw.u(1, 1)               # vps_temporal_id_nesting_flag
        bw.u(16, 0xFFFF)
        _write_ptl(bw, self.max_sub_layers_minus1)
        bw.u(1, 0)               # vps_sub_layer_ordering_info_present_flag
        bw.ue(0), bw.ue(0), bw.ue(0)  # dec_pic_buffering/reorder/latency
        bw.u(6, n_layers - 1)    # vps_max_layer_id
        bw.ue(n_layers - 1)      # vps_num_layer_sets_minus1
        for i in range(1, n_layers):
            for j in range(n_layers):  # layer set i = layers {0..i}
                bw.u(1, 1 if j <= i else 0)
        bw.u(1, 0)               # vps_timing_info_present_flag
        bw.u(1, 1)               # vps_extension_flag
        bw.byte_align()          # vps_extension_alignment_bit_equal_to_one
        self._write_extension(bw)
        bw.u(1, 0)               # vps_extension2_flag
        # rbsp trailing
        bw.u(1, 1)
        bw.zero_align()

    def _write_extension(self, bw: BitWriter) -> None:
        n_layers = self.max_layers
        # base-layer-internal PTL: profilePresentFlag == 0 (F.7.3.2.1.1)
        _write_ptl(bw, self.max_sub_layers_minus1, profile_present=False)
        bw.u(1, 0)               # splitting_flag
        for i in range(16):      # scalability_mask: spatial(2) only
            bw.u(1, 1 if i == 2 else 0)
        bw.u(3, 3 - 1)           # dimension_id_len_minus1[0] (3 bits)
        bw.u(1, 0)               # vps_nuh_layer_id_present_flag
        for i in range(1, n_layers):
            bw.u(3, i)           # dimension_id[i][0]
        bw.u(4, 0)               # view_id_len
        for i in range(1, n_layers):
            for j in range(i):   # direct_dependency_flag[i][j]
                bw.u(1, 1 if j == i - 1 else 0)
        bw.u(1, 0)               # vps_sub_layers_max_minus1_present_flag
        bw.u(1, 0)               # max_tid_ref_present_flag
        bw.u(1, 1)               # default_ref_layers_active_flag
        bw.ue(0)                 # vps_num_profile_tier_level_minus1
        # NumLayerSets = n_layers > 1 -> num_add_olss + default idc
        bw.ue(0)                 # num_add_olss
        bw.u(2, 0)               # default_output_layer_idc
        # output layer sets i=1..: nothing to write in this configuration
        # (i <= vps_num_layer_sets_minus1, idc != 2, num_ptl_minus1 == 0,
        #  >1 output layer in every set -> no alt_output_layer_flag)
        bw.ue(len(self.rep_formats) - 1)  # vps_num_rep_formats_minus1
        for rf in self.rep_formats:
            rf.write(bw)
        if len(self.rep_formats) > 1:
            bw.u(1, 1)           # rep_format_idx_present_flag
            nbits = max(1, math.ceil(math.log2(len(self.rep_formats))))
            for i in range(1, n_layers):
                bw.u(nbits, self.rep_format_idx[i])

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, rbsp: bytes) -> "ShvcVps":
        br = BitReader(rbsp)
        vps = cls(rep_formats=[])
        br.u(4)
        base_layer_internal = br.u(1)
        br.u(1)
        vps.max_layers = br.u(6) + 1
        vps.max_sub_layers_minus1 = br.u(3)
        br.u(1)
        br.u(16)
        _skip_ptl(br, vps.max_sub_layers_minus1)
        sub_layer_ordering = br.u(1)
        lo = 0 if sub_layer_ordering else vps.max_sub_layers_minus1
        for _ in range(lo, vps.max_sub_layers_minus1 + 1):
            br.ue(), br.ue(), br.ue()
        vps_max_layer_id = br.u(6)
        num_layer_sets_minus1 = br.ue()
        layer_id_included = [[True] + [False] * vps_max_layer_id]
        for _ in range(1, num_layer_sets_minus1 + 1):
            layer_id_included.append(
                [bool(br.u(1)) for _ in range(vps_max_layer_id + 1)]
            )
        if br.u(1):  # vps_timing_info_present_flag
            br.u(32), br.u(32)
            if br.u(1):  # poc_proportional_to_timing_flag
                br.ue()
            if br.ue() != 0:  # vps_num_hrd_parameters
                raise ValueError("VPS HRD parameters unsupported in probe")
        if not br.u(1):  # vps_extension_flag
            return vps
        br.byte_align()
        vps._parse_extension(
            br, bool(base_layer_internal), num_layer_sets_minus1,
            layer_id_included,
        )
        return vps

    def _parse_extension(
        self,
        br: BitReader,
        base_layer_internal: bool,
        num_layer_sets_minus1: int,
        layer_id_included: list[list[bool]],
    ) -> None:
        n_layers = self.max_layers
        if n_layers > 1 and base_layer_internal:
            _skip_ptl(br, self.max_sub_layers_minus1, profile_present=False)
        if br.u(1):  # splitting_flag
            raise ValueError("VPS splitting_flag unsupported in probe")
        masks = [bool(br.u(1)) for _ in range(16)]
        num_scal_types = sum(masks)
        dim_len = [br.u(3) + 1 for _ in range(num_scal_types)]
        nuh_layer_id_present = br.u(1)
        dimension_id = [[0] * num_scal_types for _ in range(n_layers)]
        for i in range(1, n_layers):
            if nuh_layer_id_present:
                br.u(6)  # layer_id_in_nuh[i]
            for j in range(num_scal_types):
                dimension_id[i][j] = br.u(dim_len[j])
        view_id_len = br.u(4)
        if view_id_len > 0:
            # NumViews: count distinct ViewOrderIdx (the 'multiview'
            # scalability dimension, index 1 in the mask)
            view_dim = None
            k = 0
            for t in range(16):
                if masks[t]:
                    if t == 1:
                        view_dim = k
                    k += 1
            views = {0}
            for i in range(1, n_layers):
                views.add(
                    dimension_id[i][view_dim] if view_dim is not None else 0
                )
            for _ in range(len(views)):
                br.u(view_id_len)
        direct_dep = [[False] * n_layers for _ in range(n_layers)]
        for i in range(1, n_layers):
            for j in range(i):
                direct_dep[i][j] = bool(br.u(1))
        # NumIndependentLayers: layers with no direct reference layers
        num_independent = sum(
            1 for i in range(n_layers) if not any(direct_dep[i])
        )
        if num_independent > 1:
            if br.ue() != 0:  # num_add_layer_sets
                raise ValueError(
                    "VPS additional layer sets unsupported in probe"
                )
        if br.u(1):  # vps_sub_layers_max_minus1_present_flag
            for _ in range(n_layers):
                br.u(3)
        if br.u(1):  # max_tid_ref_present_flag
            for i in range(n_layers - 1):
                for j in range(i + 1, n_layers):
                    if direct_dep[j][i]:
                        br.u(3)
        br.u(1)  # default_ref_layers_active_flag
        num_ptl_minus1 = br.ue()
        for i in range(2 if base_layer_internal else 1, num_ptl_minus1 + 1):
            profile_present = bool(br.u(1))
            _skip_ptl(br, self.max_sub_layers_minus1, profile_present)
        num_layer_sets = num_layer_sets_minus1 + 1
        default_output_layer_idc = 0
        num_add_olss = 0
        if num_layer_sets > 1:
            num_add_olss = br.ue()
            default_output_layer_idc = min(br.u(2), 2)
        if num_add_olss != 0:
            raise ValueError("VPS additional OLSs unsupported in probe")
        # output layer sets 1..NumOutputLayerSets-1 (== layer sets here)
        num_output_layers = []
        for i in range(1, num_layer_sets):
            layers_in_set = [
                j for j, inc in enumerate(layer_id_included[i]) if inc
            ]
            if default_output_layer_idc == 2:
                out_flags = [bool(br.u(1)) for _ in layers_in_set]
                n_out = sum(out_flags)
                out_layers = [
                    l for l, f in zip(layers_in_set, out_flags) if f
                ]
            else:
                # idc 0: all layers output; idc 1: highest layer only
                n_out = (
                    len(layers_in_set)
                    if default_output_layer_idc == 0
                    else 1
                )
                out_layers = layers_in_set
            num_output_layers.append(n_out)
            if num_ptl_minus1 > 0:
                nbits = math.ceil(math.log2(num_ptl_minus1 + 1))
                for _ in layers_in_set:  # necessary layers (all, here)
                    br.u(nbits)
            if n_out == 1:
                # alt_output_layer_flag conditions on the highest OUTPUT
                # layer (OlsHighestOutputLayerId), not the highest layer in
                # the set — under idc 2 a lower layer can be the only output
                top = out_layers[-1] if out_layers else layers_in_set[-1]
                if any(direct_dep[top]):
                    br.u(1)  # alt_output_layer_flag
        num_rep = br.ue() + 1
        self.rep_formats = [RepFormat.parse(br) for _ in range(num_rep)]
        self.rep_format_idx = [0] * n_layers
        if num_rep > 1:
            if br.u(1):  # rep_format_idx_present_flag
                nbits = max(1, math.ceil(math.log2(num_rep)))
                for i in range(1, n_layers):
                    self.rep_format_idx[i] = br.u(nbits)
            else:
                for i in range(1, n_layers):
                    self.rep_format_idx[i] = min(i, num_rep - 1)
        # (fields after this point are irrelevant to getVideoSize parity)

    # ------------------------------------------------------------------
    def layer_format(self, layer: int) -> RepFormat:
        idx = self.rep_format_idx[layer] if layer < len(
            self.rep_format_idx
        ) else 0
        return self.rep_formats[min(idx, len(self.rep_formats) - 1)]


# ===========================================================================
# SPS with the multilayer-extension short form (F.7.3.2.2.1)
# ===========================================================================
def write_multilayer_sps(
    bw: BitWriter,
    rep_format_idx: int | None = None,
) -> None:
    """Enhancement-layer SPS: sps_ext_or_max_sub_layers_minus1 == 7, so no
    PTL and no picture format fields — the VPS rep_format governs."""
    bw.u(4, 0)  # sps_video_parameter_set_id
    bw.u(3, 7)  # sps_ext_or_max_sub_layers_minus1 -> MultiLayerExtSpsFlag
    bw.ue(0)    # sps_seq_parameter_set_id
    if rep_format_idx is None:
        bw.u(1, 0)  # update_rep_format_flag
    else:
        bw.u(1, 1)
        bw.u(8, rep_format_idx)
    # (remaining SPS fields omitted: the probe stops at the format)
    bw.u(1, 1)
    bw.zero_align()


def parse_sps_multilayer(rbsp: bytes, layer_id: int, vps: ShvcVps | None,
                         layer: int) -> dict:
    """SPS of any layer -> format dict, resolving MultiLayerExtSps through
    the VPS rep_format table (TDecCavlc inferSPS analog,
    PccShvcParser.cpp:178-188)."""
    br = BitReader(rbsp)
    br.u(4)  # sps_video_parameter_set_id
    ext_or_max = br.u(3)
    multilayer_ext = layer_id != 0 and ext_or_max == 7
    if not multilayer_ext:
        # plain SPS: delegate to the standard probe field order
        from .hevc_probe import parse_sps

        return parse_sps(rbsp)
    br.ue()  # sps_seq_parameter_set_id
    rep_idx = None
    if br.u(1):  # update_rep_format_flag
        rep_idx = br.u(8)
    if vps is None:
        raise ValueError("multilayer SPS requires the stream's VPS")
    rf = (
        vps.rep_formats[min(rep_idx, len(vps.rep_formats) - 1)]
        if rep_idx is not None
        else vps.layer_format(layer)
    )
    return {
        "width": rf.width,
        "height": rf.height,
        "bitdepth": rf.bit_depth_luma,
        "bitdepth_chroma": rf.bit_depth_chroma,
        "chroma_format_idc": rf.chroma_format_idc,
    }


# ===========================================================================
# NAL assembly (writer-side utilities; they write the test vectors)
# ===========================================================================
def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 into 00 00 0[0-3] sequences (H.265 §7.4.2)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def make_nal(nal_type: int, layer_id: int, rbsp: bytes,
             temporal_id: int = 0) -> bytes:
    """2-byte NAL header (type/layer/tid, §7.3.1.2) + escaped payload,
    start-code prefixed."""
    b0 = (nal_type << 1) | (layer_id >> 5)
    b1 = ((layer_id & 0x1F) << 3) | (temporal_id + 1)
    return (
        b"\x00\x00\x00\x01"
        + bytes([b0, b1])
        + insert_emulation_prevention(rbsp)
    )


def write_base_sps(bw: BitWriter, width: int, height: int,
                   bitdepth: int = 8, chroma_format_idc: int = 1) -> None:
    """Base-layer (nuh_layer_id 0) SPS through the bit-depth fields — the
    prefix the probe consumes (§7.3.2.2)."""
    bw.u(4, 0)  # sps_video_parameter_set_id
    bw.u(3, 0)  # sps_max_sub_layers_minus1
    bw.u(1, 1)  # sps_temporal_id_nesting_flag
    _write_ptl(bw, 0)
    bw.ue(0)    # sps_seq_parameter_set_id
    bw.ue(chroma_format_idc)
    if chroma_format_idc == 3:
        bw.u(1, 0)
    bw.ue(width)
    bw.ue(height)
    bw.u(1, 0)  # conformance_window_flag
    bw.ue(bitdepth - 8)
    bw.ue(bitdepth - 8)
    bw.u(1, 1)
    bw.zero_align()


# ===========================================================================
# Stream-level probe (getVideoSize parity)
# ===========================================================================
def probe_shvc_layers(data: bytes) -> dict[int, dict]:
    """Annex-B SHVC stream -> {nuh_layer_id: format dict} for every layer
    with an SPS.  Per-layer width/height/bitdepth/is444, like
    PccShvcParser::getVideoSize."""
    from ..bitstream.video_bitstream import split_annexb

    vps: ShvcVps | None = None
    layers: dict[int, dict] = {}
    # layer order index: position of the layer id among those seen, used
    # for the vps_rep_format_idx default mapping
    seen_layers: list[int] = []
    for nal in split_annexb(data):
        if len(nal) < 3:
            continue
        nal_type = (nal[0] >> 1) & 0x3F
        layer_id = ((nal[0] & 0x01) << 5) | (nal[1] >> 3)
        if layer_id not in seen_layers:
            seen_layers.append(layer_id)
        rbsp = _strip_emulation_prevention(nal[2:])
        if nal_type == HEVC_NAL_VPS:
            vps = ShvcVps.parse(rbsp)
        elif nal_type == HEVC_NAL_SPS and layer_id not in layers:
            info = parse_sps_multilayer(
                rbsp, layer_id, vps, sorted(seen_layers).index(layer_id)
            )
            info["is444"] = info.get("chroma_format_idc", 1) == 3
            layers[layer_id] = info
    return layers
