"""V3C / atlas high-level syntax structures (ISO/IEC 23090-5 subset).

Capability parity with PccLibBitstreamCommon's syntax structs (SURVEY.md
§2.2): V3CParameterSet (+ ProfileTierLevel, Occupancy/Geometry/Attribute
information), AtlasSequenceParameterSetRbsp (+ V-PCC extension),
AtlasFrameParameterSetRbsp (+ AtlasFrameTileInformation), AtlasTileLayerRbsp
with the full patch-data-unit family (intra/inter/merge/skip/raw/EOM), and
reference list structs.

Design difference vs the reference: each struct carries its own ``write``/
``read`` (kept adjacent so the two directions cannot drift apart), instead of
separate 3k-LoC reader and writer class hierarchies.  Field names follow the
spec so they can be cross-checked against 23090-5 tables directly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field

from ..utils.enums import AtlasTileType, PatchModeITile, PatchModePTile
from .bitio import BitReader, BitWriter


# ===========================================================================
# Profile / component information
# ===========================================================================
@dataclasses.dataclass
class ProfileToolsetConstraintsInformation:
    """ptc_* — 23090-5 8.3.4.6 (reference PCCBitstreamWriter.cpp:664-682):
    declared tool limits the stream promises to respect;
    Context.check_profile verifies the active parameter sets against them."""

    ptc_one_v3c_frame_only_flag: bool = False
    ptc_eom_constraint_flag: bool = False
    ptc_max_map_count_minus1: int = 15
    ptc_max_atlas_count_minus1: int = 15
    ptc_multiple_map_streams_constraint_flag: bool = False
    ptc_plr_constraint_flag: bool = False
    ptc_attribute_max_dimension_minus1: int = 63
    ptc_attribute_max_dimension_partitions_minus1: int = 63
    ptc_no_eight_orientations_constraint_flag: bool = False
    ptc_no_45degree_projection_patch_constraint_flag: bool = False
    ptc_reserved_constraint_bytes: bytes = b""

    def write(self, bw: BitWriter) -> None:
        bw.u(1, self.ptc_one_v3c_frame_only_flag)
        bw.u(1, self.ptc_eom_constraint_flag)
        bw.u(4, self.ptc_max_map_count_minus1)
        bw.u(4, self.ptc_max_atlas_count_minus1)
        bw.u(1, self.ptc_multiple_map_streams_constraint_flag)
        bw.u(1, self.ptc_plr_constraint_flag)
        bw.u(6, self.ptc_attribute_max_dimension_minus1)
        bw.u(6, self.ptc_attribute_max_dimension_partitions_minus1)
        bw.u(1, self.ptc_no_eight_orientations_constraint_flag)
        bw.u(1, self.ptc_no_45degree_projection_patch_constraint_flag)
        bw.u(6, 0)  # reserved
        bw.u(8, len(self.ptc_reserved_constraint_bytes))
        for b in self.ptc_reserved_constraint_bytes:
            bw.u(8, b)

    @classmethod
    def read(cls, br: BitReader) -> "ProfileToolsetConstraintsInformation":
        s = cls()
        s.ptc_one_v3c_frame_only_flag = bool(br.u(1))
        s.ptc_eom_constraint_flag = bool(br.u(1))
        s.ptc_max_map_count_minus1 = br.u(4)
        s.ptc_max_atlas_count_minus1 = br.u(4)
        s.ptc_multiple_map_streams_constraint_flag = bool(br.u(1))
        s.ptc_plr_constraint_flag = bool(br.u(1))
        s.ptc_attribute_max_dimension_minus1 = br.u(6)
        s.ptc_attribute_max_dimension_partitions_minus1 = br.u(6)
        s.ptc_no_eight_orientations_constraint_flag = bool(br.u(1))
        s.ptc_no_45degree_projection_patch_constraint_flag = bool(br.u(1))
        br.u(6)
        n = br.u(8)
        s.ptc_reserved_constraint_bytes = bytes(br.u(8) for _ in range(n))
        return s


@dataclasses.dataclass
class ProfileTierLevel:
    ptl_tier_flag: bool = False
    ptl_profile_codec_group_idc: int = 0
    ptl_profile_toolset_idc: int = 0
    ptl_profile_reconstruction_idc: int = 0
    ptl_level_idc: int = 30
    ptl_num_sub_profiles: int = 0
    ptl_extended_sub_profile_flag: bool = False
    ptl_sub_profile_idc: list[int] = field(default_factory=list)
    ptl_tool_constraints_present_flag: bool = False
    ptl_toolset_constraints: ProfileToolsetConstraintsInformation | None = None

    def write(self, bw: BitWriter) -> None:
        bw.u(1, self.ptl_tier_flag)
        bw.u(7, self.ptl_profile_codec_group_idc)
        bw.u(8, self.ptl_profile_toolset_idc)
        bw.u(8, self.ptl_profile_reconstruction_idc)
        bw.u(16, 0)  # reserved
        bw.u(16, 0)  # reserved
        bw.u(8, self.ptl_level_idc)
        bw.u(6, self.ptl_num_sub_profiles)
        bw.u(1, self.ptl_extended_sub_profile_flag)
        for idc in self.ptl_sub_profile_idc:
            bw.u(64 if self.ptl_extended_sub_profile_flag else 32, idc)
        has_ptc = (
            self.ptl_tool_constraints_present_flag
            and self.ptl_toolset_constraints is not None
        )
        bw.u(1, has_ptc)
        if has_ptc:
            self.ptl_toolset_constraints.write(bw)

    @classmethod
    def read(cls, br: BitReader) -> "ProfileTierLevel":
        s = cls()
        s.ptl_tier_flag = bool(br.u(1))
        s.ptl_profile_codec_group_idc = br.u(7)
        s.ptl_profile_toolset_idc = br.u(8)
        s.ptl_profile_reconstruction_idc = br.u(8)
        br.u(16)
        br.u(16)
        s.ptl_level_idc = br.u(8)
        s.ptl_num_sub_profiles = br.u(6)
        s.ptl_extended_sub_profile_flag = bool(br.u(1))
        s.ptl_sub_profile_idc = [
            br.u(64 if s.ptl_extended_sub_profile_flag else 32)
            for _ in range(s.ptl_num_sub_profiles)
        ]
        s.ptl_tool_constraints_present_flag = bool(br.u(1))
        if s.ptl_tool_constraints_present_flag:
            s.ptl_toolset_constraints = (
                ProfileToolsetConstraintsInformation.read(br)
            )
        return s


@dataclasses.dataclass
class OccupancyInformation:
    oi_occupancy_codec_id: int = 0
    oi_lossy_occupancy_compression_threshold: int = 0
    oi_occupancy_2d_bitdepth_minus1: int = 7
    oi_occupancy_msb_align_flag: bool = False

    def write(self, bw: BitWriter) -> None:
        bw.u(8, self.oi_occupancy_codec_id)
        bw.u(8, self.oi_lossy_occupancy_compression_threshold)
        bw.u(5, self.oi_occupancy_2d_bitdepth_minus1)
        bw.u(1, self.oi_occupancy_msb_align_flag)

    @classmethod
    def read(cls, br: BitReader) -> "OccupancyInformation":
        s = cls()
        s.oi_occupancy_codec_id = br.u(8)
        s.oi_lossy_occupancy_compression_threshold = br.u(8)
        s.oi_occupancy_2d_bitdepth_minus1 = br.u(5)
        s.oi_occupancy_msb_align_flag = bool(br.u(1))
        return s


@dataclasses.dataclass
class GeometryInformation:
    gi_geometry_codec_id: int = 0
    gi_geometry_2d_bitdepth_minus1: int = 9
    gi_geometry_msb_align_flag: bool = False
    gi_geometry_3d_coordinates_bitdepth_minus1: int = 9
    gi_auxiliary_geometry_codec_id: int = 0

    def write(self, bw: BitWriter, auxiliary_video_present: bool) -> None:
        bw.u(8, self.gi_geometry_codec_id)
        bw.u(5, self.gi_geometry_2d_bitdepth_minus1)
        bw.u(1, self.gi_geometry_msb_align_flag)
        bw.u(5, self.gi_geometry_3d_coordinates_bitdepth_minus1)
        if auxiliary_video_present:
            bw.u(8, self.gi_auxiliary_geometry_codec_id)

    @classmethod
    def read(cls, br: BitReader, auxiliary_video_present: bool) -> "GeometryInformation":
        s = cls()
        s.gi_geometry_codec_id = br.u(8)
        s.gi_geometry_2d_bitdepth_minus1 = br.u(5)
        s.gi_geometry_msb_align_flag = bool(br.u(1))
        s.gi_geometry_3d_coordinates_bitdepth_minus1 = br.u(5)
        if auxiliary_video_present:
            s.gi_auxiliary_geometry_codec_id = br.u(8)
        return s


@dataclasses.dataclass
class AttributeInformation:
    ai_attribute_count: int = 0
    ai_attribute_type_id: list[int] = field(default_factory=list)
    ai_attribute_codec_id: list[int] = field(default_factory=list)
    ai_attribute_dimension_minus1: list[int] = field(default_factory=list)
    # dimension partitioning (23090-5 attribute_information; reference
    # PCCBitstreamReader.cpp:399-412): attribute i splits its dimension+1
    # channels over partitions_minus1+1 AVD sub-streams, each routed by
    # vuh_attribute_partition_index.  Channel counts follow the spec's
    # inference rule (a partition's count is only coded when it is not
    # forced by the remaining channel/partition budget).
    ai_attribute_dimension_partitions_minus1: list[int] = field(
        default_factory=list
    )
    ai_attribute_partition_channels_minus1: list[list[int]] = field(
        default_factory=list
    )
    ai_attribute_2d_bitdepth_minus1: list[int] = field(default_factory=list)
    ai_attribute_msb_align_flag: list[bool] = field(default_factory=list)
    # conditional fields (PCCBitstreamReader.cpp:388-397): the aux codec id
    # codes only when the VPS signals auxiliary video for this atlas, and
    # the absolute-coding persistence flag only with multiple maps
    ai_auxiliary_attribute_codec_id: list[int] = field(default_factory=list)
    ai_attribute_map_absolute_coding_persistence_flag: list[bool] = field(
        default_factory=list
    )

    def _partitions(self, i: int) -> int:
        if i < len(self.ai_attribute_dimension_partitions_minus1):
            return self.ai_attribute_dimension_partitions_minus1[i]
        return 0

    def partition_channel_counts(self, i: int) -> list[int]:
        """Channels per partition of attribute i (1-based counts)."""
        k = self._partitions(i)
        if k == 0:
            return [self.ai_attribute_dimension_minus1[i] + 1]
        return [
            c + 1 for c in self.ai_attribute_partition_channels_minus1[i]
        ]

    def _aux_codec_id(self, i: int) -> int:
        if i < len(self.ai_auxiliary_attribute_codec_id):
            return self.ai_auxiliary_attribute_codec_id[i]
        return self.ai_attribute_codec_id[i]

    def map_absolute_coding_persistence(self, i: int) -> bool:
        if i < len(self.ai_attribute_map_absolute_coding_persistence_flag):
            return self.ai_attribute_map_absolute_coding_persistence_flag[i]
        return True

    def write(
        self, bw: BitWriter, auxiliary_video_present: bool, map_count_minus1: int
    ) -> None:
        bw.u(7, self.ai_attribute_count)
        for i in range(self.ai_attribute_count):
            bw.u(4, self.ai_attribute_type_id[i])
            bw.u(8, self.ai_attribute_codec_id[i])
            if auxiliary_video_present:
                bw.u(8, self._aux_codec_id(i))
            if map_count_minus1 > 0:
                bw.u(1, self.map_absolute_coding_persistence(i))
            bw.u(6, self.ai_attribute_dimension_minus1[i])
            if self.ai_attribute_dimension_minus1[i] > 0:
                k = self._partitions(i)
                bw.u(6, k)
                remaining = self.ai_attribute_dimension_minus1[i]
                channels = (
                    self.ai_attribute_partition_channels_minus1[i]
                    if i < len(self.ai_attribute_partition_channels_minus1)
                    else [0] * (k + 1)
                )
                for j in range(k):
                    if k - j != remaining:
                        bw.ue(channels[j])
                    remaining -= channels[j] + 1
            bw.u(5, self.ai_attribute_2d_bitdepth_minus1[i])
            bw.u(1, self.ai_attribute_msb_align_flag[i])

    @classmethod
    def read(
        cls, br: BitReader, auxiliary_video_present: bool, map_count_minus1: int
    ) -> "AttributeInformation":
        s = cls()
        s.ai_attribute_count = br.u(7)
        for i in range(s.ai_attribute_count):
            s.ai_attribute_type_id.append(br.u(4))
            s.ai_attribute_codec_id.append(br.u(8))
            if auxiliary_video_present:
                s.ai_auxiliary_attribute_codec_id.append(br.u(8))
            else:
                s.ai_auxiliary_attribute_codec_id.append(
                    s.ai_attribute_codec_id[i]
                )
            s.ai_attribute_map_absolute_coding_persistence_flag.append(
                bool(br.u(1)) if map_count_minus1 > 0 else True
            )
            s.ai_attribute_dimension_minus1.append(br.u(6))
            if s.ai_attribute_dimension_minus1[i] > 0:
                k = br.u(6)
                s.ai_attribute_dimension_partitions_minus1.append(k)
                remaining = s.ai_attribute_dimension_minus1[i]
                channels: list[int] = []
                for j in range(k):
                    c = 0 if k - j == remaining else br.ue()
                    channels.append(c)
                    remaining -= c + 1
                channels.append(remaining)
                s.ai_attribute_partition_channels_minus1.append(channels)
            else:
                s.ai_attribute_dimension_partitions_minus1.append(0)
                s.ai_attribute_partition_channels_minus1.append([0])
            s.ai_attribute_2d_bitdepth_minus1.append(br.u(5))
            s.ai_attribute_msb_align_flag.append(bool(br.u(1)))
        return s


# ===========================================================================
# V3C parameter set
# ===========================================================================
@dataclasses.dataclass
class VpsAtlas:
    vps_atlas_id: int = 0
    vps_frame_width: int = 1024
    vps_frame_height: int = 1024
    vps_map_count_minus1: int = 0
    vps_multiple_map_streams_present_flag: bool = False
    vps_map_absolute_coding_enabled_flag: list[bool] = field(default_factory=lambda: [True])
    vps_map_predictor_index_diff: list[int] = field(default_factory=lambda: [0])
    vps_auxiliary_video_present_flag: bool = False
    vps_occupancy_video_present_flag: bool = True
    vps_geometry_video_present_flag: bool = True
    vps_attribute_video_present_flag: bool = True
    occupancy_information: OccupancyInformation = field(default_factory=OccupancyInformation)
    geometry_information: GeometryInformation = field(default_factory=GeometryInformation)
    attribute_information: AttributeInformation = field(default_factory=AttributeInformation)


@dataclasses.dataclass
class V3CParameterSet:
    profile_tier_level: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    vps_v3c_parameter_set_id: int = 0
    vps_atlas_count_minus1: int = 0
    atlases: list[VpsAtlas] = field(default_factory=lambda: [VpsAtlas()])
    vps_extension_present_flag: bool = False

    def atlas(self, i: int = 0) -> VpsAtlas:
        return self.atlases[i]

    def write(self, bw: BitWriter) -> None:
        self.profile_tier_level.write(bw)
        bw.u(4, self.vps_v3c_parameter_set_id)
        bw.u(8, 0)  # vps_reserved_zero_8bits
        bw.u(6, self.vps_atlas_count_minus1)
        for a in self.atlases:
            bw.u(6, a.vps_atlas_id)
            bw.ue(a.vps_frame_width)
            bw.ue(a.vps_frame_height)
            bw.u(4, a.vps_map_count_minus1)
            if a.vps_map_count_minus1 > 0:
                bw.u(1, a.vps_multiple_map_streams_present_flag)
            for m in range(1, a.vps_map_count_minus1 + 1):
                if a.vps_multiple_map_streams_present_flag:
                    bw.u(1, a.vps_map_absolute_coding_enabled_flag[m])
                if not a.vps_map_absolute_coding_enabled_flag[m]:
                    bw.ue(a.vps_map_predictor_index_diff[m])
            bw.u(1, a.vps_auxiliary_video_present_flag)
            bw.u(1, a.vps_occupancy_video_present_flag)
            bw.u(1, a.vps_geometry_video_present_flag)
            bw.u(1, a.vps_attribute_video_present_flag)
            if a.vps_occupancy_video_present_flag:
                a.occupancy_information.write(bw)
            if a.vps_geometry_video_present_flag:
                a.geometry_information.write(bw, a.vps_auxiliary_video_present_flag)
            if a.vps_attribute_video_present_flag:
                a.attribute_information.write(
                    bw,
                    a.vps_auxiliary_video_present_flag,
                    a.vps_map_count_minus1,
                )
        bw.u(1, self.vps_extension_present_flag)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader) -> "V3CParameterSet":
        s = cls(atlases=[])
        s.profile_tier_level = ProfileTierLevel.read(br)
        s.vps_v3c_parameter_set_id = br.u(4)
        br.u(8)
        s.vps_atlas_count_minus1 = br.u(6)
        for _ in range(s.vps_atlas_count_minus1 + 1):
            a = VpsAtlas()
            a.vps_atlas_id = br.u(6)
            a.vps_frame_width = br.ue()
            a.vps_frame_height = br.ue()
            a.vps_map_count_minus1 = br.u(4)
            a.vps_map_absolute_coding_enabled_flag = [True] * (a.vps_map_count_minus1 + 1)
            a.vps_map_predictor_index_diff = [0] * (a.vps_map_count_minus1 + 1)
            if a.vps_map_count_minus1 > 0:
                a.vps_multiple_map_streams_present_flag = bool(br.u(1))
            for m in range(1, a.vps_map_count_minus1 + 1):
                if a.vps_multiple_map_streams_present_flag:
                    a.vps_map_absolute_coding_enabled_flag[m] = bool(br.u(1))
                else:
                    a.vps_map_absolute_coding_enabled_flag[m] = True
                if not a.vps_map_absolute_coding_enabled_flag[m]:
                    a.vps_map_predictor_index_diff[m] = br.ue()
            a.vps_auxiliary_video_present_flag = bool(br.u(1))
            a.vps_occupancy_video_present_flag = bool(br.u(1))
            a.vps_geometry_video_present_flag = bool(br.u(1))
            a.vps_attribute_video_present_flag = bool(br.u(1))
            if a.vps_occupancy_video_present_flag:
                a.occupancy_information = OccupancyInformation.read(br)
            if a.vps_geometry_video_present_flag:
                a.geometry_information = GeometryInformation.read(
                    br, a.vps_auxiliary_video_present_flag
                )
            if a.vps_attribute_video_present_flag:
                a.attribute_information = AttributeInformation.read(
                    br,
                    a.vps_auxiliary_video_present_flag,
                    a.vps_map_count_minus1,
                )
            s.atlases.append(a)
        s.vps_extension_present_flag = bool(br.u(1))
        br.rbsp_trailing()
        return s


# ===========================================================================
# ASPS
# ===========================================================================
@dataclasses.dataclass
class RefListStruct:
    """23090-5 8.3.6.12.  st_ref_atlas_frame_flag is only coded when the
    ASPS enables long-term reference frames (PCCBitstreamReader.cpp:885-916);
    long-term entries themselves are not supported by this framework."""

    num_ref_entries: int = 0
    abs_delta_afoc_st: list[int] = field(default_factory=list)
    straf_entry_sign_flag: list[bool] = field(default_factory=list)

    def write(self, bw: BitWriter, long_term_enabled: bool = False) -> None:
        bw.ue(self.num_ref_entries)
        for i in range(self.num_ref_entries):
            if long_term_enabled:
                bw.u(1, 1)  # st_ref_atlas_frame_flag: short-term only
            bw.ue(self.abs_delta_afoc_st[i])
            if self.abs_delta_afoc_st[i] > 0:
                bw.u(1, self.straf_entry_sign_flag[i])

    @classmethod
    def read(cls, br: BitReader, long_term_enabled: bool = False) -> "RefListStruct":
        s = cls()
        s.num_ref_entries = br.ue()
        for _ in range(s.num_ref_entries):
            st = br.u(1) if long_term_enabled else 1
            assert st == 1, "long-term reference atlas frames not supported"
            d = br.ue()
            s.abs_delta_afoc_st.append(d)
            s.straf_entry_sign_flag.append(bool(br.u(1)) if d > 0 else True)
        return s


@dataclasses.dataclass
class CoordinateSystemParameters:
    """VUI coordinate system (23090-5 G.2 csp_*,
    PCCBitstreamReader.cpp coordinateSystemParameters)."""

    csp_forward_axis: int = 0
    csp_delta_left_axis: int = 0
    csp_forward_sign: int = 0
    csp_left_sign: int = 0
    csp_up_sign: int = 0

    def write(self, bw: BitWriter) -> None:
        bw.u(2, self.csp_forward_axis)
        bw.u(1, self.csp_delta_left_axis)
        bw.u(1, self.csp_forward_sign)
        bw.u(1, self.csp_left_sign)
        bw.u(1, self.csp_up_sign)

    @classmethod
    def read(cls, br: BitReader) -> "CoordinateSystemParameters":
        return cls(
            csp_forward_axis=br.u(2),
            csp_delta_left_axis=br.u(1),
            csp_forward_sign=br.u(1),
            csp_left_sign=br.u(1),
            csp_up_sign=br.u(1),
        )


@dataclasses.dataclass
class HrdSubLayerParameters:
    """G.2.3 sub-layer HRD parameters: cab_cnt+1 entries each."""

    bit_rate_value_minus1: list[int] = field(default_factory=list)
    cab_size_value_minus1: list[int] = field(default_factory=list)
    cbr_flag: list[bool] = field(default_factory=list)

    def write(self, bw: BitWriter) -> None:
        for br_v, cab_v, cbr in zip(
            self.bit_rate_value_minus1, self.cab_size_value_minus1,
            self.cbr_flag,
        ):
            bw.ue(br_v)
            bw.ue(cab_v)
            bw.u(1, cbr)

    @classmethod
    def read(cls, br: BitReader, cab_cnt: int) -> "HrdSubLayerParameters":
        s = cls()
        for _ in range(cab_cnt + 1):
            s.bit_rate_value_minus1.append(br.ue())
            s.cab_size_value_minus1.append(br.ue())
            s.cbr_flag.append(bool(br.u(1)))
        return s


@dataclasses.dataclass
class HrdParameters:
    """G.2.2 HRD parameters — field-faithful to the REFERENCE reader/writer
    (PCCBitstreamReader.cpp hrdParameters), including its quirks: one
    sub-layer (maxNumSubLayersMinus1 fixed 0), and elemental_duration /
    cab_cnt coded as u(1) (the reference reads/writes 1 bit despite the
    spec's ue(v) comment — the refgate oracle is the implementation)."""

    hrd_nal_parameters_present_flag: bool = False
    hrd_acl_parameters_present_flag: bool = False
    hrd_bit_rate_scale: int = 0
    hrd_cab_size_scale: int = 0
    hrd_fixed_atlas_rate_general_flag: bool = False
    hrd_fixed_atlas_rate_within_cas_flag: bool = False
    hrd_elemental_duration_in_tc_minus1: int = 0
    hrd_low_delay_flag: bool = False
    hrd_cab_cnt_minus1: int = 0
    hrd_sub_layer_nal: HrdSubLayerParameters | None = None
    hrd_sub_layer_acl: HrdSubLayerParameters | None = None

    def write(self, bw: BitWriter) -> None:
        bw.u(1, self.hrd_nal_parameters_present_flag)
        bw.u(1, self.hrd_acl_parameters_present_flag)
        if (self.hrd_nal_parameters_present_flag
                or self.hrd_acl_parameters_present_flag):
            bw.u(4, self.hrd_bit_rate_scale)
            bw.u(4, self.hrd_cab_size_scale)
        bw.u(1, self.hrd_fixed_atlas_rate_general_flag)
        if not self.hrd_fixed_atlas_rate_general_flag:
            bw.u(1, self.hrd_fixed_atlas_rate_within_cas_flag)
        if self.hrd_fixed_atlas_rate_within_cas_flag:
            bw.u(1, self.hrd_elemental_duration_in_tc_minus1)
        else:
            bw.u(1, self.hrd_low_delay_flag)
        if not self.hrd_low_delay_flag:
            bw.u(1, self.hrd_cab_cnt_minus1)
        if self.hrd_nal_parameters_present_flag:
            self.hrd_sub_layer_nal.write(bw)
        if self.hrd_acl_parameters_present_flag:
            self.hrd_sub_layer_acl.write(bw)

    @classmethod
    def read(cls, br: BitReader) -> "HrdParameters":
        s = cls()
        s.hrd_nal_parameters_present_flag = bool(br.u(1))
        s.hrd_acl_parameters_present_flag = bool(br.u(1))
        if (s.hrd_nal_parameters_present_flag
                or s.hrd_acl_parameters_present_flag):
            s.hrd_bit_rate_scale = br.u(4)
            s.hrd_cab_size_scale = br.u(4)
        s.hrd_fixed_atlas_rate_general_flag = bool(br.u(1))
        if not s.hrd_fixed_atlas_rate_general_flag:
            s.hrd_fixed_atlas_rate_within_cas_flag = bool(br.u(1))
        if s.hrd_fixed_atlas_rate_within_cas_flag:
            s.hrd_elemental_duration_in_tc_minus1 = br.u(1)
        else:
            s.hrd_low_delay_flag = bool(br.u(1))
        if not s.hrd_low_delay_flag:
            s.hrd_cab_cnt_minus1 = br.u(1)
        if s.hrd_nal_parameters_present_flag:
            s.hrd_sub_layer_nal = HrdSubLayerParameters.read(
                br, s.hrd_cab_cnt_minus1
            )
        if s.hrd_acl_parameters_present_flag:
            s.hrd_sub_layer_acl = HrdSubLayerParameters.read(
                br, s.hrd_cab_cnt_minus1
            )
        return s


@dataclasses.dataclass
class VUIParameters:
    """ASPS VUI (23090-5 G.2 vui_*; PCCBitstreamReader.cpp vuiParameters).
    Parse/serialize round trip so VUI-carrying streams survive transit."""

    vui_timing_info_present_flag: bool = False
    vui_num_units_in_tick: int = 1001
    vui_time_scale: int = 60000
    vui_poc_proportional_to_timing_flag: bool = False
    vui_num_ticks_poc_diff_one_minus1: int = 0
    vui_hrd_parameters_present_flag: bool = False
    hrd_parameters: HrdParameters | None = None
    vui_tile_restrictions_present_flag: bool = False
    vui_fixed_atlas_tile_structure_flag: bool = False
    vui_fixed_video_tile_structure_flag: bool = False
    vui_constrained_tiles_across_v3c_components_idc: int = 0
    vui_max_num_tiles_per_atlas_minus1: int = 0
    vui_coordinate_system_parameters_present_flag: bool = False
    coordinate_system_parameters: CoordinateSystemParameters | None = None
    vui_unit_in_metres_flag: bool = False
    vui_display_box_info_present_flag: bool = False
    vui_display_box_origin: list[int] = field(default_factory=lambda: [0, 0, 0])
    vui_display_box_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    vui_anchor_point_present_flag: bool = False
    vui_anchor_point: list[int] = field(default_factory=lambda: [0, 0, 0])

    def write(self, bw: BitWriter) -> None:
        bw.u(1, self.vui_timing_info_present_flag)
        if self.vui_timing_info_present_flag:
            bw.u(32, self.vui_num_units_in_tick)
            bw.u(32, self.vui_time_scale)
            bw.u(1, self.vui_poc_proportional_to_timing_flag)
            if self.vui_poc_proportional_to_timing_flag:
                bw.ue(self.vui_num_ticks_poc_diff_one_minus1)
            bw.u(1, self.vui_hrd_parameters_present_flag)
            if self.vui_hrd_parameters_present_flag:
                self.hrd_parameters.write(bw)
        bw.u(1, self.vui_tile_restrictions_present_flag)
        if self.vui_tile_restrictions_present_flag:
            bw.u(1, self.vui_fixed_atlas_tile_structure_flag)
            bw.u(1, self.vui_fixed_video_tile_structure_flag)
            bw.ue(self.vui_constrained_tiles_across_v3c_components_idc)
            bw.ue(self.vui_max_num_tiles_per_atlas_minus1)
        bw.u(1, self.vui_coordinate_system_parameters_present_flag)
        if self.vui_coordinate_system_parameters_present_flag:
            self.coordinate_system_parameters.write(bw)
        bw.u(1, self.vui_unit_in_metres_flag)
        bw.u(1, self.vui_display_box_info_present_flag)
        if self.vui_display_box_info_present_flag:
            for d in range(3):
                bw.ue(self.vui_display_box_origin[d])
                bw.ue(self.vui_display_box_size[d])
            bw.u(1, self.vui_anchor_point_present_flag)
            if self.vui_anchor_point_present_flag:
                for d in range(3):
                    bw.ue(self.vui_anchor_point[d])

    @classmethod
    def read(cls, br: BitReader) -> "VUIParameters":
        s = cls()
        s.vui_timing_info_present_flag = bool(br.u(1))
        if s.vui_timing_info_present_flag:
            s.vui_num_units_in_tick = br.u(32)
            s.vui_time_scale = br.u(32)
            s.vui_poc_proportional_to_timing_flag = bool(br.u(1))
            if s.vui_poc_proportional_to_timing_flag:
                s.vui_num_ticks_poc_diff_one_minus1 = br.ue()
            s.vui_hrd_parameters_present_flag = bool(br.u(1))
            if s.vui_hrd_parameters_present_flag:
                s.hrd_parameters = HrdParameters.read(br)
        s.vui_tile_restrictions_present_flag = bool(br.u(1))
        if s.vui_tile_restrictions_present_flag:
            s.vui_fixed_atlas_tile_structure_flag = bool(br.u(1))
            s.vui_fixed_video_tile_structure_flag = bool(br.u(1))
            s.vui_constrained_tiles_across_v3c_components_idc = br.ue()
            s.vui_max_num_tiles_per_atlas_minus1 = br.ue()
        s.vui_coordinate_system_parameters_present_flag = bool(br.u(1))
        if s.vui_coordinate_system_parameters_present_flag:
            s.coordinate_system_parameters = CoordinateSystemParameters.read(
                br
            )
        s.vui_unit_in_metres_flag = bool(br.u(1))
        s.vui_display_box_info_present_flag = bool(br.u(1))
        if s.vui_display_box_info_present_flag:
            s.vui_display_box_origin = []
            s.vui_display_box_size = []
            for _ in range(3):
                s.vui_display_box_origin.append(br.ue())
                s.vui_display_box_size.append(br.ue())
            s.vui_anchor_point_present_flag = bool(br.u(1))
            if s.vui_anchor_point_present_flag:
                s.vui_anchor_point = [br.ue() for _ in range(3)]
        return s


@dataclasses.dataclass
class AtlasSequenceParameterSetRbsp:
    asps_atlas_sequence_parameter_set_id: int = 0
    asps_frame_width: int = 1024
    asps_frame_height: int = 1024
    asps_geometry_3d_bitdepth_minus1: int = 9
    asps_geometry_2d_bitdepth_minus1: int = 9
    asps_log2_max_atlas_frame_order_cnt_lsb_minus4: int = 4
    asps_max_dec_atlas_frame_buffering_minus1: int = 0
    asps_long_term_ref_atlas_frames_flag: bool = False
    ref_list_structs: list[RefListStruct] = field(default_factory=list)
    asps_use_eight_orientations_flag: bool = True
    asps_extended_projection_enabled_flag: bool = False
    asps_max_number_projections_minus1: int = 5
    asps_normal_axis_limits_quantization_enabled_flag: bool = True
    asps_normal_axis_max_delta_value_enabled_flag: bool = False
    asps_patch_precedence_order_flag: bool = False
    asps_log2_patch_packing_block_size: int = 4
    asps_patch_size_quantizer_present_flag: bool = False
    asps_map_count_minus1: int = 0
    asps_pixel_deinterleaving_flag: bool = False
    asps_pixel_deinterleaving_map_flag: list[bool] = field(
        default_factory=list
    )
    asps_raw_patch_enabled_flag: bool = False
    asps_eom_patch_enabled_flag: bool = False
    asps_eom_fix_bit_count_minus1: int = 0
    asps_auxiliary_video_enabled_flag: bool = False
    asps_plr_enabled_flag: bool = False
    # PLR information (23090-5 8.3.6.1.2 plri_*, coded once per map,
    # PCCBitstreamReader.cpp:531-552): number_of_modes_minus1 coded mode
    # descriptors follow the implicit mode 0 (no interpolate / no filling /
    # minD1 0 / neighbor 1 = no extra point); descriptor i defines coded mode
    # value i+1.  This framework reconstructs PLR on map 0 only, and every
    # enabled map shares the descriptor set below (the flat fields);
    # plri_map_enabled_flag records which maps carry PLR data.
    asps_plr_number_of_modes_minus1: int = 1
    plri_map_enabled_flag: list[bool] = dataclasses.field(
        default_factory=lambda: [True])
    plri_interpolate_flag: list = dataclasses.field(
        default_factory=lambda: [False])
    plri_filling_flag: list = dataclasses.field(
        default_factory=lambda: [False])
    plri_minimum_depth: list = dataclasses.field(default_factory=lambda: [1])
    plri_neighbour_minus1: list = dataclasses.field(
        default_factory=lambda: [0])
    plri_block_threshold_per_patch_minus1: int = 8
    asps_vui_parameters_present_flag: bool = False
    vui_parameters: VUIParameters | None = None
    # extension signalling (23090-5: asps_extension_present_flag ->
    # asps_vpcc_extension_present_flag u(1) + asps_extension_7bits u(7),
    # PCCBitstreamReader.cpp:512-524)
    asps_vpcc_extension_present_flag: bool = True
    asps_extension_7bits: int = 0
    asps_vpcc_remove_duplicate_point_enabled_flag: bool = False
    # asps_vpcc_surface_thickness_minus1 is only CODED when pixel
    # deinterleaving or PLR is enabled (PCCBitstreamReader.cpp:2380-2390);
    # otherwise it keeps this default on the decode side.
    asps_vpcc_surface_thickness_minus1: int = 3

    def write(self, bw: BitWriter) -> None:
        bw.ue(self.asps_atlas_sequence_parameter_set_id)
        bw.ue(self.asps_frame_width)
        bw.ue(self.asps_frame_height)
        bw.u(5, self.asps_geometry_3d_bitdepth_minus1)
        bw.u(5, self.asps_geometry_2d_bitdepth_minus1)
        bw.ue(self.asps_log2_max_atlas_frame_order_cnt_lsb_minus4)
        bw.ue(self.asps_max_dec_atlas_frame_buffering_minus1)
        bw.u(1, self.asps_long_term_ref_atlas_frames_flag)
        bw.ue(len(self.ref_list_structs))
        for rls in self.ref_list_structs:
            rls.write(bw, self.asps_long_term_ref_atlas_frames_flag)
        bw.u(1, self.asps_use_eight_orientations_flag)
        bw.u(1, self.asps_extended_projection_enabled_flag)
        if self.asps_extended_projection_enabled_flag:
            bw.ue(self.asps_max_number_projections_minus1)
        bw.u(1, self.asps_normal_axis_limits_quantization_enabled_flag)
        bw.u(1, self.asps_normal_axis_max_delta_value_enabled_flag)
        bw.u(1, self.asps_patch_precedence_order_flag)
        bw.u(3, self.asps_log2_patch_packing_block_size)
        bw.u(1, self.asps_patch_size_quantizer_present_flag)
        bw.u(4, self.asps_map_count_minus1)
        bw.u(1, self.asps_pixel_deinterleaving_flag)
        if self.asps_pixel_deinterleaving_flag:
            for m in range(self.asps_map_count_minus1 + 1):
                bw.u(1, self._pixel_deinterleaving_map(m))
        bw.u(1, self.asps_raw_patch_enabled_flag)
        bw.u(1, self.asps_eom_patch_enabled_flag)
        if self.asps_eom_patch_enabled_flag and self.asps_map_count_minus1 == 0:
            bw.u(4, self.asps_eom_fix_bit_count_minus1)
        if self.asps_raw_patch_enabled_flag or self.asps_eom_patch_enabled_flag:
            bw.u(1, self.asps_auxiliary_video_enabled_flag)
        bw.u(1, self.asps_plr_enabled_flag)
        if self.asps_plr_enabled_flag:
            for m in range(self.asps_map_count_minus1 + 1):
                enabled = self.plri_map_enabled(m)
                bw.u(1, enabled)
                if enabled:
                    bw.u(4, self.asps_plr_number_of_modes_minus1)
                    for i in range(self.asps_plr_number_of_modes_minus1):
                        bw.u(1, self.plri_interpolate_flag[i])
                        bw.u(1, self.plri_filling_flag[i])
                        bw.u(2, self.plri_minimum_depth[i])
                        bw.u(2, self.plri_neighbour_minus1[i])
                    bw.u(6, self.plri_block_threshold_per_patch_minus1)
        bw.u(1, self.asps_vui_parameters_present_flag)
        if self.asps_vui_parameters_present_flag:
            self.vui_parameters.write(bw)
        ext_present = (
            self.asps_vpcc_extension_present_flag
            or self.asps_extension_7bits != 0
        )
        bw.u(1, ext_present)
        if ext_present:
            bw.u(1, self.asps_vpcc_extension_present_flag)
            bw.u(7, self.asps_extension_7bits)
        if self.asps_vpcc_extension_present_flag:
            bw.u(1, self.asps_vpcc_remove_duplicate_point_enabled_flag)
            if self.asps_pixel_deinterleaving_flag or self.asps_plr_enabled_flag:
                bw.u(7, self.asps_vpcc_surface_thickness_minus1)
        bw.byte_align()

    def _pixel_deinterleaving_map(self, m: int) -> bool:
        if m < len(self.asps_pixel_deinterleaving_map_flag):
            return bool(self.asps_pixel_deinterleaving_map_flag[m])
        return False

    def plri_map_enabled(self, m: int) -> bool:
        if m < len(self.plri_map_enabled_flag):
            return bool(self.plri_map_enabled_flag[m])
        return True

    @classmethod
    def read(cls, br: BitReader) -> "AtlasSequenceParameterSetRbsp":
        s = cls()
        s.asps_atlas_sequence_parameter_set_id = br.ue()
        s.asps_frame_width = br.ue()
        s.asps_frame_height = br.ue()
        s.asps_geometry_3d_bitdepth_minus1 = br.u(5)
        s.asps_geometry_2d_bitdepth_minus1 = br.u(5)
        s.asps_log2_max_atlas_frame_order_cnt_lsb_minus4 = br.ue()
        s.asps_max_dec_atlas_frame_buffering_minus1 = br.ue()
        s.asps_long_term_ref_atlas_frames_flag = bool(br.u(1))
        nrl = br.ue()
        s.ref_list_structs = [
            RefListStruct.read(br, s.asps_long_term_ref_atlas_frames_flag)
            for _ in range(nrl)
        ]
        s.asps_use_eight_orientations_flag = bool(br.u(1))
        s.asps_extended_projection_enabled_flag = bool(br.u(1))
        if s.asps_extended_projection_enabled_flag:
            s.asps_max_number_projections_minus1 = br.ue()
        s.asps_normal_axis_limits_quantization_enabled_flag = bool(br.u(1))
        s.asps_normal_axis_max_delta_value_enabled_flag = bool(br.u(1))
        s.asps_patch_precedence_order_flag = bool(br.u(1))
        s.asps_log2_patch_packing_block_size = br.u(3)
        s.asps_patch_size_quantizer_present_flag = bool(br.u(1))
        s.asps_map_count_minus1 = br.u(4)
        s.asps_pixel_deinterleaving_flag = bool(br.u(1))
        if s.asps_pixel_deinterleaving_flag:
            s.asps_pixel_deinterleaving_map_flag = [
                bool(br.u(1)) for _ in range(s.asps_map_count_minus1 + 1)
            ]
        s.asps_raw_patch_enabled_flag = bool(br.u(1))
        s.asps_eom_patch_enabled_flag = bool(br.u(1))
        if s.asps_eom_patch_enabled_flag and s.asps_map_count_minus1 == 0:
            s.asps_eom_fix_bit_count_minus1 = br.u(4)
        if s.asps_raw_patch_enabled_flag or s.asps_eom_patch_enabled_flag:
            s.asps_auxiliary_video_enabled_flag = bool(br.u(1))
        s.asps_plr_enabled_flag = bool(br.u(1))
        if s.asps_plr_enabled_flag:
            s.plri_map_enabled_flag = []
            for _ in range(s.asps_map_count_minus1 + 1):
                enabled = bool(br.u(1))
                s.plri_map_enabled_flag.append(enabled)
                if not enabled:
                    continue
                s.asps_plr_number_of_modes_minus1 = br.u(4)
                s.plri_interpolate_flag = []
                s.plri_filling_flag = []
                s.plri_minimum_depth = []
                s.plri_neighbour_minus1 = []
                for _ in range(s.asps_plr_number_of_modes_minus1):
                    s.plri_interpolate_flag.append(bool(br.u(1)))
                    s.plri_filling_flag.append(bool(br.u(1)))
                    s.plri_minimum_depth.append(br.u(2))
                    s.plri_neighbour_minus1.append(br.u(2))
                s.plri_block_threshold_per_patch_minus1 = br.u(6)
        s.asps_vui_parameters_present_flag = bool(br.u(1))
        if s.asps_vui_parameters_present_flag:
            s.vui_parameters = VUIParameters.read(br)
        s.asps_vpcc_extension_present_flag = False
        if br.u(1):  # asps_extension_present_flag
            s.asps_vpcc_extension_present_flag = bool(br.u(1))
            s.asps_extension_7bits = br.u(7)
        if s.asps_vpcc_extension_present_flag:
            s.asps_vpcc_remove_duplicate_point_enabled_flag = bool(br.u(1))
            if s.asps_pixel_deinterleaving_flag or s.asps_plr_enabled_flag:
                s.asps_vpcc_surface_thickness_minus1 = br.u(7)
        br.rbsp_trailing()
        return s


# ===========================================================================
# AFPS + tile information
# ===========================================================================
def _ceil_log2(x: int) -> int:
    """Reference ceilLog2 (PCCBitstreamCommon.h:566): bits to code 0..x-1."""
    return max(0, (x - 1).bit_length()) if x > 0 else 0


def _floor_log2(x: int) -> int:
    return x.bit_length() - 1 if x > 0 else 0


@dataclasses.dataclass
class AtlasFrameTileInformation:
    """afti_* — 23090-5 8.3.6.2.2 (PCCBitstreamReader.cpp:611-707).  The
    partition grid's column/row counts are DERIVED from the ASPS frame size
    in uniform mode; aux-video row fields are coded when the ASPS enables
    auxiliary video, and gate rpdu/epdu_patch_in_auxiliary_video_flag."""

    afti_single_tile_in_atlas_frame_flag: bool = True
    afti_uniform_partition_spacing_flag: bool = True
    afti_partition_cols_width_minus1: int = 0
    afti_partition_rows_height_minus1: int = 0
    afti_num_partition_columns_minus1: int = 0
    afti_num_partition_rows_minus1: int = 0
    afti_partition_column_widths_minus1: list[int] = field(default_factory=list)
    afti_partition_row_heights_minus1: list[int] = field(default_factory=list)
    afti_single_partition_per_tile_flag: bool = True
    afti_num_tiles_in_atlas_frame_minus1: int = 0
    afti_top_left_partition_idx: list[int] = field(default_factory=list)
    afti_bottom_right_partition_column_offset: list[int] = field(default_factory=list)
    afti_bottom_right_partition_row_offset: list[int] = field(default_factory=list)
    # auxiliary-video sub-rows (coded iff asps_auxiliary_video_enabled_flag)
    afti_auxiliary_video_tile_row_width_minus1: int = 0
    afti_auxiliary_video_tile_row_height: list[int] = field(
        default_factory=list
    )
    afti_signalled_tile_id_flag: bool = False
    afti_signalled_tile_id_length_minus1: int = 0
    afti_tile_ids: list[int] = field(default_factory=list)

    def num_tiles(self) -> int:
        return self.afti_num_tiles_in_atlas_frame_minus1 + 1

    def tile_id(self, index: int) -> int:
        if self.afti_signalled_tile_id_flag and index < len(self.afti_tile_ids):
            return self.afti_tile_ids[index]
        return index

    def tile_index_of(self, tile_id: int) -> int:
        """ath_id -> tile index (reference afti.getTileId inverse)."""
        if self.afti_signalled_tile_id_flag and self.afti_tile_ids:
            return self.afti_tile_ids.index(tile_id)
        return tile_id

    def aux_row_height(self, tile_index: int) -> int:
        if tile_index < len(self.afti_auxiliary_video_tile_row_height):
            return self.afti_auxiliary_video_tile_row_height[tile_index]
        return 0

    def ath_id_bits(self) -> int:
        """Bit width of ath_id (PCCBitstreamReader.cpp:795-803)."""
        if self.afti_signalled_tile_id_flag:
            return self.afti_signalled_tile_id_length_minus1 + 1
        if self.afti_num_tiles_in_atlas_frame_minus1 != 0:
            return _ceil_log2(self.afti_num_tiles_in_atlas_frame_minus1 + 1)
        return 0

    def write(self, bw: BitWriter, asps: "AtlasSequenceParameterSetRbsp") -> None:
        bw.u(1, self.afti_single_tile_in_atlas_frame_flag)
        if not self.afti_single_tile_in_atlas_frame_flag:
            bw.u(1, self.afti_uniform_partition_spacing_flag)
            if self.afti_uniform_partition_spacing_flag:
                bw.ue(self.afti_partition_cols_width_minus1)
                bw.ue(self.afti_partition_rows_height_minus1)
            else:
                bw.ue(self.afti_num_partition_columns_minus1)
                bw.ue(self.afti_num_partition_rows_minus1)
                # the LAST partition's size is implicit (frame remainder) —
                # only num_minus1 entries are coded (23090-5 AFTI syntax)
                for w in self.afti_partition_column_widths_minus1[
                    : self.afti_num_partition_columns_minus1
                ]:
                    bw.ue(w)
                for h in self.afti_partition_row_heights_minus1[
                    : self.afti_num_partition_rows_minus1
                ]:
                    bw.ue(h)
            bw.u(1, self.afti_single_partition_per_tile_flag)
            if not self.afti_single_partition_per_tile_flag:
                num_partitions = (
                    self.afti_num_partition_columns_minus1 + 1
                ) * (self.afti_num_partition_rows_minus1 + 1)
                bw.ue(self.afti_num_tiles_in_atlas_frame_minus1)
                bits = _ceil_log2(num_partitions)
                for i in range(self.afti_num_tiles_in_atlas_frame_minus1 + 1):
                    bw.u(bits, self.afti_top_left_partition_idx[i])
                    bw.ue(self.afti_bottom_right_partition_column_offset[i])
                    bw.ue(self.afti_bottom_right_partition_row_offset[i])
        if asps.asps_auxiliary_video_enabled_flag:
            bw.ue(self.afti_auxiliary_video_tile_row_width_minus1)
            for i in range(self.afti_num_tiles_in_atlas_frame_minus1 + 1):
                bw.ue(self.aux_row_height(i))
        bw.u(1, self.afti_signalled_tile_id_flag)
        if self.afti_signalled_tile_id_flag:
            bw.ue(self.afti_signalled_tile_id_length_minus1)
            bits = self.afti_signalled_tile_id_length_minus1 + 1
            for i in range(self.afti_num_tiles_in_atlas_frame_minus1 + 1):
                bw.u(bits, self.afti_tile_ids[i])

    @classmethod
    def read(
        cls, br: BitReader, asps: "AtlasSequenceParameterSetRbsp"
    ) -> "AtlasFrameTileInformation":
        s = cls()
        s.afti_single_tile_in_atlas_frame_flag = bool(br.u(1))
        if not s.afti_single_tile_in_atlas_frame_flag:
            s.afti_uniform_partition_spacing_flag = bool(br.u(1))
            if s.afti_uniform_partition_spacing_flag:
                s.afti_partition_cols_width_minus1 = br.ue()
                s.afti_partition_rows_height_minus1 = br.ue()
                # derived partition grid (PCCBitstreamReader.cpp:619-624)
                w64 = (s.afti_partition_cols_width_minus1 + 1) * 64
                h64 = (s.afti_partition_rows_height_minus1 + 1) * 64
                s.afti_num_partition_columns_minus1 = (
                    (asps.asps_frame_width + w64 - 1) // w64 - 1
                )
                s.afti_num_partition_rows_minus1 = (
                    (asps.asps_frame_height + h64 - 1) // h64 - 1
                )
            else:
                s.afti_num_partition_columns_minus1 = br.ue()
                s.afti_num_partition_rows_minus1 = br.ue()
                s.afti_partition_column_widths_minus1 = [
                    br.ue() for _ in range(s.afti_num_partition_columns_minus1)
                ]
                s.afti_partition_row_heights_minus1 = [
                    br.ue() for _ in range(s.afti_num_partition_rows_minus1)
                ]
            s.afti_single_partition_per_tile_flag = bool(br.u(1))
            num_partitions = (s.afti_num_partition_columns_minus1 + 1) * (
                s.afti_num_partition_rows_minus1 + 1
            )
            if not s.afti_single_partition_per_tile_flag:
                s.afti_num_tiles_in_atlas_frame_minus1 = br.ue()
                bits = _ceil_log2(num_partitions)
                for _ in range(s.afti_num_tiles_in_atlas_frame_minus1 + 1):
                    s.afti_top_left_partition_idx.append(br.u(bits))
                    s.afti_bottom_right_partition_column_offset.append(br.ue())
                    s.afti_bottom_right_partition_row_offset.append(br.ue())
            else:
                s.afti_num_tiles_in_atlas_frame_minus1 = num_partitions - 1
                for i in range(num_partitions):
                    s.afti_top_left_partition_idx.append(i)
                    s.afti_bottom_right_partition_column_offset.append(0)
                    s.afti_bottom_right_partition_row_offset.append(0)
        if asps.asps_auxiliary_video_enabled_flag:
            s.afti_auxiliary_video_tile_row_width_minus1 = br.ue()
            s.afti_auxiliary_video_tile_row_height = [
                br.ue()
                for _ in range(s.afti_num_tiles_in_atlas_frame_minus1 + 1)
            ]
        s.afti_signalled_tile_id_flag = bool(br.u(1))
        if s.afti_signalled_tile_id_flag:
            s.afti_signalled_tile_id_length_minus1 = br.ue()
            bits = s.afti_signalled_tile_id_length_minus1 + 1
            s.afti_tile_ids = [
                br.u(bits)
                for _ in range(s.afti_num_tiles_in_atlas_frame_minus1 + 1)
            ]
        return s


@dataclasses.dataclass
class AtlasFrameParameterSetRbsp:
    afps_atlas_frame_parameter_set_id: int = 0
    afps_atlas_sequence_parameter_set_id: int = 0
    atlas_frame_tile_information: AtlasFrameTileInformation = field(
        default_factory=AtlasFrameTileInformation
    )
    afps_output_flag_present_flag: bool = False
    afps_num_ref_idx_default_active_minus1: int = 0
    afps_additional_lt_afoc_lsb_len: int = 0
    afps_lod_mode_enabled_flag: bool = False
    afps_raw_3d_offset_bit_count_explicit_mode_flag: bool = False
    afps_extension_8bits: int = 0

    def write(
        self, bw: BitWriter, asps: AtlasSequenceParameterSetRbsp
    ) -> None:
        bw.ue(self.afps_atlas_frame_parameter_set_id)
        bw.ue(self.afps_atlas_sequence_parameter_set_id)
        self.atlas_frame_tile_information.write(bw, asps)
        bw.u(1, self.afps_output_flag_present_flag)
        bw.ue(self.afps_num_ref_idx_default_active_minus1)
        bw.ue(self.afps_additional_lt_afoc_lsb_len)
        bw.u(1, self.afps_lod_mode_enabled_flag)
        bw.u(1, self.afps_raw_3d_offset_bit_count_explicit_mode_flag)
        # afps_extension_flag -> afps_extension_8bits
        # (PCCBitstreamReader.cpp:603-609)
        bw.u(1, self.afps_extension_8bits != 0)
        if self.afps_extension_8bits != 0:
            bw.u(8, self.afps_extension_8bits)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader, asps_lookup) -> "AtlasFrameParameterSetRbsp":
        s = cls()
        s.afps_atlas_frame_parameter_set_id = br.ue()
        s.afps_atlas_sequence_parameter_set_id = br.ue()
        asps = asps_lookup(s.afps_atlas_sequence_parameter_set_id)
        s.atlas_frame_tile_information = AtlasFrameTileInformation.read(
            br, asps
        )
        s.afps_output_flag_present_flag = bool(br.u(1))
        s.afps_num_ref_idx_default_active_minus1 = br.ue()
        s.afps_additional_lt_afoc_lsb_len = br.ue()
        s.afps_lod_mode_enabled_flag = bool(br.u(1))
        s.afps_raw_3d_offset_bit_count_explicit_mode_flag = bool(br.u(1))
        if br.u(1):  # afps_extension_flag
            s.afps_extension_8bits = br.u(8)
        br.rbsp_trailing()
        return s


# ===========================================================================
# Patch data units
# ===========================================================================
def _plrd_dims(ctx, size_x_minus1: int, size_y_minus1: int) -> tuple[int, int]:
    """Packing-block grid (bu, bv) of a patch, derived from the coded 2D
    sizes exactly as patch_frame derives size_u0/size_v0."""
    ppbs = ctx.packing_block_size
    bu = ((size_x_minus1 + 1) * ctx.patch_size_x_quantizer + ppbs - 1) // ppbs
    bv = ((size_y_minus1 + 1) * ctx.patch_size_y_quantizer + ppbs - 1) // ppbs
    return max(1, bu), max(1, bv)


def _plrd_blocks(ctx, size_x_minus1: int, size_y_minus1: int) -> int:
    bu, bv = _plrd_dims(ctx, size_x_minus1, size_y_minus1)
    return bu * bv


def _write_plrd(bw, ctx, mode: int, block_modes,
                size_x_minus1: int, size_y_minus1: int) -> None:
    """Point-local-reconstruction data (23090-5 8.3.7.9 plrd).

    plrd_level_flag=0 -> one present flag + mode per packing block of the
    patch (patch-local raster order); =1 -> a single patch-level mode.  The
    level flag is only CODED when the block count exceeds
    plri_block_threshold_per_patch_minus1+1, else inferred patch-level
    (PCCBitstreamReader.cpp:1287-1343).  Mode values code in
    ceilLog2(plri_number_of_modes_minus1) bits."""
    _write_plrd_count(
        bw, ctx, mode, block_modes,
        _plrd_blocks(ctx, size_x_minus1, size_y_minus1),
    )


def _write_plrd_count(bw, ctx, mode: int, block_modes,
                      block_count: int) -> None:
    threshold_gated = block_count > ctx.plr_block_threshold_plus1
    if block_modes is not None:
        assert threshold_gated, (
            "block-level PLR requires blockCount > threshold+1 "
            f"({block_count} <= {ctx.plr_block_threshold_plus1})"
        )
        bw.u(1, 0)  # plrd_level_flag: block level
        assert len(block_modes) == block_count
        for m in block_modes:
            bw.u(1, m > 0)
            if m > 0:
                bw.u(ctx.plr_mode_bits, m - 1)
    else:
        if threshold_gated:
            bw.u(1, 1)  # plrd_level_flag: patch level
        bw.u(1, mode > 0)
        if mode > 0:
            bw.u(ctx.plr_mode_bits, mode - 1)


def _read_plrd(br, ctx, size_x_minus1: int, size_y_minus1: int):
    """-> (patch_mode, block_modes|None)."""
    return _read_plrd_count(
        br, ctx, _plrd_blocks(ctx, size_x_minus1, size_y_minus1)
    )


def _read_plrd_count(br, ctx, block_count: int):
    if block_count > ctx.plr_block_threshold_plus1:
        level = br.u(1)
    else:
        level = 1  # inferred patch-level
    if level == 1:
        mode = br.u(ctx.plr_mode_bits) + 1 if br.u(1) else 0
        return mode, None
    block_modes = []
    for _ in range(block_count):
        block_modes.append(br.u(ctx.plr_mode_bits) + 1 if br.u(1) else 0)
    mode = 1 if any(block_modes) else 0
    return mode, block_modes


@dataclasses.dataclass
class PatchDataUnit:
    """Intra patch (pdu_*, 23090-5 8.3.7.3)."""

    pdu_2d_pos_x: int = 0
    pdu_2d_pos_y: int = 0
    pdu_2d_size_x_minus1: int = 0
    pdu_2d_size_y_minus1: int = 0
    pdu_3d_offset_u: int = 0
    pdu_3d_offset_v: int = 0
    pdu_3d_offset_d: int = 0
    pdu_3d_range_d: int = 0
    pdu_projection_id: int = 0
    pdu_orientation_index: int = 0
    pdu_lod_enabled_flag: bool = False
    pdu_lod_scale_x_minus1: int = 0
    pdu_lod_scale_y_idc: int = 0
    # point-local-reconstruction data (patch level): 0 = none, m>0 = mode m
    plrd_mode: int = 0
    # block-level PLR (plrd_level_flag=0): one mode per packing block of the
    # patch, patch-local raster order (v-major), length = size_u0 * size_v0;
    # 0 = off.  None -> patch-level signalling.
    plrd_block_modes: list[int] | None = None
    # derived plrd block-map dims (set when the ASPS enables PLR): inter
    # patches referencing this patch size their own PLR maps from these
    # (PCCBitstreamReader.cpp:1182-1210)
    plrd_bu: int = 0
    plrd_bv: int = 0

    def write(self, bw: BitWriter, ctx: "SyntaxContext") -> None:
        bw.ue(self.pdu_2d_pos_x)
        bw.ue(self.pdu_2d_pos_y)
        bw.ue(self.pdu_2d_size_x_minus1)
        bw.ue(self.pdu_2d_size_y_minus1)
        bw.u(ctx.offset_u_bits, self.pdu_3d_offset_u)
        bw.u(ctx.offset_v_bits, self.pdu_3d_offset_v)
        bw.u(ctx.offset_d_bits, self.pdu_3d_offset_d)
        # pdu_3d_range_d gated on asps_normal_axis_max_delta_value_enabled
        # (PCCBitstreamReader.cpp:1036-1043)
        if ctx.normal_axis_max_delta:
            bw.u(ctx.range_d_bits, self.pdu_3d_range_d)
        bw.u(ctx.projection_bits, self.pdu_projection_id)
        bw.u(3 if ctx.use_eight_orientations else 1, self.pdu_orientation_index)
        if ctx.lod_mode_enabled:
            bw.u(1, self.pdu_lod_enabled_flag)
            if self.pdu_lod_enabled_flag:
                bw.ue(self.pdu_lod_scale_x_minus1)
                bw.ue(self.pdu_lod_scale_y_idc)
        if ctx.plr_enabled:
            self.plrd_bu, self.plrd_bv = _plrd_dims(
                ctx, self.pdu_2d_size_x_minus1, self.pdu_2d_size_y_minus1
            )
            _write_plrd_count(bw, ctx, self.plrd_mode, self.plrd_block_modes,
                              self.plrd_bu * self.plrd_bv)

    @classmethod
    def read(cls, br: BitReader, ctx: "SyntaxContext") -> "PatchDataUnit":
        s = cls()
        s.pdu_2d_pos_x = br.ue()
        s.pdu_2d_pos_y = br.ue()
        s.pdu_2d_size_x_minus1 = br.ue()
        s.pdu_2d_size_y_minus1 = br.ue()
        s.pdu_3d_offset_u = br.u(ctx.offset_u_bits)
        s.pdu_3d_offset_v = br.u(ctx.offset_v_bits)
        s.pdu_3d_offset_d = br.u(ctx.offset_d_bits)
        if ctx.normal_axis_max_delta:
            s.pdu_3d_range_d = br.u(ctx.range_d_bits)
        s.pdu_projection_id = br.u(ctx.projection_bits)
        s.pdu_orientation_index = br.u(3 if ctx.use_eight_orientations else 1)
        if ctx.lod_mode_enabled:
            s.pdu_lod_enabled_flag = bool(br.u(1))
            if s.pdu_lod_enabled_flag:
                s.pdu_lod_scale_x_minus1 = br.ue()
                s.pdu_lod_scale_y_idc = br.ue()
        if ctx.plr_enabled:
            s.plrd_bu, s.plrd_bv = _plrd_dims(
                ctx, s.pdu_2d_size_x_minus1, s.pdu_2d_size_y_minus1
            )
            s.plrd_mode, s.plrd_block_modes = _read_plrd_count(
                br, ctx, s.plrd_bu * s.plrd_bv
            )
        return s


@dataclasses.dataclass
class InterPatchDataUnit:
    ipdu_ref_index: int = 0
    ipdu_patch_index: int = 0
    ipdu_2d_pos_x: int = 0
    ipdu_2d_pos_y: int = 0
    ipdu_2d_delta_size_x: int = 0
    ipdu_2d_delta_size_y: int = 0
    ipdu_3d_offset_u: int = 0
    ipdu_3d_offset_v: int = 0
    ipdu_3d_offset_d: int = 0
    ipdu_3d_range_d: int = 0
    # PLR data (carried when the ASPS enables PLR; the block map is sized
    # from the REFERENCE patch's map plus this unit's 2D size deltas,
    # PCCBitstreamReader.cpp:1182-1218)
    plrd_mode: int = 0
    plrd_block_modes: list[int] | None = None
    plrd_bu: int = 0
    plrd_bv: int = 0

    def _plr_dims(self, ctx: "SyntaxContext") -> tuple[int, int]:
        """Block-map dims = ref patch's plrd map + coded size deltas; the
        ref patch lives in the previous same-tile ATL at index
        (ipdu_patch_index + predPatchIndex)."""
        ref_idx = self.ipdu_patch_index + ctx.pred_patch_index
        if ctx.ref_patches is None or not (
            0 <= ref_idx < len(ctx.ref_patches)
        ):
            raise ValueError(
                f"inter patch PLR references patch {ref_idx} of the "
                "previous tile, which does not exist"
            )
        ref = ctx.ref_patches[ref_idx].data
        bu = self.ipdu_2d_delta_size_x + getattr(ref, "plrd_bu", 0)
        bv = self.ipdu_2d_delta_size_y + getattr(ref, "plrd_bv", 0)
        if bu <= 0 or bv <= 0:
            raise ValueError(
                f"inter patch PLR block map degenerate ({bu}x{bv})"
            )
        return bu, bv

    def write(self, bw: BitWriter, ctx: "SyntaxContext") -> None:
        if ctx.num_ref_idx_active > 1:
            bw.ue(self.ipdu_ref_index)
        bw.se(self.ipdu_patch_index)
        bw.se(self.ipdu_2d_pos_x)
        bw.se(self.ipdu_2d_pos_y)
        bw.se(self.ipdu_2d_delta_size_x)
        bw.se(self.ipdu_2d_delta_size_y)
        bw.se(self.ipdu_3d_offset_u)
        bw.se(self.ipdu_3d_offset_v)
        bw.se(self.ipdu_3d_offset_d)
        if ctx.normal_axis_max_delta:
            bw.se(self.ipdu_3d_range_d)
        if ctx.plr_enabled:
            self.plrd_bu, self.plrd_bv = self._plr_dims(ctx)
            _write_plrd_count(bw, ctx, self.plrd_mode, self.plrd_block_modes,
                              self.plrd_bu * self.plrd_bv)
            ctx.prev_patch_size_u = self.plrd_bu
            ctx.prev_patch_size_v = self.plrd_bv
            ctx.pred_patch_index += self.ipdu_patch_index + 1

    @classmethod
    def read(cls, br: BitReader, ctx: "SyntaxContext") -> "InterPatchDataUnit":
        s = cls()
        if ctx.num_ref_idx_active > 1:
            s.ipdu_ref_index = br.ue()
        s.ipdu_patch_index = br.se()
        s.ipdu_2d_pos_x = br.se()
        s.ipdu_2d_pos_y = br.se()
        s.ipdu_2d_delta_size_x = br.se()
        s.ipdu_2d_delta_size_y = br.se()
        s.ipdu_3d_offset_u = br.se()
        s.ipdu_3d_offset_v = br.se()
        s.ipdu_3d_offset_d = br.se()
        if ctx.normal_axis_max_delta:
            s.ipdu_3d_range_d = br.se()
        if ctx.plr_enabled:
            s.plrd_bu, s.plrd_bv = s._plr_dims(ctx)
            s.plrd_mode, s.plrd_block_modes = _read_plrd_count(
                br, ctx, s.plrd_bu * s.plrd_bv
            )
            ctx.prev_patch_size_u = s.plrd_bu
            ctx.prev_patch_size_v = s.plrd_bv
            ctx.pred_patch_index += s.ipdu_patch_index + 1
        return s


@dataclasses.dataclass
class MergePatchDataUnit:
    mpdu_ref_index: int = 0
    mpdu_override_2d_params_flag: bool = False
    mpdu_2d_pos_x: int = 0
    mpdu_2d_pos_y: int = 0
    mpdu_2d_delta_size_x: int = 0
    mpdu_2d_delta_size_y: int = 0
    mpdu_override_3d_params_flag: bool = False
    mpdu_3d_offset_u: int = 0
    mpdu_3d_offset_v: int = 0
    mpdu_3d_offset_d: int = 0
    mpdu_3d_range_d: int = 0
    # PLR data: carried when overriding 2D params (implicit) or when
    # overriding 3D params with mpdu_override_plr_flag set; the block map
    # is sized from the tile's running prev patch size plus the deltas
    # (PCCBitstreamReader.cpp:1093-1135)
    mpdu_override_plr_flag: bool = False
    plrd_mode: int = 0
    plrd_block_modes: list[int] | None = None
    plrd_bu: int = 0
    plrd_bv: int = 0

    def write(self, bw: BitWriter, ctx: "SyntaxContext") -> None:
        override_plr = False
        if ctx.num_ref_idx_active > 1:
            bw.ue(self.mpdu_ref_index)
        bw.u(1, self.mpdu_override_2d_params_flag)
        if self.mpdu_override_2d_params_flag:
            bw.se(self.mpdu_2d_pos_x)
            bw.se(self.mpdu_2d_pos_y)
            bw.se(self.mpdu_2d_delta_size_x)
            bw.se(self.mpdu_2d_delta_size_y)
            if ctx.plr_enabled:
                override_plr = True
        else:
            bw.u(1, self.mpdu_override_3d_params_flag)
            if self.mpdu_override_3d_params_flag:
                bw.se(self.mpdu_3d_offset_u)
                bw.se(self.mpdu_3d_offset_v)
                bw.se(self.mpdu_3d_offset_d)
                if ctx.normal_axis_max_delta:
                    bw.se(self.mpdu_3d_range_d)
                if ctx.plr_enabled:
                    override_plr = self.mpdu_override_plr_flag
                    bw.u(1, override_plr)
        if override_plr and ctx.plr_enabled:
            dx, dy = self.mpdu_2d_delta_size_x, self.mpdu_2d_delta_size_y
            self.plrd_bu = ctx.prev_patch_size_u + dx
            self.plrd_bv = ctx.prev_patch_size_v + dy
            if self.plrd_bu <= 0 or self.plrd_bv <= 0:
                raise ValueError(
                    "merge patch PLR block map degenerate "
                    f"({self.plrd_bu}x{self.plrd_bv})"
                )
            _write_plrd_count(bw, ctx, self.plrd_mode, self.plrd_block_modes,
                              self.plrd_bu * self.plrd_bv)
            ctx.prev_patch_size_u += dx
            ctx.prev_patch_size_v += dy

    @classmethod
    def read(cls, br: BitReader, ctx: "SyntaxContext") -> "MergePatchDataUnit":
        s = cls()
        override_plr = False
        if ctx.num_ref_idx_active > 1:
            s.mpdu_ref_index = br.ue()
        s.mpdu_override_2d_params_flag = bool(br.u(1))
        if s.mpdu_override_2d_params_flag:
            s.mpdu_2d_pos_x = br.se()
            s.mpdu_2d_pos_y = br.se()
            s.mpdu_2d_delta_size_x = br.se()
            s.mpdu_2d_delta_size_y = br.se()
            if ctx.plr_enabled:
                override_plr = True
        else:
            s.mpdu_override_3d_params_flag = bool(br.u(1))
            if s.mpdu_override_3d_params_flag:
                s.mpdu_3d_offset_u = br.se()
                s.mpdu_3d_offset_v = br.se()
                s.mpdu_3d_offset_d = br.se()
                if ctx.normal_axis_max_delta:
                    s.mpdu_3d_range_d = br.se()
                if ctx.plr_enabled:
                    override_plr = bool(br.u(1))
                    s.mpdu_override_plr_flag = override_plr
        if override_plr and ctx.plr_enabled:
            dx, dy = s.mpdu_2d_delta_size_x, s.mpdu_2d_delta_size_y
            s.plrd_bu = ctx.prev_patch_size_u + dx
            s.plrd_bv = ctx.prev_patch_size_v + dy
            if s.plrd_bu <= 0 or s.plrd_bv <= 0:
                raise ValueError(
                    "merge patch PLR block map degenerate "
                    f"({s.plrd_bu}x{s.plrd_bv})"
                )
            s.plrd_mode, s.plrd_block_modes = _read_plrd_count(
                br, ctx, s.plrd_bu * s.plrd_bv
            )
            ctx.prev_patch_size_u += dx
            ctx.prev_patch_size_v += dy
        return s


@dataclasses.dataclass
class SkipPatchDataUnit:
    def write(self, bw: BitWriter, ctx: "SyntaxContext") -> None:
        pass

    @classmethod
    def read(cls, br: BitReader, ctx: "SyntaxContext") -> "SkipPatchDataUnit":
        return cls()


@dataclasses.dataclass
class RawPatchDataUnit:
    rpdu_patch_in_auxiliary_video_flag: bool = False
    rpdu_2d_pos_x: int = 0
    rpdu_2d_pos_y: int = 0
    rpdu_2d_size_x_minus1: int = 0
    rpdu_2d_size_y_minus1: int = 0
    rpdu_3d_offset_u: int = 0
    rpdu_3d_offset_v: int = 0
    rpdu_3d_offset_d: int = 0
    rpdu_points_minus1: int = 0

    def write(self, bw: BitWriter, ctx: "SyntaxContext") -> None:
        if ctx.auxiliary_video_present:
            bw.u(1, self.rpdu_patch_in_auxiliary_video_flag)
        bw.ue(self.rpdu_2d_pos_x)
        bw.ue(self.rpdu_2d_pos_y)
        bw.ue(self.rpdu_2d_size_x_minus1)
        bw.ue(self.rpdu_2d_size_y_minus1)
        bw.u(ctx.raw_3d_offset_bits, self.rpdu_3d_offset_u)
        bw.u(ctx.raw_3d_offset_bits, self.rpdu_3d_offset_v)
        bw.u(ctx.raw_3d_offset_bits, self.rpdu_3d_offset_d)
        bw.ue(self.rpdu_points_minus1)

    @classmethod
    def read(cls, br: BitReader, ctx: "SyntaxContext") -> "RawPatchDataUnit":
        s = cls()
        if ctx.auxiliary_video_present:
            s.rpdu_patch_in_auxiliary_video_flag = bool(br.u(1))
        s.rpdu_2d_pos_x = br.ue()
        s.rpdu_2d_pos_y = br.ue()
        s.rpdu_2d_size_x_minus1 = br.ue()
        s.rpdu_2d_size_y_minus1 = br.ue()
        s.rpdu_3d_offset_u = br.u(ctx.raw_3d_offset_bits)
        s.rpdu_3d_offset_v = br.u(ctx.raw_3d_offset_bits)
        s.rpdu_3d_offset_d = br.u(ctx.raw_3d_offset_bits)
        s.rpdu_points_minus1 = br.ue()
        return s


@dataclasses.dataclass
class EOMPatchDataUnit:
    epdu_patch_in_auxiliary_video_flag: bool = False
    epdu_2d_pos_x: int = 0
    epdu_2d_pos_y: int = 0
    epdu_2d_size_x_minus1: int = 0
    epdu_2d_size_y_minus1: int = 0
    epdu_associated_patches_count_minus1: int = 0
    epdu_associated_patch_idx: list[int] = field(default_factory=list)
    epdu_points: list[int] = field(default_factory=list)

    def write(self, bw: BitWriter, ctx: "SyntaxContext") -> None:
        if ctx.auxiliary_video_present:
            bw.u(1, self.epdu_patch_in_auxiliary_video_flag)
        bw.ue(self.epdu_2d_pos_x)
        bw.ue(self.epdu_2d_pos_y)
        bw.ue(self.epdu_2d_size_x_minus1)
        bw.ue(self.epdu_2d_size_y_minus1)
        bw.ue(self.epdu_associated_patches_count_minus1)
        for i in range(self.epdu_associated_patches_count_minus1 + 1):
            bw.ue(self.epdu_associated_patch_idx[i])
            bw.ue(self.epdu_points[i])

    @classmethod
    def read(cls, br: BitReader, ctx: "SyntaxContext") -> "EOMPatchDataUnit":
        s = cls()
        if ctx.auxiliary_video_present:
            s.epdu_patch_in_auxiliary_video_flag = bool(br.u(1))
        s.epdu_2d_pos_x = br.ue()
        s.epdu_2d_pos_y = br.ue()
        s.epdu_2d_size_x_minus1 = br.ue()
        s.epdu_2d_size_y_minus1 = br.ue()
        s.epdu_associated_patches_count_minus1 = br.ue()
        for _ in range(s.epdu_associated_patches_count_minus1 + 1):
            s.epdu_associated_patch_idx.append(br.ue())
            s.epdu_points.append(br.ue())
        return s


@dataclasses.dataclass
class SyntaxContext:
    """Derived variables the patch-unit syntax depends on (from active
    ASPS/AFPS/ATH), passed to every patch read/write."""

    offset_u_bits: int = 10
    offset_v_bits: int = 10
    offset_d_bits: int = 10
    range_d_bits: int = 10
    projection_bits: int = 3
    use_eight_orientations: bool = True
    normal_axis_limits_quantization: bool = True
    # range_d fields are only coded when the ASPS enables max-delta
    # signalling (PCCBitstreamReader.cpp:1036)
    normal_axis_max_delta: bool = False
    lod_mode_enabled: bool = False
    num_ref_idx_active: int = 1
    # true iff THIS TILE has an auxiliary video sub-row
    # (afti_auxiliary_video_tile_row_height[tile] > 0,
    # PCCBitstreamReader.cpp:1228-1234)
    auxiliary_video_present: bool = False
    raw_3d_offset_bits: int = 10
    plr_enabled: bool = False
    plr_mode_bits: int = 1
    # plrd level flag coded only when blockCount > threshold+1
    plr_block_threshold_plus1: int = 9
    # block-level plrd sizing: coded-size -> packing-block conversion
    packing_block_size: int = 16
    patch_size_x_quantizer: int = 16  # pixels per coded size unit (qx)
    patch_size_y_quantizer: int = 16
    # ---- per-tile decode state for PLR on inter/merge patches ----
    # The reference tracks a running (prevPatchSizeU_, prevPatchSizeV_,
    # predPatchIndex_) reset at each tile data unit and consults the
    # PREVIOUS same-tile ATL's patch list to size an inter patch's PLR
    # block map (PCCBitstreamReader.cpp:925-932 reset, :1122-1135 merge,
    # :1182-1218 inter).  ref_patches is that previous ATL's
    # PatchInformationData list (None for the first frame / I-only use).
    ref_patches: list | None = None
    prev_patch_size_u: int = 0
    prev_patch_size_v: int = 0
    pred_patch_index: int = 0

    def reset_tile_state(self) -> None:
        self.prev_patch_size_u = 0
        self.prev_patch_size_v = 0
        self.pred_patch_index = 0


# ===========================================================================
# Atlas tile layer
# ===========================================================================
@dataclasses.dataclass
class AtlasTileHeader:
    ath_no_output_of_prior_atlas_frames_flag: bool = False
    ath_atlas_frame_parameter_set_id: int = 0
    ath_atlas_adaptation_parameter_set_id: int = 0
    ath_id: int = 0
    ath_type: AtlasTileType = AtlasTileType.I_TILE
    ath_atlas_output_flag: bool = False
    ath_atlas_frm_order_cnt_lsb: int = 0
    ath_ref_atlas_frame_list_asps_flag: bool = True
    ath_ref_atlas_frame_list_idx: int = 0
    ref_list_struct: RefListStruct | None = None
    ath_num_ref_idx_active_override_flag: bool = False
    ath_num_ref_idx_active_minus1: int = 0
    ath_pos_min_d_quantizer: int = 0
    ath_pos_delta_max_d_quantizer: int = 0
    ath_patch_size_x_info_quantizer: int = 0
    ath_patch_size_y_info_quantizer: int = 0
    ath_raw_3d_offset_axis_bit_count_minus1: int = 9

    def active_ref_list(
        self, asps: AtlasSequenceParameterSetRbsp
    ) -> RefListStruct | None:
        if self.ath_ref_atlas_frame_list_asps_flag:
            if asps.ref_list_structs:
                return asps.ref_list_structs[self.ath_ref_atlas_frame_list_idx]
            return None
        return self.ref_list_struct

    def write(
        self,
        bw: BitWriter,
        asps: AtlasSequenceParameterSetRbsp,
        afps: AtlasFrameParameterSetRbsp,
        nal_is_irap: bool,
    ) -> None:
        """Field order matches PCCBitstreamReader::atlasTileHeader
        (PCCBitstreamReader.cpp:779-866): quantizers and the raw-offset bit
        count come BEFORE the num-ref-idx override, ath_id is u(v) sized by
        the AFTI, and the raw-offset count codes in floorLog2(g3d) bits."""
        afti = afps.atlas_frame_tile_information
        if nal_is_irap:
            bw.u(1, self.ath_no_output_of_prior_atlas_frames_flag)
        bw.ue(self.ath_atlas_frame_parameter_set_id)
        bw.ue(self.ath_atlas_adaptation_parameter_set_id)
        bw.u(afti.ath_id_bits(), self.ath_id)
        bw.ue(int(self.ath_type))
        if afps.afps_output_flag_present_flag:
            bw.u(1, self.ath_atlas_output_flag)
        bw.u(
            asps.asps_log2_max_atlas_frame_order_cnt_lsb_minus4 + 4,
            self.ath_atlas_frm_order_cnt_lsb,
        )
        if len(asps.ref_list_structs) > 0:
            bw.u(1, self.ath_ref_atlas_frame_list_asps_flag)
        if not self.ath_ref_atlas_frame_list_asps_flag:
            assert self.ref_list_struct is not None
            self.ref_list_struct.write(
                bw, asps.asps_long_term_ref_atlas_frames_flag
            )
        elif len(asps.ref_list_structs) > 1:
            bw.u(_ceil_log2(len(asps.ref_list_structs)),
                 self.ath_ref_atlas_frame_list_idx)
        if self.ath_type != AtlasTileType.SKIP_TILE:
            if asps.asps_normal_axis_limits_quantization_enabled_flag:
                bw.u(5, self.ath_pos_min_d_quantizer)
                if asps.asps_normal_axis_max_delta_value_enabled_flag:
                    bw.u(5, self.ath_pos_delta_max_d_quantizer)
            if asps.asps_patch_size_quantizer_present_flag:
                bw.u(3, self.ath_patch_size_x_info_quantizer)
                bw.u(3, self.ath_patch_size_y_info_quantizer)
            if afps.afps_raw_3d_offset_bit_count_explicit_mode_flag:
                bits = _floor_log2(asps.asps_geometry_3d_bitdepth_minus1 + 1)
                bw.u(bits, self.ath_raw_3d_offset_axis_bit_count_minus1)
            rl = self.active_ref_list(asps)
            if self.ath_type == AtlasTileType.P_TILE and (
                rl is not None and rl.num_ref_entries > 1
            ):
                bw.u(1, self.ath_num_ref_idx_active_override_flag)
                if self.ath_num_ref_idx_active_override_flag:
                    bw.ue(self.ath_num_ref_idx_active_minus1)
        bw.byte_align()

    @classmethod
    def read(
        cls,
        br: BitReader,
        asps_lookup,
        afps_lookup,
        nal_is_irap: bool,
    ) -> "AtlasTileHeader":
        s = cls()
        if nal_is_irap:
            s.ath_no_output_of_prior_atlas_frames_flag = bool(br.u(1))
        s.ath_atlas_frame_parameter_set_id = br.ue()
        afps = afps_lookup(s.ath_atlas_frame_parameter_set_id)
        asps = asps_lookup(afps.afps_atlas_sequence_parameter_set_id)
        afti = afps.atlas_frame_tile_information
        s.ath_atlas_adaptation_parameter_set_id = br.ue()
        id_bits = afti.ath_id_bits()
        s.ath_id = br.u(id_bits) if id_bits else 0
        s.ath_type = AtlasTileType(br.ue())
        if afps.afps_output_flag_present_flag:
            s.ath_atlas_output_flag = bool(br.u(1))
        s.ath_atlas_frm_order_cnt_lsb = br.u(
            asps.asps_log2_max_atlas_frame_order_cnt_lsb_minus4 + 4
        )
        if len(asps.ref_list_structs) > 0:
            s.ath_ref_atlas_frame_list_asps_flag = bool(br.u(1))
        else:
            s.ath_ref_atlas_frame_list_asps_flag = False
        if not s.ath_ref_atlas_frame_list_asps_flag:
            s.ref_list_struct = RefListStruct.read(
                br, asps.asps_long_term_ref_atlas_frames_flag
            )
        elif len(asps.ref_list_structs) > 1:
            s.ath_ref_atlas_frame_list_idx = br.u(
                _ceil_log2(len(asps.ref_list_structs))
            )
        if s.ath_type != AtlasTileType.SKIP_TILE:
            if asps.asps_normal_axis_limits_quantization_enabled_flag:
                s.ath_pos_min_d_quantizer = br.u(5)
                if asps.asps_normal_axis_max_delta_value_enabled_flag:
                    s.ath_pos_delta_max_d_quantizer = br.u(5)
            if asps.asps_patch_size_quantizer_present_flag:
                s.ath_patch_size_x_info_quantizer = br.u(3)
                s.ath_patch_size_y_info_quantizer = br.u(3)
            if afps.afps_raw_3d_offset_bit_count_explicit_mode_flag:
                bits = _floor_log2(asps.asps_geometry_3d_bitdepth_minus1 + 1)
                s.ath_raw_3d_offset_axis_bit_count_minus1 = br.u(bits)
            else:
                s.ath_raw_3d_offset_axis_bit_count_minus1 = (
                    max(
                        0,
                        asps.asps_geometry_3d_bitdepth_minus1
                        - asps.asps_geometry_2d_bitdepth_minus1,
                    )
                    - 1
                )
            rl = s.active_ref_list(asps)
            if s.ath_type == AtlasTileType.P_TILE and (
                rl is not None and rl.num_ref_entries > 1
            ):
                s.ath_num_ref_idx_active_override_flag = bool(br.u(1))
                if s.ath_num_ref_idx_active_override_flag:
                    s.ath_num_ref_idx_active_minus1 = br.ue()
        br.rbsp_trailing()
        return s


@dataclasses.dataclass
class PatchInformationData:
    patch_mode: int = 0
    data: object = None  # one of the *PatchDataUnit classes


@dataclasses.dataclass
class AtlasTileDataUnit:
    patches: list[PatchInformationData] = field(default_factory=list)

    _I_UNITS = {
        PatchModeITile.I_INTRA: PatchDataUnit,
        PatchModeITile.I_RAW: RawPatchDataUnit,
        PatchModeITile.I_EOM: EOMPatchDataUnit,
    }
    _P_UNITS = {
        PatchModePTile.P_SKIP: SkipPatchDataUnit,
        PatchModePTile.P_MERGE: MergePatchDataUnit,
        PatchModePTile.P_INTER: InterPatchDataUnit,
        PatchModePTile.P_INTRA: PatchDataUnit,
        PatchModePTile.P_RAW: RawPatchDataUnit,
        PatchModePTile.P_EOM: EOMPatchDataUnit,
    }

    def write(self, bw: BitWriter, tile_type: AtlasTileType, ctx: SyntaxContext) -> None:
        if tile_type == AtlasTileType.SKIP_TILE:
            # skip tiles carry no patch modes at all
            # (PCCBitstreamReader.cpp:917-922)
            bw.byte_align()
            return
        ctx.reset_tile_state()  # PCCBitstreamReader.cpp:930-932 analog
        for pid in self.patches:
            bw.ue(pid.patch_mode)
            pid.data.write(bw, ctx)
        end_mode = (
            PatchModeITile.I_END
            if tile_type == AtlasTileType.I_TILE
            else PatchModePTile.P_END
        )
        bw.ue(int(end_mode))
        bw.byte_align()

    @classmethod
    def read(
        cls, br: BitReader, tile_type: AtlasTileType, ctx: SyntaxContext
    ) -> "AtlasTileDataUnit":
        s = cls()
        if tile_type == AtlasTileType.SKIP_TILE:
            br.rbsp_trailing()
            return s
        ctx.reset_tile_state()  # PCCBitstreamReader.cpp:930-932 analog
        units = cls._I_UNITS if tile_type == AtlasTileType.I_TILE else cls._P_UNITS
        end_val = int(
            PatchModeITile.I_END
            if tile_type == AtlasTileType.I_TILE
            else PatchModePTile.P_END
        )
        while True:
            mode = br.ue()
            if mode == end_val:
                break
            key = (
                PatchModeITile(mode)
                if tile_type == AtlasTileType.I_TILE
                else PatchModePTile(mode)
            )
            unit_cls = units[key]
            s.patches.append(
                PatchInformationData(patch_mode=mode, data=unit_cls.read(br, ctx))
            )
        br.rbsp_trailing()
        return s


@dataclasses.dataclass
class AtlasTileLayerRbsp:
    header: AtlasTileHeader = field(default_factory=AtlasTileHeader)
    data_unit: AtlasTileDataUnit = field(default_factory=AtlasTileDataUnit)
    # decoded atlas frame order count (derived, not coded)
    afoc: int = 0
