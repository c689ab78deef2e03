"""High-level-syntax container: the decoded state of one GOF's bitstream.

Parity with PCCHighLevelSyntax + PCCContext (source/lib/
PccLibBitstreamCommon/include/PCCHighLevelSyntax.h:57-342,
PccLibCommon/include/PCCContext.h:125-204): VPS list, per-atlas ASPS/AFPS/
ATL lists, per-atlas video sub-bitstreams, received SEI store.  Decoded
videos / frame state live in codec.context (decoder-side), not here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field

from ..utils.enums import VideoType
from .sei import Sei
from .syntax import (
    AtlasFrameParameterSetRbsp,
    AtlasSequenceParameterSetRbsp,
    AtlasTileLayerRbsp,
    SyntaxContext,
    V3CParameterSet,
)
from .video_bitstream import VideoBitstream


@dataclasses.dataclass
class AtlasHLS:
    """Per-atlas high-level syntax + video sub-bitstreams."""

    atlas_id: int = 0
    asps_list: list[AtlasSequenceParameterSetRbsp] = field(default_factory=list)
    afps_list: list[AtlasFrameParameterSetRbsp] = field(default_factory=list)
    atlas_tile_layers: list[AtlasTileLayerRbsp] = field(default_factory=list)
    video_bitstreams: dict[VideoType, VideoBitstream] = field(default_factory=dict)
    # AVD sub-streams beyond the standard set, keyed by
    # (vuh_attribute_index, vuh_attribute_partition_index, vuh_map_index) —
    # dimension-partitioned attributes and extra attributes (the reference
    # decodes per-partition/per-attribute videos, PCCDecoder.cpp:208-300).
    # Attr 0 partition 0 and attr 1 (reflectance) partition 0 keep their
    # VideoType slots above; everything else routes here.
    attr_ext: dict[tuple[int, int, int], VideoBitstream] = field(
        default_factory=dict
    )
    seis_prefix: list[Sei] = field(default_factory=list)
    seis_suffix: list[Sei] = field(default_factory=list)

    def asps(self, id: int = 0) -> AtlasSequenceParameterSetRbsp:
        for a in self.asps_list:
            if a.asps_atlas_sequence_parameter_set_id == id:
                return a
        raise KeyError(f"no ASPS with id {id}")

    def afps(self, id: int = 0) -> AtlasFrameParameterSetRbsp:
        for a in self.afps_list:
            if a.afps_atlas_frame_parameter_set_id == id:
                return a
        raise KeyError(f"no AFPS with id {id}")

    def get_video_bitstream(self, vtype: VideoType) -> VideoBitstream:
        return self.video_bitstreams[vtype]

    def tile_origin(self, afps: AtlasFrameParameterSetRbsp, tile_id: int
                    ) -> tuple[int, int]:
        """(x, y) pixel origin of a tile (uniform-partition AFTI layout;
        partitions are in 64-pixel units per 23090-5)."""
        afti = afps.atlas_frame_tile_information
        if afti.afti_single_tile_in_atlas_frame_flag:
            return 0, 0
        if afti.afti_uniform_partition_spacing_flag:
            cols = afti.afti_num_partition_columns_minus1 + 1
            w64 = (afti.afti_partition_cols_width_minus1 + 1) * 64
            h64 = (afti.afti_partition_rows_height_minus1 + 1) * 64
            return (tile_id % cols) * w64, (tile_id // cols) * h64
        # explicit lists: tile_id walks the partition grid row-major (with
        # one column — this encoder's band layout — x is always 0)
        cols = afti.afti_num_partition_columns_minus1 + 1
        col, row = tile_id % cols, tile_id // cols
        x = sum(
            (w + 1) * 64
            for w in afti.afti_partition_column_widths_minus1[:col]
        )
        y = sum(
            (h + 1) * 64
            for h in afti.afti_partition_row_heights_minus1[:row]
        )
        return x, y

    def set_video_bitstream(self, vb: VideoBitstream) -> None:
        self.video_bitstreams[vb.type] = vb

    def num_ref_idx_active(
        self,
        ath,
        asps: AtlasSequenceParameterSetRbsp,
        afps: AtlasFrameParameterSetRbsp,
    ) -> int:
        """NumRefIdxActive derivation — getNumRefIdxActive
        (PCCHighLevelSyntax.cpp:45-63): override -> minus1+1, else
        min(active ref list entries, afps default), P/SKIP tiles only."""
        from ..utils.enums import AtlasTileType

        if ath.ath_type not in (AtlasTileType.P_TILE, AtlasTileType.SKIP_TILE):
            return 0
        if ath.ath_num_ref_idx_active_override_flag:
            return ath.ath_num_ref_idx_active_minus1 + 1
        rl = ath.active_ref_list(asps)
        entries = rl.num_ref_entries if rl is not None else 0
        return min(entries, afps.afps_num_ref_idx_default_active_minus1 + 1)

    def syntax_context(
        self,
        asps: AtlasSequenceParameterSetRbsp,
        afps: AtlasFrameParameterSetRbsp,
        num_ref_idx_active: int = 1,
        ath=None,
    ) -> SyntaxContext:
        """Derive the patch-syntax bit widths from the active parameter sets
        (23090-5 derivation of Pdu3dOffset*BitCount etc.)."""
        geom3d = asps.asps_geometry_3d_bitdepth_minus1 + 1
        geom2d = asps.asps_geometry_2d_bitdepth_minus1 + 1
        min_d_quant = ath.ath_pos_min_d_quantizer if ath is not None else 0
        afti = afps.atlas_frame_tile_information
        if ath is not None and asps.asps_auxiliary_video_enabled_flag:
            # per-tile gate: the rpdu/epdu in-aux flag codes only when THIS
            # tile has an aux sub-row (PCCBitstreamReader.cpp rawPatchDataUnit)
            aux_present = (
                afti.aux_row_height(afti.tile_index_of(ath.ath_id)) > 0
            )
        else:
            aux_present = asps.asps_auxiliary_video_enabled_flag
        return SyntaxContext(
            offset_u_bits=geom3d,
            offset_v_bits=geom3d,
            offset_d_bits=max(1, geom3d - min_d_quant),
            # bitCountForMaxDepth = min(geom2d-1, geom3d-1) + 1 - quantizer
            # (PCCBitstreamReader.cpp:1042)
            range_d_bits=max(1, min(geom2d, geom3d) - (
                ath.ath_pos_delta_max_d_quantizer
                if ath is not None
                and asps.asps_normal_axis_max_delta_value_enabled_flag
                else 0
            )),
            # ceilLog2(MaxNumberProjectionsMinus1 + 1) unconditionally
            # (PCCBitstreamReader.cpp:1050) == bit_length of the minus1 value
            projection_bits=(
                asps.asps_max_number_projections_minus1
            ).bit_length(),
            use_eight_orientations=asps.asps_use_eight_orientations_flag,
            normal_axis_limits_quantization=(
                asps.asps_normal_axis_limits_quantization_enabled_flag
            ),
            normal_axis_max_delta=(
                asps.asps_normal_axis_max_delta_value_enabled_flag
            ),
            lod_mode_enabled=afps.afps_lod_mode_enabled_flag,
            num_ref_idx_active=num_ref_idx_active,
            auxiliary_video_present=aux_present,
            raw_3d_offset_bits=(
                ath.ath_raw_3d_offset_axis_bit_count_minus1 + 1
                if ath is not None
                else geom3d
            ),
            plr_enabled=asps.asps_plr_enabled_flag,
            # coded values are (mode - 1) in 0..numberOfModesMinus1-1:
            # ceilLog2(numberOfModesMinus1) bits, the reference's width
            # (PCCBitstreamReader plrData) — ZERO bits when only one coded
            # mode exists, exactly as ceilLog2(1) == 0
            plr_mode_bits=(
                asps.asps_plr_number_of_modes_minus1 - 1
            ).bit_length(),
            plr_block_threshold_plus1=(
                asps.plri_block_threshold_per_patch_minus1 + 1
            ),
            packing_block_size=(
                1 << asps.asps_log2_patch_packing_block_size
            ),
            patch_size_x_quantizer=(
                1 << ath.ath_patch_size_x_info_quantizer
                if asps.asps_patch_size_quantizer_present_flag
                and ath is not None
                else 1 << asps.asps_log2_patch_packing_block_size
            ),
            patch_size_y_quantizer=(
                1 << ath.ath_patch_size_y_info_quantizer
                if asps.asps_patch_size_quantizer_present_flag
                and ath is not None
                else 1 << asps.asps_log2_patch_packing_block_size
            ),
        )


@dataclasses.dataclass
class Context:
    """One GOF's worth of bitstream-level state."""

    vps_list: list[V3CParameterSet] = field(default_factory=list)
    atlases: list[AtlasHLS] = field(default_factory=list)
    active_vps_id: int = 0

    @property
    def vps(self) -> V3CParameterSet:
        for v in self.vps_list:
            if v.vps_v3c_parameter_set_id == self.active_vps_id:
                return v
        raise KeyError(f"no VPS with id {self.active_vps_id}")

    def atlas(self, atlas_id: int = 0) -> AtlasHLS:
        for a in self.atlases:
            if a.atlas_id == atlas_id:
                return a
        a = AtlasHLS(atlas_id=atlas_id)
        self.atlases.append(a)
        return a

    @property
    def atlas_count(self) -> int:
        return len(self.atlases)

    def map1_absolute(self) -> bool:
        """Whether map-1 video streams are coded absolutely
        (vps_map_absolute_coding_enabled_flag[1]); False = the map-1 stream
        is a biased delta vs the reconstructed map 0.  Decoder, transcoder
        and batched transcoder must all agree on this one derivation."""
        va = self.vps.atlas(0)
        if (va.vps_map_count_minus1 >= 1
                and len(va.vps_map_absolute_coding_enabled_flag) > 1):
            return bool(va.vps_map_absolute_coding_enabled_flag[1])
        return True

    def check_profile(self) -> int:
        """Verify the active parameter sets against the PTL's declared
        toolset constraints (PCCHighLevelSyntax::checkProfile,
        PCCHighLevelSyntax.cpp:89-160).  Returns 0 when conforming, the
        reference's violation code otherwise."""
        import sys

        def warn(code: int, msg: str) -> int:
            print(f"ProfileToolsetConstraint Violation({code}): {msg}",
                  file=sys.stderr)
            return code

        if len(self.atlases) != 1:
            return warn(1, "number of atlases should be 1")
        vps = self.vps
        ptl = vps.profile_tier_level
        if not ptl.ptl_tool_constraints_present_flag or (
            ptl.ptl_toolset_constraints is None
        ):
            return 0
        ptc = ptl.ptl_toolset_constraints
        va = vps.atlas(0)
        ret = 0
        if (ptc.ptc_multiple_map_streams_constraint_flag
                and va.vps_multiple_map_streams_present_flag):
            ret = warn(3, "multiple map streams used but constrained away")
        if va.vps_map_count_minus1 > ptc.ptc_max_map_count_minus1:
            ret = warn(
                7,
                f"map count {va.vps_map_count_minus1 + 1} exceeds "
                f"constraint {ptc.ptc_max_map_count_minus1 + 1}",
            )
        ai = va.attribute_information
        if ai.ai_attribute_count and any(
            d > ptc.ptc_attribute_max_dimension_minus1
            for d in ai.ai_attribute_dimension_minus1
        ):
            ret = warn(6, "attribute dimension exceeds constraint")
        for asps in self.atlases[0].asps_list:
            if ptc.ptc_eom_constraint_flag and (
                asps.asps_eom_patch_enabled_flag
            ):
                ret = warn(2, "EOM patches used but constrained away")
            if ptc.ptc_plr_constraint_flag and asps.asps_plr_enabled_flag:
                ret = warn(4, "PLR used but constrained away")
            if ptc.ptc_no_eight_orientations_constraint_flag and (
                asps.asps_use_eight_orientations_flag
            ):
                ret = warn(5, "eight orientations used but constrained away")
            if ptc.ptc_no_45degree_projection_patch_constraint_flag and (
                asps.asps_extended_projection_enabled_flag
            ):
                ret = warn(8, "45-degree projection used but constrained away")
        return ret
