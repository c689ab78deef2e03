"""Cross-implementation V3C syntax gate (SURVEY §7 milestone 1).

Flattens this framework's parsed ``Context`` into the same flat
``key=value`` space that ``tools/refgate/refparse.cpp`` dumps after parsing
a .bin with the MPEG TMC2 reference bitstream reader (compiled in-env from
a TMC2 source tree — linked, never copied).  ``compare()`` then asserts
field-level equality in the our-writer -> reference-reader direction;
``tools/refgate/refwrite.cpp`` covers the reverse.

Reference entry points: PCCBitstreamReader.h:95-110 (read/decode),
PccAppParser.cpp:50-77 (decode loop).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

from ..utils.enums import AtlasTileType
from ..bitstream.syntax import (
    EOMPatchDataUnit,
    InterPatchDataUnit,
    MergePatchDataUnit,
    PatchDataUnit,
    RawPatchDataUnit,
)

# the TMC2 source tree (RABBIT_REF_ROOT, else ``reference/`` at the root of
# the checkout) and the tools' build directory (under the checkout's build/)
_ROOT = Path(__file__).resolve().parents[2]
REF_ROOT = Path(os.environ.get("RABBIT_REF_ROOT", _ROOT / "reference"))
BUILD_DIR = Path(os.environ.get("RABBIT_REFGATE_DIR",
                                _ROOT / "build" / "refgate"))
_TOOLS = _ROOT / "tools" / "refgate"


def reference_available() -> bool:
    return (REF_ROOT / "source/lib/PccLibBitstreamReader").is_dir()


def build_refgate() -> Path:
    """Compile refparse/refwrite against the reference libs (cached)."""
    binary = BUILD_DIR / "refparse"
    script = _TOOLS / "build.sh"
    sources = [
        script,
        _TOOLS / "refparse.cpp",
        _TOOLS / "refwrite.cpp",
        _TOOLS / "hevcparse.cpp",
    ]
    if binary.exists() and binary.stat().st_mtime >= max(
        s.stat().st_mtime for s in sources if s.exists()
    ):
        return binary
    subprocess.run(
        ["bash", str(script), str(BUILD_DIR)],
        check=True,
        capture_output=True,
        env={**os.environ, "REF": str(REF_ROOT)},
    )
    return binary


def hevc_parser_available() -> bool:
    return (REF_ROOT / "dependencies/PccLibHevcParser").is_dir()


def run_hevcparse(stream_path: str | Path) -> dict[str, int]:
    """Parse an Annex-B HEVC stream with the reference's PccLibHevcParser
    (the library TMC2 probes HEVC sub-streams with) -> {key: int}."""
    build_refgate()
    out = subprocess.run(
        [str(BUILD_DIR / "hevcparse"), str(stream_path)],
        check=True, capture_output=True, text=True,
    ).stdout
    fields: dict[str, int] = {}
    for line in out.splitlines():
        if "=" in line and not line.startswith(" "):
            k, _, v = line.partition("=")
            try:
                fields[k] = int(v)
            except ValueError:
                pass
    return fields


def run_refparse(bin_path: str | Path) -> dict[str, int]:
    """Parse a .bin with the reference reader -> {flat_key: int}."""
    binary = build_refgate()
    out = subprocess.run(
        [str(binary), str(bin_path)], check=True, capture_output=True,
        text=True,
    ).stdout
    fields: dict[str, int] = {}
    for line in out.splitlines():
        if "=" in line and not line.startswith(" "):
            k, _, v = line.partition("=")
            try:
                fields[k] = int(v)
            except ValueError:
                pass
    return fields


# ---------------------------------------------------------------------------
# Flatten OUR parsed Context into refparse's key space
# ---------------------------------------------------------------------------
def _u8(v: int) -> int:
    """The reference stores the inferred -1 bit count in a uint8."""
    return v & 0xFF if v < 0 else v


def flatten_contexts(contexts) -> dict[str, int]:
    fields: dict[str, int] = {}
    for g, ctx in enumerate(contexts):
        _flatten_one(fields, f"g{g}", ctx)
    fields["gof_count"] = len(contexts)
    return fields


def _flatten_one(fields: dict[str, int], g: str, ctx) -> None:
    P = fields.__setitem__
    vps = ctx.vps_list[ctx.active_vps_id]
    P(f"{g}.vps.id", vps.vps_v3c_parameter_set_id)
    P(f"{g}.vps.atlas_count_minus1", vps.vps_atlas_count_minus1)
    ptl = vps.profile_tier_level
    P(f"{g}.vps.ptl.tier", int(ptl.ptl_tier_flag))
    P(f"{g}.vps.ptl.codec_group_idc", ptl.ptl_profile_codec_group_idc)
    P(f"{g}.vps.ptl.toolset_idc", ptl.ptl_profile_toolset_idc)
    P(f"{g}.vps.ptl.reconstruction_idc", ptl.ptl_profile_reconstruction_idc)
    P(f"{g}.vps.ptl.level_idc", ptl.ptl_level_idc)
    for j, a in enumerate(vps.atlases):
        pre = f"{g}.vps.atlas{j}"
        P(f"{pre}.id", a.vps_atlas_id)
        P(f"{pre}.frame_width", a.vps_frame_width)
        P(f"{pre}.frame_height", a.vps_frame_height)
        P(f"{pre}.map_count_minus1", a.vps_map_count_minus1)
        P(f"{pre}.multiple_map_streams",
          int(a.vps_multiple_map_streams_present_flag))
        P(f"{pre}.auxiliary_video", int(a.vps_auxiliary_video_present_flag))
        P(f"{pre}.occupancy_video", int(a.vps_occupancy_video_present_flag))
        P(f"{pre}.geometry_video", int(a.vps_geometry_video_present_flag))
        P(f"{pre}.attribute_video", int(a.vps_attribute_video_present_flag))
        for m in range(1, a.vps_map_count_minus1 + 1):
            P(f"{pre}.map{m}.absolute_coding",
              int(a.vps_map_absolute_coding_enabled_flag[m]))
        gi = a.geometry_information
        P(f"{pre}.gi.codec_id", gi.gi_geometry_codec_id)
        P(f"{pre}.gi.bitdepth_2d_minus1", gi.gi_geometry_2d_bitdepth_minus1)
        P(f"{pre}.gi.bitdepth_3d_minus1",
          gi.gi_geometry_3d_coordinates_bitdepth_minus1)
        P(f"{pre}.gi.msb_align", int(gi.gi_geometry_msb_align_flag))
        if a.vps_auxiliary_video_present_flag:
            P(f"{pre}.gi.aux_codec_id", gi.gi_auxiliary_geometry_codec_id)
        oi = a.occupancy_information
        P(f"{pre}.oi.codec_id", oi.oi_occupancy_codec_id)
        P(f"{pre}.oi.bitdepth_2d_minus1", oi.oi_occupancy_2d_bitdepth_minus1)
        P(f"{pre}.oi.msb_align", int(oi.oi_occupancy_msb_align_flag))
        P(f"{pre}.oi.lossy_threshold",
          oi.oi_lossy_occupancy_compression_threshold)
        ai = a.attribute_information
        P(f"{pre}.ai.count", ai.ai_attribute_count)
        for i in range(ai.ai_attribute_count):
            ap = f"{pre}.ai.attr{i}"
            P(f"{ap}.type", ai.ai_attribute_type_id[i])
            P(f"{ap}.codec_id", ai.ai_attribute_codec_id[i])
            P(f"{ap}.dimension_minus1", ai.ai_attribute_dimension_minus1[i])
            P(f"{ap}.bitdepth_2d_minus1",
              ai.ai_attribute_2d_bitdepth_minus1[i])
            P(f"{ap}.msb_align", int(ai.ai_attribute_msb_align_flag[i]))
            P(f"{ap}.dimension_partitions_minus1", ai._partitions(i))
    atlas = ctx.atlases[0]
    for i, asps in enumerate(atlas.asps_list):
        pre = f"{g}.asps{i}"
        P(f"{pre}.id", asps.asps_atlas_sequence_parameter_set_id)
        P(f"{pre}.frame_width", asps.asps_frame_width)
        P(f"{pre}.frame_height", asps.asps_frame_height)
        P(f"{pre}.geometry_3d_bitdepth_minus1",
          asps.asps_geometry_3d_bitdepth_minus1)
        P(f"{pre}.geometry_2d_bitdepth_minus1",
          asps.asps_geometry_2d_bitdepth_minus1)
        P(f"{pre}.log2_max_afoc_lsb_minus4",
          asps.asps_log2_max_atlas_frame_order_cnt_lsb_minus4)
        P(f"{pre}.max_dec_frame_buffering_minus1",
          asps.asps_max_dec_atlas_frame_buffering_minus1)
        P(f"{pre}.long_term_ref_flag",
          int(asps.asps_long_term_ref_atlas_frames_flag))
        P(f"{pre}.num_ref_lists", len(asps.ref_list_structs))
        for r, rls in enumerate(asps.ref_list_structs):
            P(f"{pre}.rls{r}.num_ref_entries", rls.num_ref_entries)
        P(f"{pre}.use_eight_orientations",
          int(asps.asps_use_eight_orientations_flag))
        P(f"{pre}.extended_projection",
          int(asps.asps_extended_projection_enabled_flag))
        P(f"{pre}.max_number_projections_minus1",
          asps.asps_max_number_projections_minus1)
        P(f"{pre}.normal_axis_limits_quantization",
          int(asps.asps_normal_axis_limits_quantization_enabled_flag))
        P(f"{pre}.normal_axis_max_delta_value",
          int(asps.asps_normal_axis_max_delta_value_enabled_flag))
        P(f"{pre}.patch_precedence_order",
          int(asps.asps_patch_precedence_order_flag))
        P(f"{pre}.log2_patch_packing_block_size",
          asps.asps_log2_patch_packing_block_size)
        P(f"{pre}.patch_size_quantizer_present",
          int(asps.asps_patch_size_quantizer_present_flag))
        P(f"{pre}.map_count_minus1", asps.asps_map_count_minus1)
        P(f"{pre}.pixel_deinterleaving",
          int(asps.asps_pixel_deinterleaving_flag))
        P(f"{pre}.eom_patch_enabled", int(asps.asps_eom_patch_enabled_flag))
        if asps.asps_eom_patch_enabled_flag and asps.asps_map_count_minus1 == 0:
            P(f"{pre}.eom_fix_bit_count_minus1",
              asps.asps_eom_fix_bit_count_minus1)
        P(f"{pre}.raw_patch_enabled", int(asps.asps_raw_patch_enabled_flag))
        P(f"{pre}.auxiliary_video_enabled",
          int(asps.asps_auxiliary_video_enabled_flag))
        P(f"{pre}.plr_enabled", int(asps.asps_plr_enabled_flag))
        if asps.asps_plr_enabled_flag:
            for m in range(asps.asps_map_count_minus1 + 1):
                pp = f"{pre}.plri{m}"
                enabled = asps.plri_map_enabled(m)
                P(f"{pp}.map_enabled", int(enabled))
                if not enabled:
                    continue
                P(f"{pp}.number_of_modes_minus1",
                  asps.asps_plr_number_of_modes_minus1)
                P(f"{pp}.block_threshold_per_patch_minus1",
                  asps.plri_block_threshold_per_patch_minus1)
                for k in range(asps.asps_plr_number_of_modes_minus1):
                    mp = f"{pp}.mode{k}"
                    P(f"{mp}.interpolate", int(asps.plri_interpolate_flag[k]))
                    P(f"{mp}.filling", int(asps.plri_filling_flag[k]))
                    P(f"{mp}.minimum_depth", asps.plri_minimum_depth[k])
                    P(f"{mp}.neighbour_minus1", asps.plri_neighbour_minus1[k])
        P(f"{pre}.vui_present", int(asps.asps_vui_parameters_present_flag))
        if asps.asps_vui_parameters_present_flag:
            _flatten_vui(fields, f"{pre}.vui", asps.vui_parameters)
        ext = bool(
            asps.asps_vpcc_extension_present_flag or asps.asps_extension_7bits
        )
        P(f"{pre}.extension_flag", int(ext))
        if ext:
            P(f"{pre}.vpcc_extension_flag",
              int(asps.asps_vpcc_extension_present_flag))
    for i, afps in enumerate(atlas.afps_list):
        pre = f"{g}.afps{i}"
        P(f"{pre}.id", afps.afps_atlas_frame_parameter_set_id)
        P(f"{pre}.asps_id", afps.afps_atlas_sequence_parameter_set_id)
        P(f"{pre}.num_ref_idx_default_active_minus1",
          afps.afps_num_ref_idx_default_active_minus1)
        P(f"{pre}.additional_lt_afoc_lsb_len",
          afps.afps_additional_lt_afoc_lsb_len)
        P(f"{pre}.lod_mode_enabled", int(afps.afps_lod_mode_enabled_flag))
        P(f"{pre}.raw_3d_offset_explicit_mode",
          int(afps.afps_raw_3d_offset_bit_count_explicit_mode_flag))
        P(f"{pre}.output_flag_present",
          int(afps.afps_output_flag_present_flag))
        afti = afps.atlas_frame_tile_information
        P(f"{pre}.afti.single_tile",
          int(afti.afti_single_tile_in_atlas_frame_flag))
        if not afti.afti_single_tile_in_atlas_frame_flag:
            P(f"{pre}.afti.uniform_partition_spacing",
              int(afti.afti_uniform_partition_spacing_flag))
            P(f"{pre}.afti.num_partition_columns_minus1",
              afti.afti_num_partition_columns_minus1)
            P(f"{pre}.afti.num_partition_rows_minus1",
              afti.afti_num_partition_rows_minus1)
            if afti.afti_uniform_partition_spacing_flag:
                P(f"{pre}.afti.partition_cols_width_minus1",
                  afti.afti_partition_cols_width_minus1)
                P(f"{pre}.afti.partition_rows_height_minus1",
                  afti.afti_partition_rows_height_minus1)
            else:
                for c in range(afti.afti_num_partition_columns_minus1):
                    P(f"{pre}.afti.col{c}.width_minus1",
                      afti.afti_partition_column_widths_minus1[c])
                for r in range(afti.afti_num_partition_rows_minus1):
                    P(f"{pre}.afti.row{r}.height_minus1",
                      afti.afti_partition_row_heights_minus1[r])
            P(f"{pre}.afti.single_partition_per_tile",
              int(afti.afti_single_partition_per_tile_flag))
            P(f"{pre}.afti.num_tiles_minus1",
              afti.afti_num_tiles_in_atlas_frame_minus1)
            P(f"{pre}.afti.signalled_tile_id",
              int(afti.afti_signalled_tile_id_flag))
    for t, atl in enumerate(atlas.atlas_tile_layers):
        _flatten_atl(fields, f"{g}.atl{t}", atlas, atl)
    # SEI payload types: refparse attaches prefix SEIs to the first ATL
    for i, sei in enumerate(atlas.seis_prefix):
        P(f"{g}.atl0.sei_prefix{i}.type", int(sei.payload_type))
    # video sub-stream inventory (order matches the reference's V3C unit
    # decode order: OVD, GVD..., AVD...)
    sizes = [len(vb.data) for vb in _ordered_videos(atlas)]
    for v, size in enumerate(sizes):
        P(f"{g}.video{v}.size", size)


def _ordered_videos(atlas):
    from ..utils.enums import VideoType

    order = [
        VideoType.OCCUPANCY,
        VideoType.GEOMETRY,
        VideoType.GEOMETRY_D0,
        VideoType.GEOMETRY_D1,
        VideoType.GEOMETRY_RAW,
        VideoType.ATTRIBUTE,
        VideoType.ATTRIBUTE_T0,
        VideoType.ATTRIBUTE_T1,
        VideoType.ATTRIBUTE_RAW,
        VideoType.ATTRIBUTE_REFL,
    ]
    out = []
    for vt in order:
        if vt in atlas.video_bitstreams:
            out.append(atlas.video_bitstreams[vt])
    for key in sorted(atlas.attr_ext):
        out.append(atlas.attr_ext[key])
    return out


def _flatten_atl(fields: dict[str, int], pre: str, atlas, atl) -> None:
    P = fields.__setitem__
    ath = atl.header
    afps = atlas.afps(ath.ath_atlas_frame_parameter_set_id)
    asps = atlas.asps(afps.afps_atlas_sequence_parameter_set_id)
    P(f"{pre}.afps_id", ath.ath_atlas_frame_parameter_set_id)
    P(f"{pre}.id", ath.ath_id)
    P(f"{pre}.type", int(ath.ath_type))
    P(f"{pre}.afoc_lsb", ath.ath_atlas_frm_order_cnt_lsb)
    P(f"{pre}.pos_min_d_quantizer", ath.ath_pos_min_d_quantizer)
    P(f"{pre}.pos_delta_max_d_quantizer", ath.ath_pos_delta_max_d_quantizer)
    P(f"{pre}.patch_size_x_quantizer", ath.ath_patch_size_x_info_quantizer)
    P(f"{pre}.patch_size_y_quantizer", ath.ath_patch_size_y_info_quantizer)
    P(f"{pre}.raw_3d_offset_bit_count_minus1",
      _u8(ath.ath_raw_3d_offset_axis_bit_count_minus1))
    P(f"{pre}.ref_list_sps_flag", int(ath.ath_ref_atlas_frame_list_asps_flag))
    is_p = ath.ath_type == AtlasTileType.P_TILE
    P(f"{pre}.patch_count", len(atl.data_unit.patches))
    for p, pid in enumerate(atl.data_unit.patches):
        pp = f"{pre}.patch{p}"
        P(f"{pp}.mode", pid.patch_mode)
        u = pid.data
        if isinstance(u, PatchDataUnit):
            P(f"{pp}.pos_x", u.pdu_2d_pos_x)
            P(f"{pp}.pos_y", u.pdu_2d_pos_y)
            P(f"{pp}.size_x_minus1", u.pdu_2d_size_x_minus1)
            P(f"{pp}.size_y_minus1", u.pdu_2d_size_y_minus1)
            P(f"{pp}.offset_u", u.pdu_3d_offset_u)
            P(f"{pp}.offset_v", u.pdu_3d_offset_v)
            P(f"{pp}.offset_d", u.pdu_3d_offset_d)
            P(f"{pp}.range_d", u.pdu_3d_range_d
              if asps.asps_normal_axis_max_delta_value_enabled_flag else 0)
            P(f"{pp}.projection_id", u.pdu_projection_id)
            P(f"{pp}.orientation", u.pdu_orientation_index)
            P(f"{pp}.lod_enable", int(u.pdu_lod_enabled_flag)
              if afps.afps_lod_mode_enabled_flag else 0)
            if asps.asps_plr_enabled_flag:
                _flatten_plrd(fields, f"{pp}.plrd", atlas, asps, afps, ath, u)
        elif isinstance(u, InterPatchDataUnit):
            P(f"{pp}.ref_index", u.ipdu_ref_index)
            P(f"{pp}.ref_patch_index", u.ipdu_patch_index)
            P(f"{pp}.pos_x", u.ipdu_2d_pos_x)
            P(f"{pp}.pos_y", u.ipdu_2d_pos_y)
            P(f"{pp}.delta_size_x", u.ipdu_2d_delta_size_x)
            P(f"{pp}.delta_size_y", u.ipdu_2d_delta_size_y)
            P(f"{pp}.offset_u", u.ipdu_3d_offset_u)
            P(f"{pp}.offset_v", u.ipdu_3d_offset_v)
            P(f"{pp}.offset_d", u.ipdu_3d_offset_d)
            P(f"{pp}.range_d", u.ipdu_3d_range_d
              if asps.asps_normal_axis_max_delta_value_enabled_flag else 0)
            if asps.asps_plr_enabled_flag:
                _flatten_plrd(fields, f"{pp}.plrd", atlas, asps, afps, ath, u)
        elif isinstance(u, RawPatchDataUnit):
            aux = asps.asps_auxiliary_video_enabled_flag
            P(f"{pp}.in_aux_video",
              int(u.rpdu_patch_in_auxiliary_video_flag) if aux else 0)
            P(f"{pp}.pos_x", u.rpdu_2d_pos_x)
            P(f"{pp}.pos_y", u.rpdu_2d_pos_y)
            P(f"{pp}.size_x_minus1", u.rpdu_2d_size_x_minus1)
            P(f"{pp}.size_y_minus1", u.rpdu_2d_size_y_minus1)
            P(f"{pp}.offset_u", u.rpdu_3d_offset_u)
            P(f"{pp}.offset_v", u.rpdu_3d_offset_v)
            P(f"{pp}.offset_d", u.rpdu_3d_offset_d)
            P(f"{pp}.points_minus1", u.rpdu_points_minus1)
        elif isinstance(u, EOMPatchDataUnit):
            aux = asps.asps_auxiliary_video_enabled_flag
            P(f"{pp}.in_aux_video",
              int(u.epdu_patch_in_auxiliary_video_flag) if aux else 0)
            P(f"{pp}.pos_x", u.epdu_2d_pos_x)
            P(f"{pp}.pos_y", u.epdu_2d_pos_y)
            P(f"{pp}.size_x_minus1", u.epdu_2d_size_x_minus1)
            P(f"{pp}.size_y_minus1", u.epdu_2d_size_y_minus1)
            P(f"{pp}.patch_count_minus1", u.epdu_associated_patches_count_minus1)
            for a in range(u.epdu_associated_patches_count_minus1 + 1):
                P(f"{pp}.assoc{a}.idx", u.epdu_associated_patch_idx[a])
                P(f"{pp}.assoc{a}.points", u.epdu_points[a])
        elif isinstance(u, MergePatchDataUnit):
            P(f"{pp}.ref_index", u.mpdu_ref_index)
            P(f"{pp}.override_2d", int(u.mpdu_override_2d_params_flag))
            P(f"{pp}.override_3d", int(u.mpdu_override_3d_params_flag))
            if u.mpdu_override_2d_params_flag:
                P(f"{pp}.pos_x", u.mpdu_2d_pos_x)
                P(f"{pp}.pos_y", u.mpdu_2d_pos_y)
                P(f"{pp}.delta_size_x", u.mpdu_2d_delta_size_x)
                P(f"{pp}.delta_size_y", u.mpdu_2d_delta_size_y)
            elif u.mpdu_override_3d_params_flag:
                P(f"{pp}.offset_u", u.mpdu_3d_offset_u)
                P(f"{pp}.offset_v", u.mpdu_3d_offset_v)
                P(f"{pp}.offset_d", u.mpdu_3d_offset_d)
                P(f"{pp}.override_plr", int(u.mpdu_override_plr_flag))
            if asps.asps_plr_enabled_flag and u.plrd_bu > 0:
                _flatten_plrd(fields, f"{pp}.plrd", atlas, asps, afps, ath, u)
    del is_p


def _flatten_plrd(fields, pp, atlas, asps, afps, ath, u) -> None:
    from ..bitstream.syntax import PatchDataUnit, _plrd_dims

    P = fields.__setitem__
    if u.plrd_bu > 0:
        # parsed units carry the derived block-map dims (intra from coded
        # sizes, inter/merge from the ref patch / running prev size —
        # PCCBitstreamReader.cpp:1067-1218)
        bu, bv = u.plrd_bu, u.plrd_bv
    else:
        assert isinstance(u, PatchDataUnit)
        ctx = atlas.syntax_context(asps, afps, 1, ath)
        bu, bv = _plrd_dims(ctx, u.pdu_2d_size_x_minus1,
                            u.pdu_2d_size_y_minus1)
    P(f"{pp}.map_width", bu)
    P(f"{pp}.map_height", bv)
    if u.plrd_block_modes is not None:
        P(f"{pp}.level", 0)
        for b, m in enumerate(u.plrd_block_modes):
            P(f"{pp}.block{b}.present", int(m > 0))
            if m > 0:
                P(f"{pp}.block{b}.mode_minus1", m - 1)
    else:
        P(f"{pp}.level", 1)
        P(f"{pp}.present", int(u.plrd_mode > 0))
        if u.plrd_mode > 0:
            P(f"{pp}.mode_minus1", u.plrd_mode - 1)


def _flatten_vui(fields, pp, vui) -> None:
    """Mirror of refparse.cpp's VUI dump key space."""
    P = fields.__setitem__
    P(f"{pp}.timing_info", int(vui.vui_timing_info_present_flag))
    if vui.vui_timing_info_present_flag:
        P(f"{pp}.num_units_in_tick", vui.vui_num_units_in_tick)
        P(f"{pp}.time_scale", vui.vui_time_scale)
        P(f"{pp}.poc_proportional",
          int(vui.vui_poc_proportional_to_timing_flag))
        if vui.vui_poc_proportional_to_timing_flag:
            P(f"{pp}.num_ticks_poc_diff_one_minus1",
              vui.vui_num_ticks_poc_diff_one_minus1)
        P(f"{pp}.hrd_present", int(vui.vui_hrd_parameters_present_flag))
        if vui.vui_hrd_parameters_present_flag:
            hp = vui.hrd_parameters
            P(f"{pp}.hrd.nal_present",
              int(hp.hrd_nal_parameters_present_flag))
            P(f"{pp}.hrd.acl_present",
              int(hp.hrd_acl_parameters_present_flag))
            if (hp.hrd_nal_parameters_present_flag
                    or hp.hrd_acl_parameters_present_flag):
                P(f"{pp}.hrd.bit_rate_scale", hp.hrd_bit_rate_scale)
                P(f"{pp}.hrd.cab_size_scale", hp.hrd_cab_size_scale)
    P(f"{pp}.tile_restrictions",
      int(vui.vui_tile_restrictions_present_flag))
    if vui.vui_tile_restrictions_present_flag:
        P(f"{pp}.fixed_atlas_tile",
          int(vui.vui_fixed_atlas_tile_structure_flag))
        P(f"{pp}.fixed_video_tile",
          int(vui.vui_fixed_video_tile_structure_flag))
        P(f"{pp}.constrained_tiles_idc",
          vui.vui_constrained_tiles_across_v3c_components_idc)
        P(f"{pp}.max_num_tiles_minus1",
          vui.vui_max_num_tiles_per_atlas_minus1)
    P(f"{pp}.csp_present",
      int(vui.vui_coordinate_system_parameters_present_flag))
    if vui.vui_coordinate_system_parameters_present_flag:
        csp = vui.coordinate_system_parameters
        P(f"{pp}.csp.forward_axis", csp.csp_forward_axis)
        P(f"{pp}.csp.delta_left_axis", csp.csp_delta_left_axis)
        P(f"{pp}.csp.forward_sign", csp.csp_forward_sign)
        P(f"{pp}.csp.left_sign", csp.csp_left_sign)
        P(f"{pp}.csp.up_sign", csp.csp_up_sign)
    P(f"{pp}.unit_in_metres", int(vui.vui_unit_in_metres_flag))
    P(f"{pp}.display_box_present",
      int(vui.vui_display_box_info_present_flag))
    if vui.vui_display_box_info_present_flag:
        for d in range(3):
            P(f"{pp}.display_box_origin{d}", vui.vui_display_box_origin[d])
            P(f"{pp}.display_box_size{d}", vui.vui_display_box_size[d])
        P(f"{pp}.anchor_present", int(vui.vui_anchor_point_present_flag))
        if vui.vui_anchor_point_present_flag:
            for d in range(3):
                P(f"{pp}.anchor_point{d}", vui.vui_anchor_point[d])


def compare(ref: dict[str, int], ours: dict[str, int],
            skip_prefixes: tuple[str, ...] = ()) -> list[str]:
    """Return a list of human-readable mismatches (empty == gate passes).

    Every key OUR flattener produces must exist with the same value in the
    reference dump, and vice versa for the key families we flatten."""
    problems = []
    for k, v in sorted(ours.items()):
        if any(k.startswith(p) for p in skip_prefixes):
            continue
        if k not in ref:
            problems.append(f"missing in reference parse: {k}={v}")
        elif ref[k] != v:
            problems.append(f"{k}: ours={v} reference={ref[k]}")
    for k, v in sorted(ref.items()):
        if any(k.startswith(p) for p in skip_prefixes):
            continue
        if k not in ours:
            problems.append(f"reference saw extra field: {k}={v}")
    return problems
