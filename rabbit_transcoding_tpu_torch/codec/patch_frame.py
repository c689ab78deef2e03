"""Atlas-tile-layer syntax -> decoded Patch lists.

The single shared implementation of ``createPatchFrameDataStructure``: the
reference duplicates this logic in the decoder (PCCDecoder.cpp:790-869) and
the transcoder (PCCTranscoder.cpp:1062-1141); here both pipelines call this
module.  Handles intra / inter / merge / skip patch modes with the spec's
running-predictor reference indexing, plus raw/EOM patch bookkeeping.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.hls import AtlasHLS
from ..bitstream.syntax import (
    AtlasTileLayerRbsp,
    EOMPatchDataUnit,
    InterPatchDataUnit,
    MergePatchDataUnit,
    PatchDataUnit,
    RawPatchDataUnit,
    SkipPatchDataUnit,
)
from ..core.patch import Patch
from ..utils.enums import AtlasTileType, PatchOrientation, PatchType


# projection id (= the reference's viewId, PCCPatch::setViewId,
# PCCPatch.cpp:111-138) -> (normal, tangent, bitangent, projection_mode,
# rotation_axis).
#
# Ids 0..5: the six canonical V-PCC projection planes (min-X/Y/Z mode 0,
# max planes mode 1).  Ids 6..17 (asps_extended_projection): the 45-degree
# planes about Y (6..9), X (10..13) and Z (14..17); their axes live in the
# exact-integer rotated spaces (see encoder.segment.rotate45) and
# rotation_axis 1/2/3 flags which inverse rotation applies at
# reconstruction (the reference's axisOfAdditionalPlane numbering).
_VIEW_TABLE: tuple[tuple[int, int, int, int, int], ...] = (
    (0, 2, 1, 0, 0), (1, 2, 0, 0, 0), (2, 0, 1, 0, 0),   # 0-2  axial, mode 0
    (0, 2, 1, 1, 0), (1, 2, 0, 1, 0), (2, 0, 1, 1, 0),   # 3-5  axial, mode 1
    (0, 2, 1, 0, 1), (2, 0, 1, 0, 1),                    # 6-7  Y-rot, mode 0
    (0, 2, 1, 1, 1), (2, 0, 1, 1, 1),                    # 8-9  Y-rot, mode 1
    (2, 0, 1, 0, 2), (1, 2, 0, 0, 2),                    # 10-11 X-rot, mode 0
    (2, 0, 1, 1, 2), (1, 2, 0, 1, 2),                    # 12-13 X-rot, mode 1
    (1, 2, 0, 0, 3), (0, 2, 1, 0, 3),                    # 14-15 Z-rot, mode 0
    (1, 2, 0, 1, 3), (0, 2, 1, 1, 3),                    # 16-17 Z-rot, mode 1
)


def _axes_of(projection_id: int) -> tuple[int, int, int, int, int]:
    return _VIEW_TABLE[projection_id]


def projection_id_of(
    normal_axis: int, projection_mode: int, rotation_axis: int = 0
) -> int:
    m = 2 if projection_mode else 0
    if rotation_axis == 1:   # about Y: normals x'(6) / z'(7)
        return 6 + (0 if normal_axis == 0 else 1) + m
    if rotation_axis == 2:   # about X: normals z'(10) / y'(11)
        return 10 + (0 if normal_axis == 2 else 1) + m
    if rotation_axis == 3:   # about Z: normals y'(14) / x'(15)
        return 14 + (0 if normal_axis == 1 else 1) + m
    return normal_axis + (3 if projection_mode else 0)


def decode_patch_frames(atlas: AtlasHLS) -> list[list[Patch]]:
    """Decode every atlas tile layer into per-frame patch lists.

    Tile layers sharing an ath_atlas_frm_order_cnt_lsb belong to one frame
    (multi-tile atlases emit one ATL per tile per frame); patch positions are
    shifted by each tile's AFTI origin so the result is atlas-global."""
    # group ATLs by coded frame order count, preserving decode order
    frame_keys: list[int] = []
    groups: dict[int, list] = {}
    for atl in atlas.atlas_tile_layers:
        key = atl.header.ath_atlas_frm_order_cnt_lsb
        if key not in groups:
            groups[key] = []
            frame_keys.append(key)
        groups[key].append(atl)

    frames: list[list[Patch]] = []
    prev: dict[int, list[Patch]] = {}  # per-tile reference lists
    for key in frame_keys:
        frame_patches: list[Patch] = []
        for atl in groups[key]:
            tile_id = atl.header.ath_id
            afps = atlas.afps(atl.header.ath_atlas_frame_parameter_set_id)
            origin = atlas.tile_origin(afps, tile_id)
            patches = decode_tile_patches(
                atlas, atl, prev.get(tile_id, []), origin
            )
            for p in patches:
                p.tile_index = tile_id
            prev[tile_id] = patches
            base = len(frame_patches)
            for p in patches:
                p.index = base + p.index
            frame_patches.extend(patches)
        frames.append(frame_patches)
    return frames


def decode_tile_patches(
    atlas: AtlasHLS,
    atl: AtlasTileLayerRbsp,
    ref_patches: list[Patch],
    tile_origin: tuple[int, int] = (0, 0),
) -> list[Patch]:
    afps = atlas.afps(atl.header.ath_atlas_frame_parameter_set_id)
    asps = atlas.asps(afps.afps_atlas_sequence_parameter_set_id)
    ppbs = 1 << asps.asps_log2_patch_packing_block_size
    # patch-size quantizer (23090-5: PatchSizeXQuantizer): when the ASPS
    # signals explicit quantizers, sizes are coded in (1<<q) pixel units —
    # q=0 gives exact pixel sizes, which the placement-orientation inverse
    # mappings require; otherwise sizes are in packing-block units.
    if asps.asps_patch_size_quantizer_present_flag:
        qx = 1 << atl.header.ath_patch_size_x_info_quantizer
        qy = 1 << atl.header.ath_patch_size_y_info_quantizer
    else:
        qx = qy = ppbs
    min_d_shift = atl.header.ath_pos_min_d_quantizer
    # quantDD range shift (coded only when the ASPS enables max-delta
    # quantization; identity otherwise)
    range_d_shift = (
        atl.header.ath_pos_delta_max_d_quantizer
        if asps.asps_normal_axis_max_delta_value_enabled_flag
        else 0
    )
    patches: list[Patch] = []
    pred_idx = 0  # running reference-patch predictor (spec: RefIdx accumulation)

    if atl.header.ath_type == AtlasTileType.SKIP_TILE:
        for i, ref in enumerate(ref_patches):
            p = _copy_patch(ref, i)
            p.patch_type = PatchType.SKIP
            patches.append(p)
        return patches

    for pid in atl.data_unit.patches:
        du = pid.data
        idx = len(patches)
        if isinstance(du, PatchDataUnit):
            # rotated-space coords need one extra bit; offset = half the
            # rotated range (2^(geom3d bitdepth - 1))
            rot_off = 1 << asps.asps_geometry_3d_bitdepth_minus1
            p = _intra_patch(du, idx, ppbs, qx, qy, min_d_shift,
                             rot_off, range_d_shift)
            # intra positions are tile-relative; refs of inter/merge/skip
            # patches are already atlas-global, so only intra shifts
            p.u0 += tile_origin[0] // ppbs
            p.v0 += tile_origin[1] // ppbs
            patches.append(p)
        elif isinstance(du, InterPatchDataUnit):
            ref_idx = pred_idx + du.ipdu_patch_index
            ref = ref_patches[ref_idx]
            pred_idx = ref_idx + 1
            p = _copy_patch(ref, idx)
            p.patch_type = PatchType.INTER
            p.best_match_idx = ref_idx
            p.u0 = ref.u0 + du.ipdu_2d_pos_x
            p.v0 = ref.v0 + du.ipdu_2d_pos_y
            p.size_u = ref.size_u + du.ipdu_2d_delta_size_x * qx
            p.size_v = ref.size_v + du.ipdu_2d_delta_size_y * qy
            p.size_u0 = (p.size_u + ppbs - 1) // ppbs
            p.size_v0 = (p.size_v + ppbs - 1) // ppbs
            p.u1 = ref.u1 + du.ipdu_3d_offset_u
            p.v1 = ref.v1 + du.ipdu_3d_offset_v
            p.d1 = ref.d1 + (du.ipdu_3d_offset_d << min_d_shift)
            p.size_d = max(
                0, ref.size_d + (du.ipdu_3d_range_d << range_d_shift)
            )
            _apply_unit_plr(p, du)
            patches.append(p)
        elif isinstance(du, MergePatchDataUnit):
            ref_idx = pred_idx
            ref = ref_patches[ref_idx]
            pred_idx = ref_idx + 1
            p = _copy_patch(ref, idx)
            p.patch_type = PatchType.MERGE
            p.best_match_idx = ref_idx
            if du.mpdu_override_2d_params_flag:
                p.u0 = ref.u0 + du.mpdu_2d_pos_x
                p.v0 = ref.v0 + du.mpdu_2d_pos_y
                p.size_u = ref.size_u + du.mpdu_2d_delta_size_x * qx
                p.size_v = ref.size_v + du.mpdu_2d_delta_size_y * qy
                p.size_u0 = (p.size_u + ppbs - 1) // ppbs
                p.size_v0 = (p.size_v + ppbs - 1) // ppbs
            elif du.mpdu_override_3d_params_flag:
                p.u1 = ref.u1 + du.mpdu_3d_offset_u
                p.v1 = ref.v1 + du.mpdu_3d_offset_v
                p.d1 = ref.d1 + (du.mpdu_3d_offset_d << min_d_shift)
                p.size_d = max(
                    0,
                    ref.size_d + (du.mpdu_3d_range_d << range_d_shift),
                )
            _apply_unit_plr(p, du)
            patches.append(p)
        elif isinstance(du, SkipPatchDataUnit):
            ref_idx = pred_idx
            ref = ref_patches[ref_idx]
            pred_idx = ref_idx + 1
            p = _copy_patch(ref, idx)
            p.patch_type = PatchType.SKIP
            p.best_match_idx = ref_idx
            patches.append(p)
        elif isinstance(du, (RawPatchDataUnit, EOMPatchDataUnit)):
            # raw/EOM patches carry aux-video point data; reconstruction of
            # these is handled by the raw-points path (not patch projection)
            continue
        else:
            raise ValueError(f"unknown patch data unit {type(du)}")
    return patches


def _intra_patch(
    du: PatchDataUnit, idx: int, ppbs: int, qx: int, qy: int, min_d_shift: int,
    rot_offset: int = 1024, range_d_shift: int = 0,
) -> Patch:
    normal, tangent, bitangent, mode, rot = _axes_of(du.pdu_projection_id)
    size_u = (du.pdu_2d_size_x_minus1 + 1) * qx
    size_v = (du.pdu_2d_size_y_minus1 + 1) * qy
    blk = None
    if du.plrd_block_modes is not None:
        bu = (size_u + ppbs - 1) // ppbs
        bv = (size_v + ppbs - 1) // ppbs
        blk = np.asarray(du.plrd_block_modes, np.uint8).reshape(bv, bu)
    return Patch(
        index=idx,
        u0=du.pdu_2d_pos_x,
        v0=du.pdu_2d_pos_y,
        size_u0=(size_u + ppbs - 1) // ppbs,
        size_v0=(size_v + ppbs - 1) // ppbs,
        size_u=size_u,
        size_v=size_v,
        u1=du.pdu_3d_offset_u,
        v1=du.pdu_3d_offset_v,
        d1=du.pdu_3d_offset_d << min_d_shift,
        # quantDD units (sizeD = quantDD*minLevel - 1, PCCDecoder.cpp:953);
        # identity when the shift is 0
        size_d=(
            ((du.pdu_3d_range_d << range_d_shift) - 1
             if du.pdu_3d_range_d else 0)
            if range_d_shift else du.pdu_3d_range_d
        ),
        normal_axis=normal,
        tangent_axis=tangent,
        bitangent_axis=bitangent,
        projection_mode=mode,
        orientation=PatchOrientation(du.pdu_orientation_index),
        occupancy_resolution=ppbs,
        lod_x=du.pdu_lod_scale_x_minus1 + 1 if du.pdu_lod_enabled_flag else 1,
        lod_y=du.pdu_lod_scale_y_idc + 1 if du.pdu_lod_enabled_flag else 1,
        patch_type=PatchType.INTRA,
        plr_mode=du.plrd_mode,
        plr_block_modes=blk,
        rotation_axis=rot,
        rot_offset=rot_offset,
    )


def _apply_unit_plr(p: Patch, du) -> None:
    """Inter/merge units that carry their own plrData (plrd_bu > 0)
    override the ref-copied PLR state with this frame's modes — matching
    the reference decoder, which takes each patch's PLR from its own unit
    (PCCDecoder.cpp setPointLocalReconstruction analog).  Units without
    plrData (PLR off, or merge without override) keep the copied ref
    modes."""
    if getattr(du, "plrd_bu", 0) <= 0:
        return
    p.plr_mode = du.plrd_mode
    p.plr_block_modes = (
        np.asarray(du.plrd_block_modes, np.uint8).reshape(
            du.plrd_bv, du.plrd_bu
        )
        if du.plrd_block_modes is not None
        else None
    )


def _copy_patch(ref: Patch, idx: int) -> Patch:
    import dataclasses

    p = dataclasses.replace(ref)
    p.index = idx
    return p
