"""Serialize a Context (HLS + video sub-bitstreams) into V3C units / a file.

Parity with PCCBitstreamWriter (SURVEY.md §2.2): the mirror image of
reader.py.  ``encode`` produces the unit list for one GOF; ``write`` frames
unit lists into a sample-stream file (multiple GOFs concatenate their units,
each GOF led by its VPS, as in PccAppTranscoder.cpp:336-349).
"""

from __future__ import annotations

from ..utils.enums import AtlasTileType, NalUnitType, V3CUnitType, VideoType
from ..utils.timing import spanned
from .bitio import BitstreamStat, BitWriter
from .hls import AtlasHLS, Context
from .nal import NalUnit, write_sample_stream_nal
from .sei import write_sei_rbsp
from .syntax import AtlasTileLayerRbsp
from .v3c import V3CUnit, V3CUnitHeader, write_sample_stream_v3c

# video-plane unit layout: (type, unit, map_index, aux, attribute_index)
_VIDEO_UNIT_MAP = [
    (VideoType.OCCUPANCY, V3CUnitType.V3C_OVD, 0, False, 0),
    (VideoType.GEOMETRY, V3CUnitType.V3C_GVD, 0, False, 0),
    (VideoType.GEOMETRY_D0, V3CUnitType.V3C_GVD, 0, False, 0),
    (VideoType.GEOMETRY_D1, V3CUnitType.V3C_GVD, 1, False, 0),
    (VideoType.GEOMETRY_RAW, V3CUnitType.V3C_GVD, 0, True, 0),
    (VideoType.ATTRIBUTE, V3CUnitType.V3C_AVD, 0, False, 0),
    (VideoType.ATTRIBUTE_T0, V3CUnitType.V3C_AVD, 0, False, 0),
    (VideoType.ATTRIBUTE_T1, V3CUnitType.V3C_AVD, 1, False, 0),
    (VideoType.ATTRIBUTE_RAW, V3CUnitType.V3C_AVD, 0, True, 0),
    (VideoType.ATTRIBUTE_REFL, V3CUnitType.V3C_AVD, 0, False, 1),
]


class V3CWriter:
    def __init__(self, stat: BitstreamStat | None = None) -> None:
        self.stat = stat or BitstreamStat()

    # ------------------------------------------------------------------
    @spanned("v3c_write")
    def encode(self, context: Context) -> list[V3CUnit]:
        units: list[V3CUnit] = []
        vps = context.vps
        bw = BitWriter()
        vps.write(bw)
        units.append(
            V3CUnit(V3CUnitHeader(unit_type=V3CUnitType.V3C_VPS), bw.data())
        )
        for atlas in context.atlases:
            units.append(self._atlas_data_unit(context, atlas))
            units.extend(self._video_units(context, atlas))
        for u in units:
            self.stat.add(u.header.unit_type, len(u.payload) + 4)
        return units

    @spanned("v3c_write")
    def write(self, units: list[V3CUnit], forced_precision: int = 0) -> bytes:
        return write_sample_stream_v3c(units, forced_precision)

    def write_file(
        self, units: list[V3CUnit], path: str, forced_precision: int = 0
    ) -> int:
        data = self.write(units, forced_precision)
        with open(path, "wb") as f:
            f.write(data)
        return len(data)

    # ------------------------------------------------------------------
    def _atlas_data_unit(self, context: Context, atlas: AtlasHLS) -> V3CUnit:
        nals: list[NalUnit] = []
        for asps in atlas.asps_list:
            bw = BitWriter()
            asps.write(bw)
            nals.append(NalUnit(NalUnitType.NAL_ASPS, payload=bw.data()))
        for afps in atlas.afps_list:
            bw = BitWriter()
            afps.write(
                bw, atlas.asps(afps.afps_atlas_sequence_parameter_set_id)
            )
            nals.append(NalUnit(NalUnitType.NAL_AFPS, payload=bw.data()))
        # one SEI message per NAL — the reference reader parses exactly one
        # sei_message per sei_rbsp (PCCBitstreamReader.cpp:724-732)
        for sei in atlas.seis_prefix:
            bw = BitWriter()
            write_sei_rbsp(bw, [sei])
            nals.append(NalUnit(NalUnitType.NAL_PREFIX_ESEI, payload=bw.data()))
        for i, atl in enumerate(atlas.atlas_tile_layers):
            nal_type = (
                NalUnitType.NAL_IDR_N_LP if atl.afoc == 0 else NalUnitType.NAL_TRAIL_R
            )
            nals.append(
                NalUnit(nal_type, payload=self._atl_payload(
                    atlas, atl, nal_type,
                    prev_atls=atlas.atlas_tile_layers[:i],
                ))
            )
        for sei in atlas.seis_suffix:
            bw = BitWriter()
            write_sei_rbsp(bw, [sei])
            nals.append(NalUnit(NalUnitType.NAL_SUFFIX_ESEI, payload=bw.data()))
        payload = write_sample_stream_nal(nals)
        header = V3CUnitHeader(
            unit_type=V3CUnitType.V3C_AD,
            vuh_v3c_parameter_set_id=context.vps.vps_v3c_parameter_set_id,
            vuh_atlas_id=atlas.atlas_id,
        )
        return V3CUnit(header, payload)

    def _atl_payload(
        self, atlas: AtlasHLS, atl: AtlasTileLayerRbsp,
        nal_type: NalUnitType, prev_atls: list[AtlasTileLayerRbsp] = (),
    ) -> bytes:
        afps = atlas.afps(atl.header.ath_atlas_frame_parameter_set_id)
        asps = atlas.asps(afps.afps_atlas_sequence_parameter_set_id)
        bw = BitWriter()
        is_irap = (
            NalUnitType.NAL_BLA_W_LP
            <= nal_type
            <= NalUnitType.NAL_RSV_IRAP_ACL_29
        )
        atl.header.write(bw, asps, afps, is_irap)
        nri = atlas.num_ref_idx_active(atl.header, asps, afps)
        ctx = atlas.syntax_context(asps, afps, nri, atl.header)
        if asps.asps_plr_enabled_flag:
            # mirror of reader.py's previous same-tile ATL lookup, so a
            # parsed PLR+inter stream re-serializes with identical block
            # map sizing
            for prev in reversed(prev_atls):
                if prev.header.ath_id == atl.header.ath_id:
                    ctx.ref_patches = prev.data_unit.patches
                    break
        atl.data_unit.write(bw, atl.header.ath_type, ctx)
        return bw.data()

    def _video_units(self, context: Context, atlas: AtlasHLS) -> list[V3CUnit]:
        units = []
        vps_id = context.vps.vps_v3c_parameter_set_id
        for vtype, unit_type, map_index, aux, attr_idx in _VIDEO_UNIT_MAP:
            vb = atlas.video_bitstreams.get(vtype)
            if vb is None or len(vb) == 0:
                continue
            header = V3CUnitHeader(
                unit_type=unit_type,
                vuh_v3c_parameter_set_id=vps_id,
                vuh_atlas_id=atlas.atlas_id,
                vuh_map_index=map_index,
                vuh_auxiliary_video_flag=aux,
                vuh_attribute_index=attr_idx,
            )
            units.append(V3CUnit(header, vb.data))
            self.stat.add_video(vb.name, len(vb.data))
        # dimension-partitioned / extra attribute sub-streams (the mirror of
        # reader.py's attr_ext routing): the (attribute, partition, map)
        # key IS the vuh header field triple
        for (attr_idx, part_idx, map_idx), vb in sorted(
            atlas.attr_ext.items()
        ):
            if len(vb) == 0:
                continue
            header = V3CUnitHeader(
                unit_type=V3CUnitType.V3C_AVD,
                vuh_v3c_parameter_set_id=vps_id,
                vuh_atlas_id=atlas.atlas_id,
                vuh_attribute_index=attr_idx,
                vuh_attribute_partition_index=part_idx,
                vuh_map_index=map_idx,
            )
            units.append(V3CUnit(header, vb.data))
            self.stat.add_video(
                f"attr[{attr_idx}][{part_idx}][{map_idx}]", len(vb.data)
            )
        return units
