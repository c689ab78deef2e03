"""Parse a V3C sample stream into a Context (HLS + video sub-bitstreams).

Parity with PCCBitstreamReader (SURVEY.md §2.2): ``read`` splits the file
into V3C units; ``decode`` consumes one GOF's units into a Context —
VPS -> parameter sets, AD -> ASPS/AFPS/SEI/ATL NALs, OVD/GVD/AVD -> video
sub-bitstream buffers.
"""

from __future__ import annotations

from ..utils.enums import NalUnitType, V3CUnitType, VideoType
from ..utils.timing import spanned
from .bitio import BitReader, BitstreamStat
from .hls import AtlasHLS, Context
from .nal import NalUnit, read_sample_stream_nal
from .sei import read_sei_rbsp
from .syntax import (
    AtlasFrameParameterSetRbsp,
    AtlasSequenceParameterSetRbsp,
    AtlasTileDataUnit,
    AtlasTileHeader,
    AtlasTileLayerRbsp,
    V3CParameterSet,
)
from .v3c import V3CUnit, read_sample_stream_v3c, split_gofs


class V3CReader:
    def __init__(self, stat: BitstreamStat | None = None) -> None:
        self.stat = stat or BitstreamStat()

    # ------------------------------------------------------------------
    @spanned("v3c_read")
    def read(self, data: bytes) -> list[list[V3CUnit]]:
        """File bytes -> list of GOFs (each a V3C unit list)."""
        if not data:
            raise ValueError("empty V3C stream (no sample-stream header)")
        units = read_sample_stream_v3c(data)
        for u in units:
            self.stat.add(u.header.unit_type, len(u.payload) + 4)
        return split_gofs(units)

    def read_file(self, path: str) -> list[list[V3CUnit]]:
        with open(path, "rb") as f:
            return self.read(f.read())

    # ------------------------------------------------------------------
    @spanned("v3c_read")
    def decode(self, units: list[V3CUnit]) -> Context:
        context = Context()
        for unit in units:
            t = unit.header.unit_type
            if t == V3CUnitType.V3C_VPS:
                vps = V3CParameterSet.read(BitReader(unit.payload))
                context.vps_list.append(vps)
                context.active_vps_id = vps.vps_v3c_parameter_set_id
            elif t == V3CUnitType.V3C_AD:
                self._decode_atlas_data(context, unit)
            elif t == V3CUnitType.V3C_OVD:
                atlas = context.atlas(unit.header.vuh_atlas_id)
                atlas.set_video_bitstream(
                    _vb(VideoType.OCCUPANCY, unit.payload)
                )
            elif t == V3CUnitType.V3C_GVD:
                atlas = context.atlas(unit.header.vuh_atlas_id)
                if unit.header.vuh_auxiliary_video_flag:
                    vtype = VideoType.GEOMETRY_RAW
                elif context.vps.atlas(0).vps_map_count_minus1 > 0 and (
                    context.vps.atlas(0).vps_multiple_map_streams_present_flag
                ):
                    vtype = (
                        VideoType.GEOMETRY_D0
                        if unit.header.vuh_map_index == 0
                        else VideoType.GEOMETRY_D1
                    )
                else:
                    vtype = VideoType.GEOMETRY
                atlas.set_video_bitstream(_vb(vtype, unit.payload))
            elif t == V3CUnitType.V3C_AVD:
                atlas = context.atlas(unit.header.vuh_atlas_id)
                h = unit.header
                if h.vuh_auxiliary_video_flag:
                    atlas.set_video_bitstream(
                        _vb(VideoType.ATTRIBUTE_RAW, unit.payload)
                    )
                elif h.vuh_attribute_partition_index > 0 or (
                    h.vuh_attribute_index > 1
                ):
                    # dimension-partitioned / extra attribute sub-streams
                    # route by their vuh header fields (the reference's
                    # per-partition decode, PCCDecoder.cpp:208-300)
                    atlas.attr_ext[(
                        h.vuh_attribute_index,
                        h.vuh_attribute_partition_index,
                        h.vuh_map_index,
                    )] = _vb(VideoType.ATTRIBUTE, unit.payload)
                elif h.vuh_attribute_index == 1:
                    atlas.set_video_bitstream(
                        _vb(VideoType.ATTRIBUTE_REFL, unit.payload)
                    )
                elif context.vps.atlas(0).vps_map_count_minus1 > 0 and (
                    context.vps.atlas(0).vps_multiple_map_streams_present_flag
                ):
                    vtype = (
                        VideoType.ATTRIBUTE_T0
                        if h.vuh_map_index == 0
                        else VideoType.ATTRIBUTE_T1
                    )
                    atlas.set_video_bitstream(_vb(vtype, unit.payload))
                else:
                    atlas.set_video_bitstream(
                        _vb(VideoType.ATTRIBUTE, unit.payload)
                    )
            else:
                raise ValueError(f"unknown V3C unit type {t}")
        return context

    def decode_file(self, path: str) -> list[Context]:
        return [self.decode(gof) for gof in self.read_file(path)]

    # ------------------------------------------------------------------
    def _decode_atlas_data(self, context: Context, unit: V3CUnit) -> None:
        atlas = context.atlas(unit.header.vuh_atlas_id)
        nals = read_sample_stream_nal(unit.payload)
        afoc = 0
        for nal in nals:
            t = nal.nal_unit_type
            if t == NalUnitType.NAL_ASPS:
                atlas.asps_list.append(
                    AtlasSequenceParameterSetRbsp.read(BitReader(nal.payload))
                )
            elif t == NalUnitType.NAL_AFPS:
                atlas.afps_list.append(
                    AtlasFrameParameterSetRbsp.read(
                        BitReader(nal.payload), atlas.asps
                    )
                )
            elif t in (NalUnitType.NAL_PREFIX_ESEI, NalUnitType.NAL_PREFIX_NSEI):
                atlas.seis_prefix.extend(
                    read_sei_rbsp(BitReader(nal.payload), prefix=True)
                )
            elif t in (NalUnitType.NAL_SUFFIX_ESEI, NalUnitType.NAL_SUFFIX_NSEI):
                atlas.seis_suffix.extend(
                    read_sei_rbsp(BitReader(nal.payload), prefix=False)
                )
            elif nal.is_acl or t in (
                NalUnitType.NAL_IDR_N_LP,
                NalUnitType.NAL_GIDR_N_LP,
            ):
                atl = self._decode_atl(atlas, nal)
                atl.afoc = afoc
                afoc += 1
                atlas.atlas_tile_layers.append(atl)
            elif t in (NalUnitType.NAL_EOS, NalUnitType.NAL_EOB, NalUnitType.NAL_FD):
                continue
            else:
                raise ValueError(f"unhandled atlas NAL type {t}")

    def _decode_atl(self, atlas: AtlasHLS, nal: NalUnit) -> AtlasTileLayerRbsp:
        br = BitReader(nal.payload)
        header = AtlasTileHeader.read(br, atlas.asps, atlas.afps, nal.is_irap)
        afps = atlas.afps(header.ath_atlas_frame_parameter_set_id)
        asps = atlas.asps(afps.afps_atlas_sequence_parameter_set_id)
        nri = atlas.num_ref_idx_active(header, asps, afps)
        ctx = atlas.syntax_context(asps, afps, nri, header)
        if asps.asps_plr_enabled_flag:
            # PLR on inter/merge patches sizes its block maps from the
            # previous same-tile ATL's patches (PCCBitstreamReader.cpp
            # prevFrameIndex_ lookup)
            for prev in reversed(atlas.atlas_tile_layers):
                if prev.header.ath_id == header.ath_id:
                    ctx.ref_patches = prev.data_unit.patches
                    break
        data_unit = AtlasTileDataUnit.read(br, header.ath_type, ctx)
        return AtlasTileLayerRbsp(header=header, data_unit=data_unit)


def _vb(vtype: VideoType, payload: bytes):
    from .video_bitstream import VideoBitstream

    return VideoBitstream(vtype, payload)
