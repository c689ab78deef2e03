"""rabbit-parse of the PyTorch port — the PccAppParser analog: dump a V3C
bitstream's structure and per-unit statistics (PccAppParser.cpp:50-79).

Port of ``rabbit_transcoding_tpu/apps/parser.py``: RBV payloads, and HEVC and
SHVC payloads through the foreign route's probes; host code only, so it
takes no device."""

from __future__ import annotations

import dataclasses
import sys

from ..bitstream import V3CReader
from ..bitstream.nal import read_sample_stream_nal
from ..utils.enums import V3CUnitType
from ..video import rbv
from .common import build_registry, parse_or_help


@dataclasses.dataclass
class ParserParams:
    bin: str = ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = ParserParams()
    reg = build_registry(params)
    if parse_or_help(reg, argv, params, "rabbit-parse") is None:
        return 0
    if not params.bin:
        print("error: --bin is required", file=sys.stderr)
        return 1

    reader = V3CReader()
    gofs = reader.read_file(params.bin)
    for gi, gof in enumerate(gofs):
        print(f"GOF {gi}: {len(gof)} V3C units")
        for u in gof:
            t = u.header.unit_type
            line = f"  {t.name:8s} {len(u.payload):10d} bytes"
            if t == V3CUnitType.V3C_AD:
                nals = read_sample_stream_nal(u.payload)
                kinds = {}
                for n in nals:
                    kinds[n.nal_unit_type.name] = kinds.get(n.nal_unit_type.name, 0) + 1
                line += "  NALs: " + ", ".join(
                    f"{k}x{v}" for k, v in kinds.items()
                )
            elif t in (V3CUnitType.V3C_OVD, V3CUnitType.V3C_GVD,
                       V3CUnitType.V3C_AVD):
                if getattr(u.header, "vuh_auxiliary_video_flag", False):
                    line += "  aux"
                elif t != V3CUnitType.V3C_OVD and getattr(
                    u.header, "vuh_map_index", 0
                ):
                    line += f"  map{u.header.vuh_map_index}"
                if t == V3CUnitType.V3C_AVD and getattr(
                    u.header, "vuh_attribute_index", 0
                ):
                    line += f"  attr{u.header.vuh_attribute_index}"
                try:
                    info = rbv.probe(u.payload)
                    line += (
                        f"  RBV {info['width']}x{info['height']}"
                        f"x{info['frame_count']} {info['bitdepth']}bit"
                        f" qp={info['qp']}"
                        f"{' lossless' if info['lossless'] else ''}"
                    )
                except ValueError:
                    from ..video.hevc_probe import hevc_layer_ids, probe_hevc

                    info = probe_hevc(u.payload)
                    if info and len(hevc_layer_ids(u.payload)) > 1:
                        # SHVC: per-layer formats via the VPS rep_format
                        # table (PccShvcParser::getVideoSize parity)
                        from ..video.shvc import probe_shvc_layers

                        try:
                            layers = probe_shvc_layers(u.payload)
                            line += "  SHVC " + ", ".join(
                                f"L{lid}:{v['width']}x{v['height']}"
                                f"@{v['bitdepth']}bit"
                                for lid, v in sorted(layers.items())
                            )
                        except ValueError as e:
                            line += f"  SHVC (probe failed: {e})"
                    elif info:
                        line += (
                            f"  HEVC {info['width']}x{info['height']} "
                            f"{info['bitdepth']}bit"
                        )
                    else:
                        line += "  (unknown payload)"
            print(line)
        # HLS summary (PccAppParser's structure dump analog)
        try:
            ctx = reader.decode(list(gof))
            for atlas in ctx.atlases:
                for asps in atlas.asps_list:
                    tools = []
                    if asps.asps_plr_enabled_flag:
                        tools.append(
                            f"plr[{asps.asps_plr_number_of_modes_minus1 + 1}"
                            " modes]"
                        )
                    if asps.asps_eom_patch_enabled_flag:
                        tools.append(
                            f"eom[{asps.asps_eom_fix_bit_count_minus1 + 1}b]"
                        )
                    if asps.asps_pixel_deinterleaving_flag:
                        tools.append("pixel-interleave")
                    if asps.asps_raw_patch_enabled_flag:
                        tools.append("raw")
                    if asps.asps_extended_projection_enabled_flag:
                        tools.append(
                            "proj"
                            f"{asps.asps_max_number_projections_minus1 + 1}"
                        )
                    print(
                        f"  ASPS {asps.asps_atlas_sequence_parameter_set_id}:"
                        f" {asps.asps_frame_width}x{asps.asps_frame_height}"
                        f" maps={asps.asps_map_count_minus1 + 1}"
                        f" geo2d={asps.asps_geometry_2d_bitdepth_minus1 + 1}"
                        f" geo3d={asps.asps_geometry_3d_bitdepth_minus1 + 1}"
                        + (f"  tools: {' '.join(tools)}" if tools else "")
                    )
                for atl in atlas.atlas_tile_layers[:1]:
                    h = atl.header
                    quants = []
                    if h.ath_pos_min_d_quantizer:
                        quants.append(f"minD<<{h.ath_pos_min_d_quantizer}")
                    if h.ath_patch_size_x_info_quantizer or (
                        h.ath_patch_size_y_info_quantizer
                    ):
                        quants.append(
                            f"size q={1 << h.ath_patch_size_x_info_quantizer}"
                            f"x{1 << h.ath_patch_size_y_info_quantizer}"
                        )
                    if quants:
                        print(f"  ATH quantizers: {', '.join(quants)}")
        except Exception as e:
            print(f"  (HLS summary unavailable: {e})")
    print(reader.stat.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
