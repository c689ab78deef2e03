"""rabbit-color-convert on PyTorch: the PccAppColorConverter analog, raw
video color-space and chroma-format conversion.

Option parity with source/app/PccAppColorConverter/
PccAppColorConverter.cpp:50-123: srcVideoPath / dstVideoPath / configFile /
width / height / colorFormat (RGB444|YUV444|YUV420) / inputNumBytes /
outputNumBytes.  The conversion itself is described by an HDRConvert cfg
file; when an HDRConvert binary resolves (RABBIT_HDRCONVERT_BIN or PATH) it
runs externally exactly like the reference's PCCHDRToolsAppColorConverter,
otherwise the device colour ops perform the same Source*->Output*
conversion internally (the PCCInternalColorConverter role).

Port of ``rabbit_transcoding_tpu/apps/color_convert.py``: the internal
conversion runs as torch ops on ``--device`` (``cuda``, the default, raises
without a GPU); HDRConvert runs on the host."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ..core.image import Video
from ..device import resolve
from ..ops.color import (
    downsample_chroma,
    rgb_to_yuv709,
    upsample_chroma,
    yuv709_to_rgb,
)
from ..ops.rbv_tools import scalar
from ..utils.enums import ColorFormat
from ..video.hdrtools import (
    ExternalColorConverter,
    _cfg_int,
    _format_of,
    find_hdrconvert,
)
from .common import build_registry, parse_or_help


_FORMAT_NAMES = {
    "RGB444": ColorFormat.RGB444,
    "YUV444": ColorFormat.YUV444,
    "YUV420": ColorFormat.YUV420,
}


@dataclasses.dataclass
class ColorConvertParams:
    srcVideoPath: str = ""
    dstVideoPath: str = ""
    configFile: str = ""
    width: int = 0
    height: int = 0
    colorFormat: str = ""        # RGB444 | YUV444 | YUV420
    inputNumBytes: int = 1
    outputNumBytes: int = 1
    frameCount: int = 0          # 0 = infer from file size
    # legacy aliases (earlier rounds of this framework)
    inPath: str = ""
    outPath: str = ""
    inputBitDepth: int = 0
    conversion: str = ""         # rgb444toyuv420 | yuv420torgb444
    # internal filter bank selection (ops/color: the PCCInternalColorConverter
    # g_filter tables)
    downsampleFilter: int = 1    # 0 DF_F0 | 1 DF_F1 | 2 DF_TM5 | 3 DF_FV
    upsampleFilter: int = 0      # 0 UF_F0 | 3 UF_LS3 | 4 UF_LS4 | 5 UF_TM
    device: str = "cuda"         # torch device: cuda (the GPU) or cpu


def _frame_bytes(width: int, height: int, fmt: ColorFormat, nbytes: int) -> int:
    samples = width * height * 3
    if fmt == ColorFormat.YUV420:
        samples = width * height * 3 // 2
    return samples * nbytes


def internal_convert(
    video: Video,
    out_format: ColorFormat,
    out_bitdepth: int,
    down_filter: int = 1,
    up_filter: int = 0,
    device: torch.device | str = "cuda",
) -> Video:
    """Any-to-any {RGB444, YUV444, YUV420} conversion on ``device`` at any
    bitdepth, through a normalized YUV444 intermediate (the
    PCCInternalColorConverter conversion graph)."""
    device = resolve(device)
    scale_in = scalar(float((1 << video.bitdepth) - 1), device)
    planes = [torch.from_numpy(p.astype(np.float32)).to(device) / scale_in
              for p in video.planes]
    if video.format == ColorFormat.RGB444:
        y, u, v = rgb_to_yuv709(*planes)
    elif video.format == ColorFormat.YUV444:
        y, u, v = planes
    elif video.format == ColorFormat.YUV420:
        y = planes[0]
        u = upsample_chroma(planes[1], up_filter)[:, : y.shape[1], : y.shape[2]]
        v = upsample_chroma(planes[2], up_filter)[:, : y.shape[1], : y.shape[2]]
    else:
        raise ValueError(f"unsupported source format {video.format}")
    if out_format == ColorFormat.RGB444:
        out_planes = list(yuv709_to_rgb(y, u, v))
    elif out_format == ColorFormat.YUV444:
        out_planes = [y, u, v]
    elif out_format == ColorFormat.YUV420:
        out_planes = [
            y,
            downsample_chroma(u, down_filter),
            downsample_chroma(v, down_filter),
        ]
    else:
        raise ValueError(f"unsupported output format {out_format}")
    scale_out = float((1 << out_bitdepth) - 1)
    dtype = np.uint8 if out_bitdepth <= 8 else np.uint16
    out_np = [
        torch.clamp(torch.round(p * scale_out), 0, scale_out).cpu().numpy()
        .astype(dtype)
        for p in out_planes
    ]
    return Video(video.width, video.height, out_bitdepth, out_format, out_np)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = ColorConvertParams()
    reg = build_registry(params)
    if parse_or_help(reg, argv, params, "rabbit-color-convert") is None:
        return 0
    src = params.srcVideoPath or params.inPath
    dst = params.dstVideoPath or params.outPath
    # legacy direct-conversion mode (no cfg file)
    if params.conversion and not params.configFile:
        in_fmt, out_fmt = {
            "rgb444toyuv420": (ColorFormat.RGB444, ColorFormat.YUV420),
            "yuv420torgb444": (ColorFormat.YUV420, ColorFormat.RGB444),
        }.get(params.conversion, (None, None))
        if in_fmt is None:
            print(f"error: unknown conversion {params.conversion}",
                  file=sys.stderr)
            return 1
        in_depth = params.inputBitDepth or 8
        out_depth = 8
    elif params.configFile:
        with open(params.configFile) as fh:
            cfg = fh.read()
        in_fmt = _format_of(_cfg_int(cfg, "SourceChromaFormat"),
                            _cfg_int(cfg, "SourceColorSpace"))
        out_fmt = _format_of(_cfg_int(cfg, "OutputChromaFormat"),
                             _cfg_int(cfg, "OutputColorSpace"))
        in_depth = _cfg_int(cfg, "SourceBitDepthCmp0",
                            8 * max(params.inputNumBytes, 1))
        out_depth = _cfg_int(cfg, "OutputBitDepthCmp0",
                             8 * max(params.outputNumBytes, 1))
        if params.colorFormat:
            if params.colorFormat not in _FORMAT_NAMES:
                print(f"error: colorFormat must be one of "
                      f"{'|'.join(_FORMAT_NAMES)}", file=sys.stderr)
                return 1
            in_fmt = _FORMAT_NAMES[params.colorFormat]
    else:
        print("error: --configFile (or legacy --conversion) is required",
              file=sys.stderr)
        return 1
    if not src or not dst or not params.width or not params.height:
        print("error: --srcVideoPath, --dstVideoPath, --width, --height "
              "required", file=sys.stderr)
        return 1
    frames = params.frameCount
    if frames <= 0:
        fb = _frame_bytes(params.width, params.height, in_fmt,
                          2 if in_depth > 8 else 1)
        frames = max(1, os.path.getsize(src) // fb)
    video = Video().read(src, params.width, params.height, frames,
                         in_depth, in_fmt)
    binary = find_hdrconvert() if params.configFile else None
    if binary:
        out = ExternalColorConverter(binary, params.configFile).convert(video)
    else:
        out = internal_convert(video, out_fmt, out_depth,
                               params.downsampleFilter, params.upsampleFilter,
                               params.device)
    out.write(dst)
    print(f"{dst}: {in_fmt.name}/{in_depth}b -> {out_fmt.name}/{out_depth}b "
          f"({out.frame_count} frames, "
          f"{'HDRConvert' if binary else 'internal'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
