"""External HDRTools color converter (shell-out wrapper).

Capability parity with PCCHDRToolsAppColorConverter
(source/lib/PccLibColorConverter/source/
PCCHDRToolsAppColorConverter.cpp:55-98): the conversion is described by an
HDRConvert cfg file whose Source*/Output* keys also tell us how to write the
input and read the output; the binary runs over temp files.

The internal device converter (ops/color) is the default path; this wrapper
exists for parity with the reference's USE_HDRTOOLS mode and plugs in any
HDRConvert build on the host (or RABBIT_HDRCONVERT_BIN override).
"""

from __future__ import annotations

import os
import re
import shlex
import shutil
import subprocess
import tempfile

from ..core.image import Video
from ..utils.enums import ColorFormat

HDRCONVERT_TEMPLATE = (
    "{binary} -f {config} -p SourceFile={input} -p OutputFile={output} "
    "-p SourceWidth={width} -p SourceHeight={height} "
    "-p NumberOfFrames={frames}"
)


def _cfg_int(config_text: str, key: str, default: int = 0) -> int:
    m = re.search(rf"{re.escape(key)}\s*[:=]\s*(-?\d+)", config_text)
    return int(m.group(1)) if m else default


def _format_of(chroma_format: int, color_space: int) -> ColorFormat:
    # HDRConvert conventions (PCCHDRToolsAppColorConverter.cpp:90-93):
    # ChromaFormat 1 = 420; else ColorSpace 0 = YUV444, other = RGB444
    if chroma_format == 1:
        return ColorFormat.YUV420
    return ColorFormat.YUV444 if color_space == 0 else ColorFormat.RGB444


def find_hdrconvert() -> str | None:
    return os.environ.get("RABBIT_HDRCONVERT_BIN") or shutil.which(
        "HDRConvert"
    )


class ExternalColorConverter:
    """Runs HDRConvert over temp files.  The cfg's SourceBitDepthCmp0 /
    SourceChromaFormat / SourceColorSpace (and Output*) keys drive the I/O
    exactly as the reference does."""

    def __init__(self, binary: str, config_path: str,
                 template: str = HDRCONVERT_TEMPLATE):
        self.binary = binary
        self.config_path = config_path
        self.template = template
        with open(config_path) as fh:
            cfg = fh.read()
        self.src_bitdepth = _cfg_int(cfg, "SourceBitDepthCmp0", 8)
        self.out_bitdepth = _cfg_int(cfg, "OutputBitDepthCmp0", 8)
        self.src_format = _format_of(
            _cfg_int(cfg, "SourceChromaFormat"),
            _cfg_int(cfg, "SourceColorSpace"),
        )
        self.out_format = _format_of(
            _cfg_int(cfg, "OutputChromaFormat"),
            _cfg_int(cfg, "OutputColorSpace"),
        )

    def convert(self, video: Video) -> Video:
        if (video.bitdepth != self.src_bitdepth
                or video.format != self.src_format):
            # HDRConvert interprets the raw input purely from the cfg's
            # Source* keys: a mismatch silently produces garbage
            raise ValueError(
                f"input video ({video.format.name}, {video.bitdepth}-bit) "
                f"does not match the cfg's Source keys "
                f"({self.src_format.name}, {self.src_bitdepth}-bit)"
            )
        with tempfile.TemporaryDirectory(prefix="rbx_hdr_") as td:
            in_path = os.path.join(td, "in.raw")
            out_path = os.path.join(td, "out.raw")
            video.write(in_path)
            cmd = self.template.format(
                binary=self.binary, config=self.config_path,
                input=in_path, output=out_path,
                width=video.width, height=video.height,
                frames=video.frame_count,
            )
            proc = subprocess.run(
                shlex.split(cmd), capture_output=True, text=True
            )
            if proc.returncode != 0 or not os.path.exists(out_path):
                raise RuntimeError(
                    f"HDRConvert failed ({proc.returncode}): "
                    f"{proc.stderr[-500:]}"
                )
            return Video().read(
                out_path, video.width, video.height, video.frame_count,
                self.out_bitdepth, self.out_format,
            )
