"""External video codec backends (shell-out wrappers).

Capability parity with the reference's *APP codec modes
(PCCHMAppVideoEncoder.cpp:60-69): the codec is an external binary driven
through files + a command template, so any HM/JM/VTM/ffmpeg build on the
host plugs in without code changes.

Command templates receive named placeholders:
  {input}   raw planar YUV input path        {output}  coded bitstream path
  {recon}   reconstructed YUV path           {width} {height} {frames}
  {bitdepth} {qp}
Defaults match HM's TAppEncoder/TAppDecoder CLI; override via
``encoderCommand`` / ``decoderCommand`` (cfg-cascade friendly).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import tempfile

from ..core.image import Video
from ..utils.enums import ColorFormat
from .base import VideoDecoder, VideoEncoder, VideoEncoderParams

HM_ENCODER_TEMPLATE = (
    "{binary} -i {input} -b {output} -o {recon} -wdt {width} -hgt {height} "
    "-f {frames} -fr 30 -q {qp} --InputBitDepth={bitdepth} "
    "--InternalBitDepth={bitdepth} --InputChromaFormat={chroma}"
)
HM_DECODER_TEMPLATE = "{binary} -b {input} -o {output} -d {bitdepth}"

# JM (AVC, PCCJMAppVideoEncoder analog): lencod takes -p key=value pairs
JM_ENCODER_TEMPLATE = (
    "{binary} -p InputFile={input} -p OutputFile={output} "
    "-p ReconFile={recon} -p SourceWidth={width} -p SourceHeight={height} "
    "-p FramesToBeEncoded={frames} -p QPISlice={qp} -p QPPSlice={qp} "
    "-p SourceBitDepthLuma={bitdepth} -p SourceBitDepthChroma={bitdepth}"
)
JM_DECODER_TEMPLATE = "{binary} -p InputFile={input} -p OutputFile={output}"

# SHM (SHVC, PCCSHMAppVideoEncoder analog): HM-style CLI, layer 0 shown —
# multi-layer runs override via encoderCommand with per-layer options
SHM_ENCODER_TEMPLATE = (
    "{binary} -i0 {input} -b {output} -o0 {recon} -wdt0 {width} "
    "-hgt0 {height} -f {frames} -fr0 30 -q0 {qp} --InputBitDepth0={bitdepth} "
    "--InputChromaFormat0={chroma}"
)
SHM_DECODER_TEMPLATE = "{binary} -b {input} -o0 {output}"

# VTM (VVC, PCCVTMLibVideoEncoder role via the app binaries): HM-style CLI
VTM_ENCODER_TEMPLATE = HM_ENCODER_TEMPLATE
VTM_DECODER_TEMPLATE = HM_DECODER_TEMPLATE

_CHROMA_CODE = {
    ColorFormat.YUV400: "400",
    ColorFormat.YUV420: "420",
    ColorFormat.YUV444: "444",
    ColorFormat.RGB444: "444",
}


class _workdir:
    """TemporaryDirectory that survives when keep_files is set
    (keepIntermediateFiles, PCCVideoEncoder.cpp:346-402)."""

    def __init__(self, keep: bool):
        self.keep = keep
        self._td = None

    def __enter__(self) -> str:
        if self.keep:
            path = tempfile.mkdtemp(prefix="rbx_ext_keep_")
            print(f"keepIntermediateFiles: {path}")
            return path
        self._td = tempfile.TemporaryDirectory(prefix="rbx_ext_")
        return self._td.__enter__()

    def __exit__(self, *exc):
        if self._td is not None:
            return self._td.__exit__(*exc)
        return False


class ExternalVideoEncoder(VideoEncoder):
    """Runs an external encoder binary over temp files (the reference's
    file-based IPC, PCCVideoEncoder.cpp:346-402 keepIntermediateFiles
    concept applies via keep_files).

    ``config_path`` is the codec's own cfg file (the reference's
    occupancyMapConfig/geometryConfig/attributeConfig cfg corpus,
    PccAppEncoder.cpp:298-556), inserted right after the binary with
    ``config_flag`` (HM/SHM/VTM: ``-c``; JM lencod: ``-d``) so CLI options
    still override it, matching the codecs' last-wins parsing."""

    def __init__(self, binary: str, template: str = HM_ENCODER_TEMPLATE,
                 keep_files: bool = False, config_path: str = "",
                 config_flag: str = "-c", byte_stream: bool = True):
        self.binary = binary
        self.template = template
        self.keep_files = keep_files
        self.config_path = config_path
        self.config_flag = config_flag
        # byteStreamVideoEncoder* parity: True (default) = the binary
        # emits an Annex-B byte stream; False = it emits a NAL sample
        # stream, converted back to Annex-B here so the rest of the
        # pipeline always sees byte streams
        self.byte_stream = byte_stream

    def encode(self, video: Video, params: VideoEncoderParams) -> tuple[bytes, Video]:
        with _workdir(self.keep_files) as td:
            in_path = os.path.join(td, "in.yuv")
            out_path = os.path.join(td, "out.bin")
            rec_path = os.path.join(td, "rec.yuv")
            video.write(in_path)
            cmd = self.template.format(
                binary=self.binary, input=in_path, output=out_path,
                recon=rec_path, width=video.width, height=video.height,
                frames=video.frame_count, bitdepth=video.bitdepth,
                qp=params.qp, chroma=_CHROMA_CODE[video.format],
            )
            argv = shlex.split(cmd)
            config = params.config_path or self.config_path
            if config and self.config_flag:
                argv[1:1] = [self.config_flag, config]
            proc = subprocess.run(
                argv, capture_output=True, text=True
            )
            if proc.returncode != 0 or not os.path.exists(out_path):
                raise RuntimeError(
                    f"external encoder failed ({proc.returncode}): "
                    f"{proc.stderr[-500:]}"
                )
            with open(out_path, "rb") as fh:
                payload = fh.read()
            if not self.byte_stream and payload:
                from ..bitstream.video_bitstream import (
                    sample_stream_to_byte_stream,
                )

                payload = sample_stream_to_byte_stream(payload)
            if os.path.exists(rec_path):
                recon = Video().read(
                    rec_path, video.width, video.height, video.frame_count,
                    video.bitdepth, video.format,
                )
            else:
                recon = video
            return payload, recon


class ExternalVideoDecoder(VideoDecoder):
    def __init__(self, binary: str, template: str = HM_DECODER_TEMPLATE,
                 width: int = 0, height: int = 0, frames: int = 0,
                 bitdepth: int = 8, fmt: ColorFormat = ColorFormat.YUV420,
                 keep_files: bool = False, byte_stream: bool = True):
        self.binary = binary
        self.template = template
        self.width, self.height, self.frames = width, height, frames
        self.bitdepth, self.fmt = bitdepth, fmt
        self.keep_files = keep_files
        # byteStreamVideoCoder* parity: False = the binary consumes a NAL
        # sample stream, so convert the Annex-B payload before handing over
        self.byte_stream = byte_stream

    def decode(self, payload: bytes, output_bitdepth: int | None = None) -> Video:
        with _workdir(self.keep_files) as td:
            in_path = os.path.join(td, "in.bin")
            out_path = os.path.join(td, "out.yuv")
            if not self.byte_stream and payload:
                from ..bitstream.video_bitstream import (
                    byte_stream_to_sample_stream,
                )

                payload = byte_stream_to_sample_stream(payload)
            with open(in_path, "wb") as fh:
                fh.write(payload)
            cmd = self.template.format(
                binary=self.binary, input=in_path, output=out_path,
                bitdepth=output_bitdepth or self.bitdepth,
                width=self.width, height=self.height, frames=self.frames,
            )
            proc = subprocess.run(
                shlex.split(cmd), capture_output=True, text=True
            )
            if proc.returncode != 0 or not os.path.exists(out_path):
                raise RuntimeError(
                    f"external decoder failed ({proc.returncode}): "
                    f"{proc.stderr[-500:]}"
                )
            bitdepth = output_bitdepth or self.bitdepth
            frames = self.frames
            if frames <= 0:
                # Annex-B carries no frame count; infer it from the decoded
                # file size (the reference's baseline path reads a fixed
                # count it knows a priori — we don't, PCCTranscoder.cpp:205)
                samples = {
                    ColorFormat.YUV400: self.width * self.height,
                    ColorFormat.YUV444: 3 * self.width * self.height,
                    ColorFormat.RGB444: 3 * self.width * self.height,
                }.get(self.fmt,
                      self.width * self.height * 3 // 2)  # YUV420
                itemsize = 2 if bitdepth > 8 else 1
                frame_bytes = samples * itemsize
                frames = os.path.getsize(out_path) // max(1, frame_bytes)
                if frames <= 0:
                    raise RuntimeError(
                        f"external decoder produced {out_path} smaller than "
                        f"one {self.width}x{self.height} frame"
                    )
            video = Video().read(
                out_path, self.width, self.height, frames,
                bitdepth, self.fmt,
            )
            return video


_SPS_CHROMA_TO_FMT = {
    0: ColorFormat.YUV400,
    1: ColorFormat.YUV420,
    3: ColorFormat.YUV444,
}


def decode_annexb_probed(
    payload: bytes,
    binary: str,
    template: str = HM_DECODER_TEMPLATE,
    fallback_width: int = 0,
    fallback_height: int = 0,
    fallback_bitdepth: int = 8,
    byte_stream: bool = True,
    keep_files: bool = False,
) -> Video:
    """Decode an Annex-B payload through an external binary, sizing the
    output from the payload's own SPS (the role PccLibHevcParser plays for
    the reference's app decoders, PCCHMAppVideoDecoder.cpp:60-61), falling
    back to caller-supplied dimensions when no SPS parses."""
    from .hevc_probe import probe_avc, probe_hevc

    info = probe_hevc(payload) or probe_avc(payload)
    if info is not None:
        width, height = info["width"], info["height"]
        bitdepth = info["bitdepth"]
        fmt = _SPS_CHROMA_TO_FMT.get(
            info.get("chroma_format_idc", 1), ColorFormat.YUV420
        )
    else:
        if fallback_width <= 0 or fallback_height <= 0:
            raise ValueError(
                "foreign payload has no parseable SPS and no fallback "
                "dimensions"
            )
        width, height = fallback_width, fallback_height
        bitdepth, fmt = fallback_bitdepth, ColorFormat.YUV420
    dec = ExternalVideoDecoder(
        binary, template,
        width=width, height=height, frames=0,  # inferred from file size
        bitdepth=bitdepth, fmt=fmt,
        byte_stream=byte_stream, keep_files=keep_files,
    )
    return dec.decode(payload)
