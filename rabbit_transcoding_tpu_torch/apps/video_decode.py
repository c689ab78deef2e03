"""rabbit-video-decode on PyTorch — PccAppVideoDecoder analog: RBV stream ->
raw YUV (the transcoder-baseline helper role, PCCTranscoder.cpp:191-200), on
``--device`` (``cuda``, the default, raises when there is no GPU).  Port of
``rabbit_transcoding_tpu/apps/video_decode.py``."""

from __future__ import annotations

import dataclasses
import sys

from ..device import resolve
from ..utils.enums import CodecId
from ..video import VideoDecoder
from ..video import rbv
from .common import build_registry, parse_or_help


@dataclasses.dataclass
class VideoDecodeParams:
    bin: str = ""
    videoPath: str = "out.yuv"
    outputBitDepth: int = 0   # 0 = native


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = VideoDecodeParams()
    reg = build_registry(
        params,
        extra={"device": ("cuda", "torch device: cuda (the GPU) or cpu")})
    if parse_or_help(reg, argv, params, "rabbit-video-decode") is None:
        return 0
    if not params.bin:
        print("error: --bin is required", file=sys.stderr)
        return 1
    device = resolve(reg["device"])
    with open(params.bin, "rb") as f:
        payload = f.read()
    info = rbv.probe(payload)
    video = VideoDecoder.create(CodecId.RBV, device).decode(
        payload, params.outputBitDepth or None
    )
    video.write(params.videoPath)
    print(
        f"{params.videoPath}: {info['width']}x{info['height']}"
        f"x{info['frame_count']} {video.bitdepth}bit {video.format.name}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
