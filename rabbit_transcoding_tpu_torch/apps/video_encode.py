"""rabbit-video-encode on PyTorch — PccAppVideoEncoder analog: standalone
raw-YUV -> RBV stream encode through the codec factory, on ``--device``
(``cuda``, the default, raises when there is no GPU).  Port of
``rabbit_transcoding_tpu/apps/video_encode.py``."""

from __future__ import annotations

import dataclasses
import sys

from ..core.image import Video
from ..device import resolve
from ..utils.enums import CodecId, ColorFormat
from ..video import VideoEncoder, VideoEncoderParams
from .common import build_registry, parse_or_help


@dataclasses.dataclass
class VideoEncodeParams:
    videoPath: str = ""
    bin: str = "video.rbv"
    width: int = 0
    height: int = 0
    frameCount: int = 1
    inputBitDepth: int = 8
    format: str = "yuv420"   # yuv400 | yuv420 | yuv444
    qp: int = 32
    gopSize: int = 2
    allIntra: bool = False
    lossless: bool = False


_FORMATS = {
    "yuv400": ColorFormat.YUV400,
    "yuv420": ColorFormat.YUV420,
    "yuv444": ColorFormat.YUV444,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = VideoEncodeParams()
    reg = build_registry(
        params,
        extra={"device": ("cuda", "torch device: cuda (the GPU) or cpu")})
    if parse_or_help(reg, argv, params, "rabbit-video-encode") is None:
        return 0
    if not params.videoPath or not params.width or not params.height:
        print("error: --videoPath, --width, --height required", file=sys.stderr)
        return 1
    device = resolve(reg["device"])
    video = Video().read(
        params.videoPath, params.width, params.height, params.frameCount,
        params.inputBitDepth, _FORMATS[params.format],
    )
    enc = VideoEncoder.create(
        CodecId.RBV_LOSSLESS if params.lossless else CodecId.RBV, device
    )
    payload, _ = enc.encode(
        video,
        VideoEncoderParams(qp=params.qp, gop_size=params.gopSize,
                           all_intra=params.allIntra,
                           lossless=params.lossless),
    )
    with open(params.bin, "wb") as f:
        f.write(payload)
    raw = sum(p.nbytes for p in video.planes)
    print(f"{params.bin}: {len(payload)} bytes ({raw / max(1, len(payload)):.1f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
