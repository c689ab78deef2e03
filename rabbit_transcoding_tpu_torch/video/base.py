"""Video codec factory: the RBV / RBV_LOSSLESS slice of the reference's
``rabbit_transcoding_tpu/video/base.py``.

Pipelines request a codec by ``CodecId`` and a ``torch.device``: the card
unless the caller asks for the CPU (no card raises).  External
app codecs (HM, JM, SHM, VTM, ffmpeg) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.image import Video
from ..device import resolve
from ..utils.enums import CodecId
from . import rbv


@dataclasses.dataclass
class VideoEncoderParams:
    """Uniform encoder knobs: the reference's, without those of the
    external codecs."""

    qp: int = 32
    gop_size: int = 2
    all_intra: bool = False
    lossless: bool = False
    block_size: int = 16
    motion: bool = False   # motion-compensated P frames
    # occupancy-aware RDO: optional (F, H, W) weights masking the MC
    # distortion so that only patch content drives the motion choice
    mc_weight: object = None
    # zero the quantised +/-1 at zigzag rank >= this (0 = off)
    coeff_threshold: int = 0
    # mosaic intra prediction (DC/planar) on I frames
    intra: bool = False


def _check_rbv(codec_id: CodecId) -> None:
    if codec_id not in (CodecId.RBV, CodecId.RBV_LOSSLESS):
        raise NotImplementedError(
            f"codec {codec_id.name} is not ported yet (ROADMAP, queue 1 "
            f"item 9b: foreign route)"
        )


class VideoEncoder:
    def encode(self, video: Video,
               params: VideoEncoderParams) -> tuple[bytes, Video]:
        """Returns (payload bytes, reconstructed video as a decoder sees it)."""
        raise NotImplementedError

    @staticmethod
    def create(codec_id: CodecId,
               device: torch.device | str = "cuda") -> "VideoEncoder":
        _check_rbv(codec_id)
        return RbvVideoEncoder(codec_id == CodecId.RBV_LOSSLESS, device)


class VideoDecoder:
    def decode(self, payload: bytes,
               output_bitdepth: int | None = None) -> Video:
        raise NotImplementedError

    @staticmethod
    def create(codec_id: CodecId,
               device: torch.device | str = "cuda") -> "VideoDecoder":
        _check_rbv(codec_id)
        return RbvVideoDecoder(device)


class RbvVideoEncoder(VideoEncoder):
    def __init__(self, force_lossless: bool = False,
                 device: torch.device | str = "cuda") -> None:
        self.force_lossless = force_lossless
        self.device = resolve(device)

    def encode(self, video: Video,
               params: VideoEncoderParams) -> tuple[bytes, Video]:
        rp = rbv.RbvParams(
            qp=params.qp,
            block_size=params.block_size,
            gop_size=1 if params.all_intra else params.gop_size,
            lossless=params.lossless or self.force_lossless,
            motion=params.motion and not params.all_intra,
            mc_weight=params.mc_weight,
            coeff_threshold=params.coeff_threshold,
            intra=params.intra,
        )
        return rbv.encode(video, rp, self.device)


class RbvVideoDecoder(VideoDecoder):
    def __init__(self, device: torch.device | str = "cuda") -> None:
        self.device = resolve(device)

    def decode(self, payload: bytes,
               output_bitdepth: int | None = None) -> Video:
        video = rbv.decode(payload, self.device)
        if output_bitdepth is not None and output_bitdepth != video.bitdepth:
            video = video.convert_bitdepth(output_bitdepth)
        return video
