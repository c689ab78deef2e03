"""The RABBIT live V3C transcoder: the RBV ``reencode`` and ``requant``
modes.

Port of ``rabbit_transcoding_tpu/transcoder/transcoder.py``.  Take a decoded
Context (HLS + video sub-bitstreams), re-encode (or requantise in the DCT
domain) each RBV video component at new rate points without re-running
segmentation or packing, optionally downscale the occupancy map, refresh the
hash SEI, and leave all other atlas metadata intact for remux.  Each lossy
plane transcodes on ``device``: a stream without MC, intra, deblocking or
threshold through the hand-written Hopper kernel on a CUDA device, every
other one through the plain PyTorch chains on the same device.

Parameters are the reference's ``TranscoderParameters``, unchanged.  What
the slice does not cover raises ``NotImplementedError`` naming the ROADMAP
item that will port it.
"""

from __future__ import annotations

import numpy as np
import torch

from rabbit_transcoding_tpu.bitstream.hls import Context
from rabbit_transcoding_tpu.bitstream.sei import SeiDecodedAtlasInformationHash
from rabbit_transcoding_tpu.bitstream.video_bitstream import VideoBitstream
from rabbit_transcoding_tpu.codec.hash import create_hash_sei
from rabbit_transcoding_tpu.codec.patch_frame import decode_patch_frames
from rabbit_transcoding_tpu.core.image import Video
from rabbit_transcoding_tpu.transcoder.params import TranscoderParameters
from rabbit_transcoding_tpu.utils.enums import CodecId, ColorFormat, VideoType
from rabbit_transcoding_tpu.utils.timing import StageTimer

from ..ops.occupancy import downscale_maxpool
from ..video import VideoDecoder, VideoEncoder, VideoEncoderParams, rbv

_PIXEL_VIDEO_TYPES = (
    VideoType.GEOMETRY, VideoType.ATTRIBUTE, VideoType.GEOMETRY_D0,
    VideoType.GEOMETRY_D1, VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1,
)
_GEO_TYPES = {VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
              VideoType.GEOMETRY_D1}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP, queue 1 item {item})"
    )


class Transcoder:
    def __init__(self, params: TranscoderParameters | None = None,
                 device: torch.device | str = "cpu"):
        self.params = params or TranscoderParameters()
        self.device = torch.device(device)
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def _keep_intermediate(self, atlas, stage: str) -> None:
        """keepIntermediateFiles: dump each video sub-stream payload
        before/after transcoding for debugging."""
        if not self.params.keepIntermediateFiles:
            return
        base = self.params.test_name or "transcode"
        for vtype, vb in atlas.video_bitstreams.items():
            path = (f"{base}_{stage}_{vtype.name.lower()}"
                    f"_atlas{atlas.atlas_id}.bin")
            with open(path, "wb") as f:
                f.write(vb.data)

    def transcode(self, context: Context, atlas_id: int = 0) -> Context:
        """Transcode one GOF's atlas in place (PCCTranscoder::transcode)."""
        p = self.params
        atlas = context.atlas(atlas_id)
        if p.rate_mode == "abr" and p.targetBitrateMbps > 0:
            raise _not_ported("rate_mode 'abr'", 3)
        # predicted map coding (map 1 coded as a delta on map 0's recon)
        # transcodes the pair jointly in the reference
        if not context.map1_absolute() and (
            self._has_rbv_pair(atlas, VideoType.GEOMETRY_D0,
                               VideoType.GEOMETRY_D1)
            or self._has_rbv_pair(atlas, VideoType.ATTRIBUTE_T0,
                                  VideoType.ATTRIBUTE_T1)
        ):
            raise _not_ported("predicted map pairs", 3)
        self._keep_intermediate(atlas, "in")

        # the reference re-encodes a lossless input over an occupancy map
        # after a push-pull background fill
        if self._has_lossless_video(atlas) and self._has_rbv_occupancy(atlas):
            raise _not_ported(
                "lossless video input with an occupancy map (push-pull "
                "background fill)", 3)

        with self.timer.stage("transcodeOccupancy"):
            self._transcode_occupancy(atlas)
        with self.timer.stage("transcodeGeometry"):
            for vt in (VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
                       VideoType.GEOMETRY_D1):
                self._transcode_video(atlas, vt, p.effective_geometry_qp())
        with self.timer.stage("transcodeAttribute"):
            for vt in (VideoType.ATTRIBUTE, VideoType.ATTRIBUTE_T0,
                       VideoType.ATTRIBUTE_T1):
                self._transcode_video(atlas, vt, p.effective_attribute_qp())
            self._transcode_attr_ext(atlas, p.effective_attribute_qp())
            self._transcode_reflectance(atlas, p.effective_attribute_qp())

        if p.computeHashSei:
            with self.timer.stage("createHashSEI"):
                self._refresh_hash_sei(atlas)
        self._keep_intermediate(atlas, "out")
        return context

    # ------------------------------------------------------------------
    def _transcode_occupancy(self, atlas) -> None:
        """Occupancy is lossless; only its precision (video resolution) can
        change.  Downscale by max-pool when the target precision is
        coarser."""
        p = self.params
        vb = atlas.video_bitstreams.get(VideoType.OCCUPANCY)
        if vb is None or p.occupancyPrecision <= 0:
            return
        if not vb.data.startswith(b"RBV"):
            raise _not_ported("foreign (Annex-B) occupancy video", 9)
        info = rbv.probe(vb.data)
        # incoming precision is implicit: atlas width / occupancy video width
        asps = atlas.asps_list[0]
        cur_precision = max(1, asps.asps_frame_width // info["width"])
        if p.occupancyPrecision == cur_precision:
            return
        if p.occupancyPrecision < cur_precision:
            raise ValueError(
                f"cannot upscale occupancy precision {cur_precision} -> "
                f"{p.occupancyPrecision}"
            )
        factor = p.occupancyPrecision // cur_precision
        video = VideoDecoder.create(CodecId.RBV, self.device).decode(vb.data)
        occ = torch.from_numpy(np.ascontiguousarray(video.planes[0]))
        small = downscale_maxpool(occ.to(self.device), factor).cpu().numpy()
        out_video = Video(
            video.width // factor, video.height // factor, video.bitdepth,
            ColorFormat.YUV400, [small],
        )
        payload, _ = VideoEncoder.create(
            CodecId.RBV_LOSSLESS, self.device
        ).encode(out_video, VideoEncoderParams(lossless=True))
        atlas.set_video_bitstream(VideoBitstream(VideoType.OCCUPANCY, payload))

    @staticmethod
    def _has_lossless_video(atlas) -> bool:
        return any(
            (vb := atlas.video_bitstreams.get(t)) is not None
            and vb.data.startswith(b"RBV")
            and rbv.probe(vb.data)["lossless"]
            for t in _PIXEL_VIDEO_TYPES
        ) or any(
            vb.data.startswith(b"RBV") and rbv.probe(vb.data)["lossless"]
            for vb in atlas.attr_ext.values()
        )

    @staticmethod
    def _has_rbv_occupancy(atlas) -> bool:
        vb = atlas.video_bitstreams.get(VideoType.OCCUPANCY)
        return (vb is not None and vb.data.startswith(b"RBV")
                and bool(atlas.asps_list))

    def _has_rbv_pair(self, atlas, t0: VideoType, t1: VideoType) -> bool:
        vb0 = atlas.video_bitstreams.get(t0)
        vb1 = atlas.video_bitstreams.get(t1)
        return (
            vb0 is not None and vb1 is not None
            and vb0.data.startswith(b"RBV") and vb1.data.startswith(b"RBV")
        )

    def _transcode_video(self, atlas, vtype: VideoType, qp: int) -> None:
        vb = atlas.video_bitstreams.get(vtype)
        if vb is None:
            return
        payload = self._transcode_payload_any(vtype, vb, qp)
        atlas.set_video_bitstream(VideoBitstream(vtype, payload))

    def _transcode_payload_any(self, vtype: VideoType, vb, qp: int) -> bytes:
        """One sub-stream payload -> transcoded payload (used for both the
        standard VideoType slots and the attr_ext streams)."""
        p = self.params
        if not vb.data.startswith(b"RBV"):
            raise _not_ported(f"foreign (Annex-B) {vtype.name} video", 9)
        info = rbv.probe(vb.data)
        if info["lossless"]:
            # no occupancy map (checked in transcode): no background fill
            return rbv._reencode_lossless(vb.data, qp, None, 6, self.device)
        if (p.effective_mode(qp, motion=info["motion"]) == "requant"
                and not p.transcodeBaseline):
            return rbv.requantize(vb.data, qp, device=self.device)
        # fused decode -> re-encode on the device
        return rbv.transcode_payload(
            vb.data, qp,
            new_gop=1 if p.allIntra else p.videoGopSize,
            coeff_threshold=(p.geometryCoeffThreshold
                             if vtype in _GEO_TYPES else 0),
            device=self.device,
        )

    def _transcode_attr_ext(self, atlas, qp: int) -> None:
        """Dimension-partitioned / extra attribute sub-streams transcode at
        the attribute QP like the primary stream."""
        for key, vb in list(atlas.attr_ext.items()):
            payload = self._transcode_payload_any(VideoType.ATTRIBUTE, vb, qp)
            atlas.attr_ext[key] = VideoBitstream(VideoType.ATTRIBUTE, payload)

    def _transcode_reflectance(self, atlas, qp: int) -> None:
        """Reflectance (attribute index 1): a lossless stream passes through
        untouched; a lossy one transcodes like any attribute video."""
        vb = atlas.video_bitstreams.get(VideoType.ATTRIBUTE_REFL)
        if vb is None:
            return
        if vb.data.startswith(b"RBV") and rbv.probe(vb.data)["lossless"]:
            return
        payload = self._transcode_payload_any(VideoType.ATTRIBUTE_REFL, vb,
                                              qp)
        atlas.set_video_bitstream(
            VideoBitstream(VideoType.ATTRIBUTE_REFL, payload)
        )

    # ------------------------------------------------------------------
    def _refresh_hash_sei(self, atlas) -> None:
        """Replace any decoded-atlas-hash SEI with a freshly computed one.
        Atlas metadata is untouched by transcoding, so the recomputed hash
        certifies the passthrough."""
        patch_frames = decode_patch_frames(atlas)
        sei = create_hash_sei(atlas, patch_frames)
        atlas.seis_prefix = [
            s for s in atlas.seis_prefix
            if not isinstance(s, SeiDecodedAtlasInformationHash)
        ]
        atlas.seis_prefix.append(sei)
