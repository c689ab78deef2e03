"""The benchmark's input streams, made from a seed.

``planes`` is a copy of the program's synthetic plane maker
(``testdata.content``: smooth-noise occupancy blobs at 64-pixel
granularity; a smooth 10-bit geometry surface; an 8-bit attribute luma)
with the seed threaded through, computed on the device: the seed draws the
occupancy blobs and a pixel offset of each surface, so every seed gives
content of the same statistics and the same amount of work.  ``stream``
codes the planes with the program's RBV encoder and wraps them in V3C as
the program's ``testdata.make_stream`` does: lossless occupancy at the
configured precision, the geometry and attribute videos in the configured
colour formats at the configuration's input QPs and GOP, with motion
compensation and intra prediction where the configuration codes them.  The
planes are a 10-bit geometry and an 8-bit attribute; a configuration that
states other bit depths, or a colour format other than YUV400 and YUV420,
is refused.
"""

from __future__ import annotations

import numpy as np


def planes(seed: int, frames: int, width: int, height: int, device):
    """-> (occupancy uint8 0/1 (F, H, W), geometry uint16 10-bit (F, H, W),
    attribute luma uint8 (F, H, W)), numpy, computed on ``device``."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    blobs = torch.from_numpy(rng.normal(size=(frames, 1, height // 64,
                                              width // 64))).to(device)
    gx, gy, ax, ay = (int(v) for v in rng.integers(0, 4096, 4))
    # linear upsampling, corners on corners (scipy's zoom, order 1)
    occ = F.interpolate(blobs, size=(height, width), mode="bilinear",
                        align_corners=True)[:, 0] > 0.5
    f = torch.arange(frames, dtype=torch.float64, device=device)[:, None,
                                                                  None]
    x = torch.arange(width, dtype=torch.float64, device=device)[None, None]
    y = torch.arange(height, dtype=torch.float64, device=device)[None, :,
                                                                 None]
    geo = 300 + 120 * torch.sin((x + 7 * f + gx) / 37.0) * torch.cos(
        (y - 3 * f + gy) / 29.0)
    attr = 128 + 80 * torch.sin((x + 5 * f + ax) / 23.0) + 30 * torch.cos(
        (y + ay) / 17.0)
    return (occ.to(torch.uint8).cpu().numpy(),
            geo.to(torch.int32).cpu().numpy().astype(np.uint16),
            attr.clamp(0, 255).to(torch.int32).cpu().numpy().astype(
                np.uint8))


BITDEPTHS = {"geometry": 10, "attribute": 8}


def video(luma: np.ndarray, cfg: dict, kind: str):
    """The configured video of one luma plane: YUV400 as it is, YUV420 with
    flat mid-grey chroma at half size."""
    from rabbit_transcoding_tpu_torch.core.image import Video
    from rabbit_transcoding_tpu_torch.utils.enums import ColorFormat

    if cfg["bitdepth"] != BITDEPTHS[kind]:
        raise ValueError(f"the generator makes {BITDEPTHS[kind]}-bit {kind}"
                         f", not {cfg['bitdepth']}-bit")
    f, h, w = luma.shape
    fmt = ColorFormat[cfg["format"]]
    planes = [luma]
    if fmt == ColorFormat.YUV420:
        mid = np.full((f, h // 2, w // 2), 1 << (cfg["bitdepth"] - 1),
                      luma.dtype)
        planes += [mid, mid.copy()]
    elif fmt != ColorFormat.YUV400:
        raise ValueError(f"the generator makes YUV400 and YUV420, not "
                         f"{cfg['format']}")
    return Video(w, h, cfg["bitdepth"], fmt, planes)


def stream(config: dict, seed: int, device) -> bytes:
    """One GOF of the configuration's content from ``seed`` -> V3C bytes."""
    from rabbit_transcoding_tpu_torch.bitstream import (
        V3CWriter, VideoBitstream)
    from rabbit_transcoding_tpu_torch.bitstream.hls import Context
    from rabbit_transcoding_tpu_torch.bitstream.syntax import (
        AtlasFrameParameterSetRbsp, AtlasSequenceParameterSetRbsp,
        V3CParameterSet)
    from rabbit_transcoding_tpu_torch.core.image import Video
    from rabbit_transcoding_tpu_torch.utils.enums import (
        CodecId, ColorFormat, VideoType)
    from rabbit_transcoding_tpu_torch.video import (
        VideoEncoder, VideoEncoderParams)

    atlas_cfg = config["atlas"]
    w, h, f = atlas_cfg["width"], atlas_cfg["height"], atlas_cfg["frames"]
    p = atlas_cfg["occupancy_precision"]
    occ, geo, attr_y = planes(seed, f, w, h, device)
    occ_small = occ.reshape(f, h // p, p, w // p, p).max(axis=(2, 4))
    enc = VideoEncoder.create(CodecId.RBV, device)
    occ_payload, _ = VideoEncoder.create(CodecId.RBV_LOSSLESS, device).encode(
        Video(w // p, h // p, 8, ColorFormat.YUV400, [occ_small]),
        VideoEncoderParams(lossless=True))
    tools = config["tools"]

    def lossy(video, cfg) -> bytes:
        return enc.encode(video, VideoEncoderParams(
            qp=cfg["qp_in"], gop_size=cfg["gop"], motion=tools["motion"],
            intra=tools["intra"],
            mc_weight=occ if tools["motion"] else None))[0]

    gcfg, acfg = config["geometry"], config["attribute"]
    geo_payload = lossy(video(geo, gcfg, "geometry"), gcfg)
    attr_payload = lossy(video(attr_y, acfg, "attribute"), acfg)

    context = Context()
    vps = V3CParameterSet()
    vps.atlas(0).vps_frame_width = w
    vps.atlas(0).vps_frame_height = h
    context.vps_list.append(vps)
    atlas = context.atlas(0)
    atlas.asps_list.append(AtlasSequenceParameterSetRbsp(
        asps_frame_width=w, asps_frame_height=h))
    atlas.afps_list.append(AtlasFrameParameterSetRbsp())
    for vt, payload in ((VideoType.OCCUPANCY, occ_payload),
                        (VideoType.GEOMETRY, geo_payload),
                        (VideoType.ATTRIBUTE, attr_payload)):
        atlas.set_video_bitstream(VideoBitstream(vt, payload))
    writer = V3CWriter()
    return writer.write(writer.encode(context))
