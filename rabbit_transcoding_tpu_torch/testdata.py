"""The benchmark's synthetic V3C stream, built with the port's own encoder.

Port of ``make_stream`` in the repo's ``bench.py``: an r5-grade V-PCC stream
with a ~30%-occupied atlas and smooth geometry/attribute content (what a
background-filled encoder output looks like to the transcoder):

* occupancy: lossless RBV at precision 2;
* geometry: 10-bit YUV400, lossy RBV at QP 16, GOP 2;
* attribute: 8-bit YUV420, lossy RBV at QP 22, GOP 2.

On the CPU its bytes equal the reference's ``bench.make_stream``.  With
``motion`` and ``intra`` on, the lossy planes are coded as the repo's V-PCC
encoder codes them by default (``encoder/params.py``: ``motionEstimation``,
``usePccRDO``, ``geometryIntraPrediction`` and ``attributeIntraPrediction``
on; intra is used at GOP <= 4): motion-compensated P frames whose search is
weighted by the full-resolution occupancy map (``encoder/encoder.py``
weights the geometry with the decoded occupancy and the attribute luma with
the occupied pixels), and mosaic intra I frames.  With ``device=cuda`` the
lossy encodes run on the GPU, so the full-size stream can be built where JAX
is not installed.

Variants for the transcoder's other inputs:

* ``lossless=True``: lossless geometry and attribute over the same
  occupancy (the transcoder background-fills them before quantising);
* ``map_pair=True``: two maps in per-map sub-streams (GEOMETRY_D0/D1,
  ATTRIBUTE_T0/T1) with map 1 coded as a biased delta against the
  reconstructed map 0 (``vps_map_absolute_coding_enabled_flag[1]`` clear);
* ``with_input_qps``: the same stream with its lossy videos requantised to
  other QPs, a cheap way to get distinct streams of one shape.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitstream import V3CReader, V3CWriter, VideoBitstream
from .bitstream.hls import Context
from .bitstream.syntax import (
    AtlasFrameParameterSetRbsp,
    AtlasSequenceParameterSetRbsp,
    V3CParameterSet,
)
from .codec.mapstream import attr_bias, geo_bias, make_delta
from .core.image import Video
from .utils.enums import CodecId, ColorFormat, VideoType
from .video import VideoEncoder, VideoEncoderParams, rbv


def content(frames: int, width: int, height: int):
    """The stream's planes, deterministic (seed 0): the occupancy map at full
    resolution (uint8 0/1), geometry (uint16, 10-bit) and attribute luma
    (uint8)."""
    from scipy.ndimage import zoom

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:height, 0:width]
    # occupancy: smooth-noise blobs at 16px granularity, ~30% fill
    blobs = rng.normal(size=(frames, height // 64, width // 64))
    occ = np.stack(
        [zoom(blobs[f], 64, order=1) > 0.5 for f in range(frames)]
    ).astype(np.uint8)[:, :height, :width]

    geo = np.zeros((frames, height, width), np.uint16)
    attr_y = np.zeros((frames, height, width), np.uint8)
    for f in range(frames):
        g = 300 + 120 * np.sin((xx + 7 * f) / 37.0) * np.cos((yy - 3 * f) / 29.0)
        geo[f] = g.astype(np.uint16)
        a = 128 + 80 * np.sin((xx + 5 * f) / 23.0) + 30 * np.cos(yy / 17.0)
        attr_y[f] = np.clip(a, 0, 255).astype(np.uint8)
    return occ, geo, attr_y


OCC_PRECISION = 2


def lossy_params(motion: bool, intra: bool, occ: np.ndarray) -> dict:
    """{"geometry" | "attribute": VideoEncoderParams keywords} of the lossy
    planes."""
    tools = dict(motion=motion, intra=intra,
                 mc_weight=occ if motion else None)
    return {"geometry": dict(qp=16, gop_size=2, **tools),
            "attribute": dict(qp=22, gop_size=2, **tools)}


def make_stream(frames: int, width: int = 1024, height: int = 1024,
                device=torch.device("cpu"), motion: bool = False,
                intra: bool = False, lossless: bool = False,
                map_pair: bool = False) -> bytes:
    """One GOF of ``frames`` frames at ``width`` x ``height`` -> V3C bytes.
    Deterministic (seed 0)."""
    occ, geo, attr_y = content(frames, width, height)
    p = OCC_PRECISION
    occ_small = occ.reshape(frames, height // p, p, width // p, p).max(
        axis=(2, 4))
    params = lossy_params(motion, intra, occ)
    if lossless:
        params = {k: dict(lossless=True) for k in params}
    enc = VideoEncoder.create(CodecId.RBV, device)
    enc_ll = VideoEncoder.create(CodecId.RBV_LOSSLESS, device)
    occ_payload, _ = enc_ll.encode(
        Video(width // p, height // p, 8, ColorFormat.YUV400, [occ_small]),
        VideoEncoderParams(lossless=True),
    )
    u = np.full((frames, height // 2, width // 2), 128, np.uint8)
    geo_video = Video(width, height, 10, ColorFormat.YUV400, [geo])
    attr_video = Video(width, height, 8, ColorFormat.YUV420,
                       [attr_y, u, u.copy()])
    videos = {}
    if map_pair:
        # map 1: the far surface layer (geometry a few steps deeper, the
        # attribute a shade darker), coded against map 0's recon
        geo1 = np.clip(geo.astype(np.int32) + 3, 0, 1023).astype(np.uint16)
        attr1_y = np.clip(attr_y.astype(np.int32) - 5, 0, 255).astype(
            np.uint8)
        for (t0, t1), video, map1, bias, key in (
                ((VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1), geo_video,
                 [geo1], geo_bias(10), "geometry"),
                ((VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1),
                 attr_video, [attr1_y, u, u.copy()], attr_bias(8),
                 "attribute")):
            vep = VideoEncoderParams(**params[key])
            videos[t0], rec0 = enc.encode(video, vep)
            maxv = (1 << video.bitdepth) - 1
            delta = [make_delta(m1, np.asarray(r0), bias, maxv)
                     for m1, r0 in zip(map1, rec0.planes)]
            videos[t1], _ = enc.encode(
                Video(width, height, video.bitdepth, video.format, delta),
                vep)
    else:
        videos[VideoType.GEOMETRY], _ = enc.encode(
            geo_video, VideoEncoderParams(**params["geometry"]))
        videos[VideoType.ATTRIBUTE], _ = enc.encode(
            attr_video, VideoEncoderParams(**params["attribute"]))

    context = Context()
    vps = V3CParameterSet()
    va = vps.atlas(0)
    va.vps_frame_width = width
    va.vps_frame_height = height
    if map_pair:
        va.vps_map_count_minus1 = 1
        va.vps_multiple_map_streams_present_flag = True
        va.vps_map_absolute_coding_enabled_flag = [True, False]
        va.vps_map_predictor_index_diff = [0, 0]
    context.vps_list.append(vps)
    atlas = context.atlas(0)
    atlas.asps_list.append(
        AtlasSequenceParameterSetRbsp(
            asps_frame_width=width, asps_frame_height=height,
            asps_map_count_minus1=1 if map_pair else 0)
    )
    atlas.afps_list.append(AtlasFrameParameterSetRbsp())
    atlas.set_video_bitstream(VideoBitstream(VideoType.OCCUPANCY, occ_payload))
    for vt, payload in videos.items():
        atlas.set_video_bitstream(VideoBitstream(vt, payload))
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def with_input_qps(data: bytes, geometry_qp: int, attribute_qp: int,
                   device=torch.device("cpu")) -> bytes:
    """The first GOF of a V3C stream with its lossy geometry and attribute
    videos requantised (``rbv.requantize``) to the given QPs -> V3C bytes:
    a stream of the same shape at another input QP."""
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    atlas = context.atlas(0)
    for vt, vb in list(atlas.video_bitstreams.items()):
        if vt == VideoType.OCCUPANCY or rbv.probe(vb.data)["lossless"]:
            continue
        qp = geometry_qp if vt.name.startswith("GEOMETRY") else attribute_qp
        atlas.set_video_bitstream(VideoBitstream(
            vt, rbv.requantize(vb.data, qp, device=device)))
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def stream_planes(data: bytes, device=torch.device("cpu")) -> dict:
    """{(video type name, plane): the plane's sections} of the lossy RBV
    planes of a V3C stream's first GOF: int16 coefficients ``q`` on
    ``device``, intra mode maps ``mode`` and motion vectors ``mv`` (None
    when the stream has none)."""
    reader = V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    out = {}
    for vt, vb in sorted(atlas.video_bitstreams.items(),
                         key=lambda kv: kv[0].value):
        if vt == VideoType.OCCUPANCY or rbv.probe(vb.data)["lossless"]:
            continue
        flags, w, h, _, chroma, f, b, gop, _ = rbv._parse_header(vb.data)
        dims = rbv._plane_dims(w, h, ColorFormat(chroma))
        for k, ((ph, pw), blob) in enumerate(
                zip(dims, rbv._iter_blobs(vb.data, len(dims)))):
            out[(vt.name, k)] = rbv._Plane(blob, flags, f, ph, pw, b, gop,
                                           device)
    return out


def stream_coeffs(data: bytes, device=torch.device("cpu")) -> dict:
    """{(video type name, plane): int16 coefficients} of the lossy RBV
    planes of a V3C stream's first GOF."""
    return {k: p.q for k, p in stream_planes(data, device).items()}
