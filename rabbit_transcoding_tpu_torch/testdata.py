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
* ``patches=True``: one atlas tile layer per frame, so that a decoder
  reconstructs points (below); ``smoothing=True`` adds the geometry- and
  attribute-smoothing SEIs;
* ``with_input_qps``: the same stream with its lossy videos requantised to
  other QPs, a cheap way to get distinct streams of one shape.

Patch data (``patches=True``).  This is test data, not an encoder: a fixed
layout that the port's own syntax classes write the way the V-PCC encoder
fills them (one intra ``PatchDataUnit`` per patch in an I tile).  The atlas
is a grid of 64 x 64-pixel patches (4 x 4 blocks at occupancy resolution
16; 256 patches per frame at 1024 x 1024).  Patch k takes orientation
k mod 8, and normal axis and projection mode k mod 6 (the six axial
projection planes); its 3D offsets follow the grid position, with the depth
offset chosen per projection mode so that, with geometry of about 180-420,
every coordinate stays within 10 bits.  Every fifth patch that is not on
the last row or column is one block longer (80 pixels along its u axis), so
its block bounding box overlaps its right or lower neighbour's and block
ownership is contested; the ASPS declares that the first-coded patch wins.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitstream import V3CReader, V3CWriter, VideoBitstream
from .bitstream.hls import Context
from .bitstream.sei import SeiAttributeSmoothing, SeiGeometrySmoothing
from .bitstream.syntax import (
    AtlasFrameParameterSetRbsp,
    AtlasSequenceParameterSetRbsp,
    AtlasTileDataUnit,
    AtlasTileHeader,
    AtlasTileLayerRbsp,
    PatchDataUnit,
    PatchInformationData,
    RefListStruct,
    V3CParameterSet,
)
from .codec.mapstream import attr_bias, geo_bias, make_delta
from .core.image import Video
from .utils.enums import (
    AtlasTileType,
    CodecId,
    ColorFormat,
    PatchModeITile,
    VideoType,
)
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


PATCH_BLOCKS = 4       # a patch is 4 x 4 blocks of 16 pixels
_BLOCK = 16


def patch_units(width: int, height: int) -> list[PatchDataUnit]:
    """The intra patch data units of one frame of the patch-carrying test
    stream (the module's note gives the layout)."""
    nx, ny = width // (PATCH_BLOCKS * _BLOCK), height // (PATCH_BLOCKS * _BLOCK)
    units = []
    for gy in range(ny):
        for gx in range(nx):
            k = gy * nx + gx
            # one block longer along u: the canvas box grows to the right,
            # or downwards under an orientation that swaps the axes
            longer = k % 5 == 1 and gx < nx - 1 and gy < ny - 1
            mode1 = (k % 6) >= 3
            depth0 = (k * 8) % 512
            units.append(PatchDataUnit(
                pdu_2d_pos_x=gx * PATCH_BLOCKS,
                pdu_2d_pos_y=gy * PATCH_BLOCKS,
                pdu_2d_size_x_minus1=PATCH_BLOCKS - 1 + longer,
                pdu_2d_size_y_minus1=PATCH_BLOCKS - 1,
                pdu_3d_offset_u=(gx * 64) % 896,
                pdu_3d_offset_v=(gy * 64) % 896,
                pdu_3d_offset_d=1023 - depth0 if mode1 else depth0,
                pdu_projection_id=k % 6,
                pdu_orientation_index=k % 8,
            ))
    return units


def make_stream(frames: int, width: int = 1024, height: int = 1024,
                device=torch.device("cpu"), motion: bool = False,
                intra: bool = False, lossless: bool = False,
                map_pair: bool = False, patches: bool = False,
                smoothing: bool = False) -> bytes:
    """One GOF of ``frames`` frames at ``width`` x ``height`` -> V3C bytes.
    Deterministic (seed 0).  ``patches``: with one atlas tile layer per
    frame (width and height multiples of 64); ``smoothing``: with a
    geometry-smoothing SEI (grid method, grid 8, threshold 64) and an
    attribute-smoothing SEI."""
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
            asps_map_count_minus1=1 if map_pair else 0,
            # first-coded patch wins a contested block
            asps_patch_precedence_order_flag=patches,
            # the tile headers name the ASPS's reference list (one
            # short-term entry, the previous frame), as the encoder's do
            ref_list_structs=[RefListStruct(
                num_ref_entries=1, abs_delta_afoc_st=[1],
                straf_entry_sign_flag=[True])] if patches else [])
    )
    atlas.afps_list.append(AtlasFrameParameterSetRbsp())
    if patches:
        for fi in range(frames):
            atl = AtlasTileLayerRbsp(
                header=AtlasTileHeader(
                    ath_type=AtlasTileType.I_TILE,
                    ath_atlas_frm_order_cnt_lsb=fi % 256),
                data_unit=AtlasTileDataUnit(patches=[
                    PatchInformationData(
                        patch_mode=int(PatchModeITile.I_INTRA), data=du)
                    for du in patch_units(width, height)]))
            atl.afoc = fi
            atlas.atlas_tile_layers.append(atl)
    if smoothing:
        atlas.seis_prefix.append(SeiGeometrySmoothing(
            gs_smoothing_method_type=1, gs_smoothing_grid_size_minus2=6,
            gs_smoothing_threshold=64))
        atlas.seis_prefix.append(SeiAttributeSmoothing(
            as_smoothing_grid_size_minus2=6, as_smoothing_threshold=10,
            as_smoothing_threshold_variation=255,
            as_smoothing_threshold_difference=255))
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
