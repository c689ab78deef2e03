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

Source clouds.  ``make_frame`` (a deforming voxelised sphere with smooth
colours), ``make_scene_frame`` (a textured multi-object scene) and
``make_dense_frame`` (reference-scale density) are the reference's
``testdata`` cloud makers, pure numpy: clouds with a known surface for the
normals and the metrics.

Write a source sequence as PLY files (the reference's ``testdata`` CLI, the
same bytes for the same arguments):

    python -m rabbit_transcoding_tpu_torch.testdata --frames 4 \
        --out cloud_%04d.ply [--scene sphere|blobs|dense] [--points N]

Encoder streams.  ``load_encoder_stream`` reads one of the small V3C streams
that the reference's V-PCC encoder wrote (``tests/fixtures_torch/``, made by
``tools/make_torch_fixtures.py``): real encoder output with its source
clouds and the reference decoder's checksums and metrics beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import zlib

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
from .core.pointset import PointSet
from .utils.enums import (
    AtlasTileType,
    CodecId,
    ColorFormat,
    PatchModeITile,
    VideoType,
)
from .video import VideoDecoder, VideoEncoder, VideoEncoderParams, rbv


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


# the codec group of an HEVC V3C stream (PCCBitstreamCommon.h:169-173)
_HEVC_GROUP = 1


def _foreign_payload(video: Video, codec: str, qp: int,
                     occupancy: bool) -> bytes:
    from . import mock_hevc
    from .video import hevc_intra, hevc_ipcm

    if codec == "mock":
        return mock_hevc.encode(video, qp)[0]
    if occupancy:
        return hevc_ipcm.encode(video)
    return hevc_intra.encode(video, qp)


def to_foreign(data: bytes, device=torch.device("cpu"), codec: str = "intra",
               geometry_qp: int = 16, attribute_qp: int = 22,
               workers: int = 1) -> bytes:
    """The first GOF of an RBV V3C stream with its videos decoded (on
    ``device``) and re-encoded as HEVC Annex-B -> V3C bytes signalling the
    HEVC Main10 codec group: a foreign stream of the same content.

    ``codec="intra"``: the in-tree subsets, occupancy as IPCM (lossless) and
    the other videos as the compressed all-intra subset at the given QPs
    (geometry QP for geometry videos, attribute QP for the others);
    ``codec="mock"``: the stand-in codec (``mock_hevc``) at those QPs, the
    occupancy at QP 4 (a quantiser step of 1: lossless).  ``workers`` > 1
    encodes the videos in that many processes at once (the subsets code on
    the host, one video per core)."""
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    context.vps.profile_tier_level.ptl_profile_codec_group_idc = _HEVC_GROUP
    atlas = context.atlas(0)
    dec = VideoDecoder.create(CodecId.RBV, device)
    jobs = []
    for vt, vb in list(atlas.video_bitstreams.items()):
        occupancy = vt == VideoType.OCCUPANCY
        qp = (4 if occupancy else geometry_qp if vt.name.startswith(
            "GEOMETRY") else attribute_qp)
        jobs.append((vt, (dec.decode(vb.data), codec, qp, occupancy)))
    if workers > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            payloads = list(pool.map(_foreign_payload,
                                     *zip(*(args for _, args in jobs))))
    else:
        payloads = [_foreign_payload(*args) for _, args in jobs]
    for (vt, _), payload in zip(jobs, payloads):
        atlas.set_video_bitstream(VideoBitstream(vt, payload))
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def write_codec_wrappers(directory) -> tuple[str, str]:
    """Write ``TAppEncoder.sh`` and ``TAppDecoder.sh`` into ``directory``:
    executables that run the stand-in codec (``python -m
    rabbit_transcoding_tpu_torch.mock_hevc encode|decode``) under HM's
    argument conventions -> (encoder path, decoder path).  They put the
    root of this checkout on ``PYTHONPATH``, so that the child process
    imports this package wherever it runs, installed or not."""
    import shlex
    import stat
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = []
    for name, mode in (("TAppEncoder.sh", "encode"),
                       ("TAppDecoder.sh", "decode")):
        path = os.path.join(str(directory), name)
        with open(path, "w") as f:
            f.write(
                "#!/bin/sh\n"
                f"PYTHONPATH={shlex.quote(root)}${{PYTHONPATH:+:$PYTHONPATH}}\n"
                "export PYTHONPATH\n"
                f"exec {shlex.quote(sys.executable)} -m "
                f"rabbit_transcoding_tpu_torch.mock_hevc {mode} \"$@\"\n")
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        paths.append(path)
    return paths[0], paths[1]


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


# ---------------------------------------------------------------------------
# Coefficient blobs of modes 0-2: both decoders read them, no encoder writes
# them (the encoders write mode 3, the frequency slab)


def coeff_blob(q: np.ndarray, mode: int, level: int = 6,
               drop: bool = False) -> bytes:
    """int16 coefficients (F, nby, nbx, B, B) -> an RBV coefficient blob in
    the layout ``video/rbv.py:_decode_coeff_blob`` reads for ``mode``:

    * 0: the dense tensor, DC in DPCM over each frame's block raster, zlib
      (the reference's ``_encode_dense_blob``);
    * 1: the nonzeros' global flat indices as uint32 deltas and their int16
      values, each zlib-compressed, behind ``<QII`` (count and the two
      lengths);
    * 2: the same per frame: ``<III`` (frames and the two lengths), the
      per-frame counts as uint32, then frame-local delta indices.

    ``drop`` (modes 1 and 2) appends one nonzero at an index beyond the
    tensor, which a decoder drops."""
    q16 = np.ascontiguousarray(q, dtype=np.int16)
    f, nby, nbx, b, _ = q16.shape
    if mode == 0:
        if drop:
            raise ValueError("a mode-0 blob has no indices to drop")
        q16 = q16.copy()
        dc = q16[:, :, :, 0, 0].reshape(f, nby * nbx).astype(np.int32)
        q16[:, :, :, 0, 0] = np.diff(dc, axis=1, prepend=0).astype(
            np.int16).reshape(f, nby, nbx)
        return b"\x00" + zlib.compress(q16.tobytes(), level)
    per_frame = nby * nbx * b * b
    if mode == 1:
        rows = [q16.reshape(-1)]
    elif mode == 2:
        rows = list(q16.reshape(f, per_frame))
    else:
        raise ValueError(f"no writer for blob mode {mode}")
    counts, deltas, vals = [], [], []
    for i, row in enumerate(rows):
        idx = np.nonzero(row)[0]
        v = row[idx]
        if drop and i == len(rows) - 1:
            idx = np.append(idx, len(row) + 7)
            v = np.append(v, np.int16(5))
        counts.append(len(idx))
        deltas.append(np.diff(idx, prepend=0).astype(np.uint32))
        vals.append(v.astype(np.int16))
    zi = zlib.compress(np.concatenate(deltas).tobytes(), level)
    zv = zlib.compress(np.concatenate(vals).tobytes(), level)
    if mode == 1:
        return (b"\x01" + struct.pack("<QII", counts[0], len(zi), len(zv))
                + zi + zv)
    return (b"\x02" + struct.pack("<III", f, len(zi), len(zv))
            + np.asarray(counts, np.uint32).tobytes() + zi + zv)


def payload_with_blob_mode(payload: bytes, mode: int,
                           drop: bool = False) -> bytes:
    """A lossy RBV payload with every plane's coefficient blob rewritten to
    ``mode`` (``coeff_blob``); the header and the motion-vector and intra
    side sections stay as they are."""
    flags, w, h, _, chroma, f, b, gop, _ = rbv._parse_header(payload)
    if flags & rbv._LOSSLESS:
        raise ValueError("a lossless payload has no coefficient blobs")
    dims = rbv._plane_dims(w, h, ColorFormat(chroma))
    out = bytearray(payload[:rbv._HEADER.size])
    for (ph, pw), blob in zip(dims, rbv._iter_blobs(payload, len(dims))):
        pl = rbv._Plane(blob, flags, f, ph, pw, b, gop, torch.device("cpu"))
        new = (blob[:len(blob) - len(pl.coeff_blob)]
               + coeff_blob(pl.q.numpy(), mode, drop=drop))
        out += struct.pack("<I", len(new)) + new
    return bytes(out)


def with_blob_mode(data: bytes, mode: int, drop: bool = False) -> bytes:
    """The first GOF of a V3C stream with every lossy RBV video's
    coefficient blobs rewritten to ``mode`` -> V3C bytes."""
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    atlas = context.atlas(0)
    for vt, vb in list(atlas.video_bitstreams.items()):
        if vb.data[:4] != rbv._MAGIC or rbv.probe(vb.data)["lossless"]:
            continue
        atlas.set_video_bitstream(VideoBitstream(
            vt, payload_with_blob_mode(vb.data, mode, drop)))
    writer = V3CWriter()
    return writer.write(writer.encode(context))


# ---------------------------------------------------------------------------
# Source clouds (the reference's testdata cloud makers, numpy only)


def make_frame(
    frame: int = 0,
    n: int = 40000,
    radius: float = 100.0,
    center: float = 128.0,
    seed: int = 7,
    vox_bits: int = 10,
) -> PointSet:
    rng = np.random.default_rng(seed)  # same base sphere; deforms over time
    theta = np.arccos(1 - 2 * rng.uniform(0, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    # time-varying radial deformation = moving surface detail
    r = radius * (
        1.0
        + 0.08 * np.sin(4 * theta + 0.3 * frame)
        + 0.05 * np.cos(5 * phi - 0.2 * frame)
    )
    x = center + r * np.sin(theta) * np.cos(phi)
    y = center + r * np.sin(theta) * np.sin(phi)
    z = center + r * np.cos(theta)
    maxv = (1 << vox_bits) - 1
    pos = np.clip(np.round(np.stack([x, y, z], 1)), 0, maxv).astype(np.int32)
    colors = np.clip(
        np.stack(
            [
                128 + 90 * np.sin(pos[:, 0] / 12.0 + 0.1 * frame),
                128 + 90 * np.cos(pos[:, 1] / 12.0),
                128 + 60 * np.sin(pos[:, 2] / 8.0),
            ],
            1,
        ),
        0,
        255,
    ).astype(np.uint8)
    return PointSet(positions=pos, colors=colors).remove_duplicates()


def make_reflective_frame(frame: int = 0, **kwargs) -> PointSet:
    """``make_frame`` with a reflectance per point, a function of its y
    coordinate (uint16, up to 59,999): the source of the reflectance
    fixture."""
    ps = make_frame(frame, **kwargs)
    ps.reflectances = ((ps.positions[:, 1].astype(np.uint32) * 31)
                       % 60000).astype(np.uint16)
    return ps


def _ellipsoid(
    rng, n: int, center: np.ndarray, radii: np.ndarray,
    yaw: float = 0.0,
) -> np.ndarray:
    theta = np.arccos(1 - 2 * rng.uniform(0, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    p = np.stack(
        [
            radii[0] * np.sin(theta) * np.cos(phi),
            radii[1] * np.sin(theta) * np.sin(phi),
            radii[2] * np.cos(theta),
        ],
        1,
    )
    if yaw:
        c, s = np.cos(yaw), np.sin(yaw)
        p = p @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return p + center


def make_scene_frame(
    frame: int = 0,
    n: int = 40000,
    seed: int = 11,
    vox_bits: int = 10,
) -> PointSet:
    """A textured multi-object scene — the stress content the single smooth
    sphere lacks (round-2 verdict: smooth radial content flatters transform
    codecs).  Three surfaces with mutual self-occlusion/disocclusion as
    seen from the six projection planes:

      * a large static torso ellipsoid with a sharp CHECKERBOARD texture
        (hard color edges every 8 voxels);
      * a rigidly TRANSLATING + rotating small ellipsoid (real motion
        vectors for inter coding) with high-contrast stripes;
      * a static thin slab behind both (gets occluded/disoccluded by the
        moving part) with a two-tone split texture.
    """
    rng = np.random.default_rng(seed)  # same geometry; motion is analytic
    half = int(2 ** (vox_bits - 1))
    n1, n2 = int(n * 0.5), int(n * 0.25)
    n3 = n - n1 - n2
    # surface sizes follow the point budget (~1 point per surface voxel):
    # sparser than that and segmentation rightly dumps points to the raw
    # patch, which would turn the ladder into a raw-coding benchmark
    r1 = float(np.sqrt(n1 / (4 * np.pi)))
    r2 = float(np.sqrt(n2 / (4 * np.pi)))
    torso = _ellipsoid(
        rng, n1, np.array([half, half, half], float),
        np.array([r1, 0.8 * r1, 1.2 * r1]),
    )
    # rigid motion: orbiting + rotating satellite at ~5 voxels/frame so
    # block motion search (+/-6) can actually track it
    orbit = 2.4 * r1
    ang = 5.0 / orbit * frame
    sat_center = np.array([
        half + orbit * np.cos(ang),
        half + orbit * np.sin(ang),
        half + 0.5 * r1,
    ])
    sat = _ellipsoid(
        rng, n2, sat_center,
        np.array([0.8 * r2, 1.1 * r2, 0.8 * r2]),
        yaw=0.05 * frame,
    )
    # thin background slab (a dense jittered grid: a true <=2-voxel-deep
    # surface that the moving satellite occludes/disoccludes)
    side = int(np.floor(np.sqrt(n3)))
    gx, gz = np.meshgrid(np.arange(side), np.arange(side))
    slab = np.stack(
        [
            half - side / 2.0 + gx.reshape(-1)[:n3]
            + rng.uniform(-0.5, 0.5, min(n3, side * side)),
            half + 2.2 * r1 + rng.uniform(0, 2, min(n3, side * side)),
            half - side / 2.0 + gz.reshape(-1)[:n3]
            + rng.uniform(-0.5, 0.5, min(n3, side * side)),
        ],
        1,
    )
    n3 = len(slab)
    pos = np.concatenate([torso, sat, slab])
    maxv = (1 << vox_bits) - 1
    pos = np.clip(np.round(pos), 0, maxv).astype(np.int32)

    # sharp textures (hard edges, no radial smoothness)
    checker = ((pos[:n1, 0] // 8 + pos[:n1, 1] // 8 + pos[:n1, 2] // 8) % 2
               ).astype(np.uint8)
    torso_col = np.where(
        checker[:, None] > 0,
        np.array([[230, 40, 40]], np.uint8),
        np.array([[25, 25, 210]], np.uint8),
    )
    stripes = ((pos[n1 : n1 + n2, 2] // 6) % 2).astype(np.uint8)
    sat_col = np.where(
        stripes[:, None] > 0,
        np.array([[250, 250, 30]], np.uint8),
        np.array([[10, 160, 60]], np.uint8),
    )
    split = (pos[n1 + n2 :, 0] > half).astype(np.uint8)
    slab_col = np.where(
        split[:, None] > 0,
        np.array([[200, 200, 200]], np.uint8),
        np.array([[60, 60, 60]], np.uint8),
    )
    colors = np.concatenate([torso_col, sat_col, slab_col]).astype(np.uint8)
    return PointSet(positions=pos, colors=colors).remove_duplicates()


def make_dense_frame(
    frame: int = 0,
    n: int = 500000,
    seed: int = 13,
    vox_bits: int = 10,
) -> PointSet:
    """Reference-scale content: vox10 density (>=300k points/frame after
    dedupe — the 8i clouds the reference's CTC runs on are ~800k,
    cfg/sequence/longdress_vox10.cfg:5-12).  The blobs
    scene scaled to ~1 point/voxel surface density, plus an ARTICULATED
    swinging limb (hinge rotation — a motion class the orbiting satellite
    doesn't cover: every block has a different motion vector)."""
    base = make_scene_frame(frame, n=int(n * 0.85), seed=seed,
                            vox_bits=vox_bits)
    rng = np.random.default_rng(seed + 1)
    half = int(2 ** (vox_bits - 1))
    n_limb = n - int(n * 0.85)
    # cylinder surface swinging about a hinge near the torso top
    length = 1.6 * float(np.sqrt(n / 8 / (4 * np.pi)))
    radius = max(4.0, length / 6.0)
    t = rng.uniform(0, 1, n_limb)            # along the limb
    a = rng.uniform(0, 2 * np.pi, n_limb)    # around the limb
    swing = 0.6 * np.sin(0.35 * frame)       # hinge angle over time
    c, s = np.cos(swing), np.sin(swing)
    lx = t * length
    ly = radius * np.cos(a)
    lz = radius * np.sin(a)
    limb = np.stack([
        half + 1.2 * length + (c * lx - s * lz),
        half + ly,
        half + 1.0 * length + (s * lx + c * lz),
    ], 1)
    maxv = (1 << vox_bits) - 1
    limb = np.clip(np.round(limb), 0, maxv).astype(np.int32)
    rings = ((limb[:, 0] // 5 + limb[:, 2] // 5) % 2).astype(np.uint8)
    limb_col = np.where(
        rings[:, None] > 0,
        np.array([[240, 120, 20]], np.uint8),
        np.array([[20, 40, 90]], np.uint8),
    )
    return PointSet(
        positions=np.concatenate([base.positions, limb]),
        colors=np.concatenate([base.colors, limb_col]),
    ).remove_duplicates()


def normals_mismatch(a: np.ndarray, b: np.ndarray) -> dict:
    """How far two sets of unit normals are apart, row by row: the share of
    rows whose angle (float64, rad) exceeds 1e-5 and 1e-3 and the largest
    angle, as they are and with the sign ignored."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    ang = np.arctan2(np.linalg.norm(np.cross(a, b), axis=1),
                     (a * b).sum(axis=1))
    unsigned = np.minimum(ang, np.pi - ang)
    return {"share_beyond_1e-5": float((ang > 1e-5).mean()),
            "share_beyond_1e-3": float((ang > 1e-3).mean()),
            "max_angle": float(ang.max()),
            "unsigned_share_beyond_1e-5": float((unsigned > 1e-5).mean()),
            "unsigned_share_beyond_1e-3": float((unsigned > 1e-3).mean()),
            "unsigned_max_angle": float(unsigned.max())}


SCENES = {
    "sphere": make_frame,
    "blobs": make_scene_frame,
    "dense": make_dense_frame,
}


# ---------------------------------------------------------------------------
# Streams written by the reference's V-PCC encoder (committed files)

ENCODER_STREAM_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures_torch")
# lossy RBV with MC and intra (the encoder's defaults); lossy occupancy with
# the patch border filter; lossless geometry with EOM and raw points
ENCODER_STREAMS = ("sphere_default", "scene_lossy_occupancy_pbf",
                   "sphere_eom_lossless")
# one small stream per encoder branch that the three above do not take
BRANCH_STREAMS = ("plr", "pixel_interleaving", "projection_45", "lod",
                  "reflectance", "map_streams", "raw_points")


# branch stream -> whether a decoded atlas carries its branch
BRANCH_CARRIED = {
    "plr": lambda a: a.asps_list[0].asps_plr_enabled_flag,
    "pixel_interleaving": lambda a: (
        a.asps_list[0].asps_pixel_deinterleaving_flag),
    "projection_45": lambda a: (
        a.asps_list[0].asps_extended_projection_enabled_flag),
    "lod": lambda a: any(
        getattr(p.data, "pdu_lod_enabled_flag", False)
        for atl in a.atlas_tile_layers for p in atl.data_unit.patches),
    "reflectance": lambda a: VideoType.ATTRIBUTE_REFL in a.video_bitstreams,
    "map_streams": lambda a: VideoType.GEOMETRY_D1 in a.video_bitstreams,
    "raw_points": lambda a: VideoType.GEOMETRY_RAW in a.video_bitstreams,
}


def branch_carried(name: str, data: bytes) -> bool:
    """Whether the first atlas of the V3C stream ``data`` carries the
    encoder branch of the branch stream ``name`` (a parameter-set flag, a
    patch flag or a sub-stream)."""
    reader = V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    return bool(BRANCH_CARRIED[name](atlas))


def _unhex(v):
    if isinstance(v, list):
        return tuple(_unhex(x) for x in v)
    return float.fromhex(v) if isinstance(v, str) else v


def load_encoder_stream(name: str):
    """-> (V3C bytes, the source clouds the encoder was given, the record:
    ``checksums`` (hex, per decoded frame, the reference decoder's; the
    sources carry reflectances where the stream codes them),
    ``point_counts``, ``encoder_parameters``, and ``metrics_per_frame`` /
    ``metrics_summary`` as ``QualityMetrics`` of the reference's
    ``compute_sequence_metrics`` of its decode against the sources)."""
    from .metrics.metrics import QualityMetrics

    base = os.path.join(ENCODER_STREAM_DIR, name)
    with open(base + ".bin", "rb") as f:
        data = f.read()
    with open(base + ".json", encoding="utf-8") as f:
        record = json.load(f)
    with np.load(base + "_source.npz") as z:
        sources = [
            PointSet(positions=z[f"positions_{i}"].astype(np.int32),
                     colors=z[f"colors_{i}"],
                     reflectances=(z[f"reflectances_{i}"]
                                   if f"reflectances_{i}" in z.files
                                   else None))
            for i in range(sum(k.startswith("positions_") for k in z.files))
        ]

    def metrics(d):
        return QualityMetrics(**{k: _unhex(v) for k, v in d.items()})
    record["metrics_per_frame"] = [metrics(d)
                                   for d in record["metrics_per_frame"]]
    record["metrics_summary"] = metrics(record["metrics_summary"])
    return data, sources, record


SCENES = {
    "sphere": make_frame,
    "blobs": make_scene_frame,
    "dense": make_dense_frame,
}


def main(argv=None) -> int:
    """Write ``--frames`` clouds of a scene as PLY files."""
    ap = argparse.ArgumentParser(
        description="Write a synthetic point-cloud sequence as PLY files.")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--points", type=int, default=40000)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--scene", choices=sorted(SCENES), default="sphere",
                    help="sphere = smooth deforming sphere; blobs = textured "
                         "multi-object scene with rigid motion + occlusion; "
                         "dense = blobs at vox10 density with a swinging "
                         "limb")
    ap.add_argument("--out", default="cloud_%04d.ply")
    args = ap.parse_args(argv)
    for f in range(args.frames):
        ps = SCENES[args.scene](f, n=args.points)
        path = args.out % (args.start + f)
        ps.write_ply(path)
        print(f"{path}: {ps.point_count} points")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
