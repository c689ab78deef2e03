"""Raw (missed-points) patches via auxiliary video.

Capability parity with the reference's raw-points path: encoder side
generateRawPointsPatch + aux-video packing (PCCEncoder.cpp:4176, 4449-4704),
decoder side raw-points geometry/attribute recovery from video
(PCCCodec.cpp:1451-1583).  Points that no projection covers are stored
losslessly: coordinates as a sequential (x, y, z, x, y, z, ...) stream in an
auxiliary geometry video, colors one pixel per point in an auxiliary
attribute video; the atlas signals them with RawPatchDataUnits
(rpdu_patch_in_auxiliary_video_flag = 1).

Aux-video layout (self-describing through the video headers):
  geometry: YUV400, the nominal geometry bitdepth, width 256,
            height = ceil(3N/256) padded to 16 rows, one frame per source
            frame (frames align with the atlas AFOC order);
  attribute: RGB444 8-bit, same width, height = ceil(N/256) padded.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.hls import AtlasHLS
from ..bitstream.syntax import AtlasTileLayerRbsp, RawPatchDataUnit
from ..core.image import Video
from ..utils.enums import ColorFormat

AUX_WIDTH = 256


def morton_order(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """Sort order of int points along the Morton (Z-order) curve
    (PCCEncoder::mortonAddr analog, PCCEncoder.cpp:8904): spatially close
    points become sequence-close, which the aux-video entropy coder
    rewards (mortonOrderSortRawPoints)."""
    p = points.astype(np.uint64)
    key = np.zeros(len(p), np.uint64)
    for b in range(bits):
        for c in range(3):
            key |= ((p[:, c] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                3 * b + c
            )
    return np.argsort(key, kind="stable")


def prune_isolated_raw_points(
    points: np.ndarray,
    min_norm_sum_of_inv_dist: float = 0.35,
    max_neighbor_count: int = 16,
    max_dist2: float = 10.0,
) -> np.ndarray:
    """lossyRawPointsPatch density pruning (PCCEncoder::generateRawPointsPatch,
    source/lib/PccLibEncoder/source/PCCEncoder.cpp:4271-4292):
    a raw point survives only if the sum of inverse SQUARED distances to its
    <=16 nearest raw points within dist^2<=10 reaches
    minNormSumOfInvDist4MPSelection * 16 — isolated noise is not worth lossy
    aux-video samples.  Returns a boolean keep mask."""
    n = len(points)
    if n <= 1:
        return np.zeros(n, dtype=bool)
    from scipy.spatial import cKDTree

    k = min(max_neighbor_count + 1, n)  # +1: query returns self first
    dist, _ = cKDTree(points).query(points, k=k, workers=-1)
    if dist.ndim == 1:
        dist = dist[:, None]
    d2 = dist[:, 1:] ** 2
    inv = np.where((d2 > 0) & (d2 <= max_dist2), 1.0 / np.maximum(d2, 1e-12),
                   0.0)
    return inv.sum(axis=1) >= min_norm_sum_of_inv_dist * max_neighbor_count


def _rows(n_samples: int, width: int = AUX_WIDTH) -> int:
    return max(16, -(-n_samples // width) // 16 * 16 + 16) if n_samples else 16


def build_raw_videos(
    raw_points: list[np.ndarray],     # per frame (N_f, 3) int32
    raw_colors: list[np.ndarray | None],
    bitdepth: int,
    extra_colors: list[np.ndarray | None] | None = None,
    width: int = AUX_WIDTH,
) -> tuple[Video, Video]:
    """Pack per-frame raw point lists into aux geometry/attribute videos.
    `extra_colors` (EOM point colors) append after each frame's raw block in
    the attribute video — the decoder reads them at offset raw_count."""
    f = len(raw_points)
    geo_rows = max(_rows(3 * max((len(p) for p in raw_points), default=0), width), 16)
    n_attr = [
        len(raw_points[i]) + (
            len(extra_colors[i]) if extra_colors and extra_colors[i] is not None
            else 0
        )
        for i in range(f)
    ]
    attr_rows = max(_rows(max(n_attr, default=0), width), 16)
    geo = np.zeros((f, geo_rows, width), np.uint16)
    rgb = np.zeros((3, f, attr_rows, width), np.uint8)
    for fi, pts in enumerate(raw_points):
        if len(pts):
            stream = np.ascontiguousarray(pts.astype(np.uint16)).reshape(-1)
            geo[fi].reshape(-1)[: len(stream)] = stream
        colors = raw_colors[fi]
        if colors is not None and len(colors) == len(pts):
            for c in range(3):
                rgb[c, fi].reshape(-1)[: len(pts)] = colors[:, c]
        if extra_colors and extra_colors[fi] is not None:
            ec = extra_colors[fi]
            off = len(pts)
            for c in range(3):
                rgb[c, fi].reshape(-1)[off : off + len(ec)] = ec[:, c]
    geo_video = Video(width, geo_rows, bitdepth, ColorFormat.YUV400, [geo])
    attr_video = Video(
        width, attr_rows, 8, ColorFormat.RGB444, [rgb[0], rgb[1], rgb[2]]
    )
    return geo_video, attr_video


def make_raw_patch_unit(n_points: int, width: int = AUX_WIDTH) -> RawPatchDataUnit:
    rows = -(-3 * n_points // width)
    return RawPatchDataUnit(
        rpdu_patch_in_auxiliary_video_flag=True,
        rpdu_2d_pos_x=0,
        rpdu_2d_pos_y=0,
        rpdu_2d_size_x_minus1=width - 1,
        rpdu_2d_size_y_minus1=max(0, rows - 1),
        rpdu_3d_offset_u=0,
        rpdu_3d_offset_v=0,
        rpdu_3d_offset_d=0,
        rpdu_points_minus1=n_points - 1,
    )


def _collect_units(atlas: AtlasHLS, unit_cls) -> list[list]:
    """Per-frame units of a given class, grouping multi-tile ATLs by their
    coded frame order count (same grouping as codec.patch_frame)."""
    keys: list[int] = []
    groups: dict[int, list] = {}
    for atl in atlas.atlas_tile_layers:
        key = atl.header.ath_atlas_frm_order_cnt_lsb
        if key not in groups:
            groups[key] = []
            keys.append(key)
        groups[key].extend(
            pid.data
            for pid in atl.data_unit.patches
            if isinstance(pid.data, unit_cls)
        )
    return [groups[k] for k in keys]


def collect_raw_patch_units(atlas: AtlasHLS) -> list[list[RawPatchDataUnit]]:
    """Per-frame raw patch units in frame order."""
    return _collect_units(atlas, RawPatchDataUnit)


def collect_eom_patch_units(atlas: AtlasHLS) -> list[list]:
    from ..bitstream.syntax import EOMPatchDataUnit

    return _collect_units(atlas, EOMPatchDataUnit)


def recover_raw_points(
    units: list[RawPatchDataUnit],
    geo_frame: np.ndarray,           # (H, W) uint16 aux geometry plane
    attr_frame: np.ndarray | None,   # (H, W, 3) uint8 aux attribute
    coord_max: int | None = None,    # clip lossy coords to the 3D range
) -> tuple[np.ndarray, np.ndarray | None]:
    """One frame's raw patch units -> (points (N,3), colors (N,3) or None).
    coord_max mirrors the encoder closed loop's clip: lossy aux video can
    produce samples past the 3D coordinate range when the video bitdepth
    exceeds the coordinate bitdepth."""
    pts_list = []
    col_list = []
    geo_flat = geo_frame.reshape(-1)
    attr_flat = None if attr_frame is None else attr_frame.reshape(-1, 3)
    for unit in units:
        n = unit.rpdu_points_minus1 + 1
        stream = geo_flat[: 3 * n].astype(np.int32)
        pts = stream.reshape(n, 3)
        pts = pts + np.array(
            [unit.rpdu_3d_offset_u, unit.rpdu_3d_offset_v, unit.rpdu_3d_offset_d],
            np.int32,
        )
        pts_list.append(pts)
        if attr_flat is not None:
            col_list.append(attr_flat[:n])
    if not pts_list:
        return np.zeros((0, 3), np.int32), None
    pts = np.concatenate(pts_list)
    if coord_max is not None:
        pts = np.clip(pts, 0, coord_max)
    cols = np.concatenate(col_list) if col_list else None
    return pts, cols
