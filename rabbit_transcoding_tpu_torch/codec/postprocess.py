"""SEI-driven decoder post-processing, shared by encoder (closed loop) and
decoder so both reconstruct identical clouds.

Port of ``rabbit_transcoding_tpu/codec/postprocess.py``: the parameters
come from the geometry- and attribute-smoothing SEIs; the grid filters run
on ``device`` (``ops/smoothing.py``), and so does the KNN of the full-KNN
geometry smoothing that the encoder's closed loop runs without an SEI.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bitstream.sei import Sei, SeiAttributeSmoothing, SeiGeometrySmoothing
from ..core.pointset import PointSet
from ..ops.smoothing import knn_smooth, smooth_clouds, smooth_colors_many
from .reconstruct import first_occurrences

# fixed density-filter strength (both sides must agree; not SEI-coded)
MIN_NEIGHBORS = 4


@dataclasses.dataclass
class KnnSmoothingParams:
    """The reference's gridSmoothing=0 geometry-smoothing knobs
    (neighborCountSmoothing / radius2Smoothing / radius2BoundaryDetection /
    thresholdSmoothing).  Not SEI-carried — both sides configure via CLI,
    exactly like the reference."""

    flag: bool = False
    grid: bool = True
    neighbor_count: int = 64
    radius2: float = 64.0
    radius2_boundary: float = 64.0
    threshold: float = 64.0


def find_attribute_smoothing_sei(seis: list[Sei]) -> SeiAttributeSmoothing | None:
    for sei in seis:
        if isinstance(sei, SeiAttributeSmoothing):
            return sei
    return None


def apply_color_smoothing(
    clouds: list[PointSet],
    sei: SeiAttributeSmoothing | None,
    coord_bits: int = 10,
    device: torch.device | str = "cuda",
) -> list[PointSet]:
    """Grid color smoothing from the attribute-smoothing SEI.  Clouds that
    carry per-point patch indices run the fully gated reference algorithm
    (partition-mix + variation + difference gates, boundary points only);
    clouds without run the legacy neighborhood-mean filter."""
    if sei is None:
        return clouds
    todo = [ps for ps in clouds
            if ps.colors is not None and ps.point_count > 0]
    smoothed = smooth_colors_many(
        [(ps.positions, ps.colors, ps.partition,
          None if ps.types is None else ps.types == 1) for ps in todo],
        threshold=float(sei.as_smoothing_threshold),
        grid_size=sei.as_smoothing_grid_size_minus2 + 2,
        coord_bits=coord_bits,
        threshold_variation=float(sei.as_smoothing_threshold_variation),
        threshold_difference=float(sei.as_smoothing_threshold_difference),
        device=device,
    )
    for ps, (colors, _) in zip(todo, smoothed):
        ps.colors = colors
    return clouds


def _remove_duplicates(ps: PointSet, device) -> PointSet:
    """``ps.remove_duplicates()`` with the search for the first of each
    position on ``device`` (the host's row sort of a few 100,000 points
    costs more than the smoothing filter itself)."""
    if ps.point_count == 0:
        return ps
    pos = torch.from_numpy(np.ascontiguousarray(ps.positions)).to(device)
    first = first_occurrences(torch.zeros(len(pos), dtype=torch.long,
                                          device=pos.device), pos)
    if first is None:
        return ps.remove_duplicates()
    if len(first) == ps.point_count:
        return ps
    return ps.select(first.cpu().numpy())


def find_geometry_smoothing_sei(seis: list[Sei]) -> SeiGeometrySmoothing | None:
    for sei in seis:
        if isinstance(sei, SeiGeometrySmoothing):
            if sei.gs_smoothing_instance_cancel_flag:
                return None
            return sei
    return None


def apply_geometry_smoothing(
    clouds: list[PointSet],
    sei: SeiGeometrySmoothing | None,
    coord_bits: int = 10,
    knn: "KnnSmoothingParams | None" = None,
    attr_transfer_filter_type: int = 0,
    device: torch.device | str = "cuda",
) -> list[PointSet]:
    """Geometry smoothing.  SEI method 1 = grid smoothing (the signalled
    path).  `knn` configures the full-KNN variant (the reference's
    gridSmoothing=0 path, PCCCodec::smoothPointCloud) — CLI-symmetric, not
    SEI-carried, exactly like the reference.  attr_transfer_filter_type != 0
    re-transfers colors to MOVED points from the pre-smoothing cloud
    (the reference's post-smoothing transferColors16bitBP step,
    PCCDecoder.cpp:447-472; 0 = geometry smoothing excluded from attribute
    transfer)."""
    use_knn = (
        sei is None and knn is not None and knn.flag and not knn.grid
    )
    if use_knn:
        smoothed = []
        for ps in clouds:
            part = (
                ps.partition
                if ps.partition is not None
                else np.zeros(ps.point_count, np.int32)
            )
            pos, moved = knn_smooth(
                ps.positions, part,
                neighbor_count=knn.neighbor_count,
                radius2=knn.radius2,
                radius2_boundary=knn.radius2_boundary,
                threshold=knn.threshold,
                eligible=None if ps.types is None else ps.types == 1,
                device=device,
            )
            smoothed.append((pos, np.ones(ps.point_count, bool), moved))
    elif sei is None or sei.gs_smoothing_method_type != 1:
        return clouds
    else:
        # only patch-boundary points may move (identifyBoundaryPoints);
        # clouds without type tags keep the move-anything behavior
        smoothed = smooth_clouds(
            [(ps.positions, None if ps.types is None else ps.types == 1)
             for ps in clouds],
            threshold=float(sei.gs_smoothing_threshold),
            min_neighbors=MIN_NEIGHBORS,
            grid_size=sei.gs_smoothing_grid_size_minus2 + 2,
            coord_bits=coord_bits, device=device)
    out = []
    for ps, (pos, keep, _moved) in zip(clouds, smoothed):
        pre = None
        if attr_transfer_filter_type and ps.colors is not None:
            pre = (ps.positions.copy(), ps.colors.copy())
        if ps.types is not None:
            # the density filter also only applies to boundary points:
            # raw/EOM/interior points (types 0) are exact by construction
            # and must survive smoothing untouched
            keep = keep | (ps.types != 1)
        colors = None if ps.colors is None else ps.colors[keep]
        if pre is not None and colors is not None:
            moved_kept = np.any(pos[keep] != ps.positions[keep], axis=1)
            if moved_kept.any():
                from ..ops.recolor import transfer_colors

                colors = colors.copy()
                colors[moved_kept] = transfer_colors(
                    pre[0].astype(np.float32), pre[1],
                    pos[keep][moved_kept].astype(np.float32),
                    k=8,
                )
        ps2 = PointSet(
            positions=pos[keep],
            colors=colors,
            reflectances=(
                None if ps.reflectances is None else ps.reflectances[keep]
            ),
            types=None if ps.types is None else ps.types[keep],
            partition=None if ps.partition is None else ps.partition[keep],
        )
        out.append(_remove_duplicates(ps2, device))
    return out
