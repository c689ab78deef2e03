"""SEI-driven decoder post-processing, shared by encoder (closed loop) and
decoder so both reconstruct identical clouds.

Port of ``rabbit_transcoding_tpu/codec/postprocess.py``: the parameters
come from the geometry- and attribute-smoothing SEIs; the grid filters run
on ``device`` (``ops/smoothing.py``), and so does the KNN of the full-KNN
geometry smoothing that the encoder's closed loop runs without an SEI.

The grid geometry smoothing is one device pass a batch of clouds: the
filter (on a card the kernel of ``csrc/grid_smooth.cu``), the rows it keeps,
the first of each position among them and their compaction all stay on
the device, and one download brings back the survivors' positions and
row indices; the host then takes each attribute array once per cloud.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import numpy as np
import torch

from ..bitstream.sei import Sei, SeiAttributeSmoothing, SeiGeometrySmoothing
from ..core.pointset import PointSet
from ..device import resolve, to_device, to_host
from ..ops import smoothing as sm
from ..ops.smoothing import knn_smooth, smooth_colors_many
from ..utils import timing
from .reconstruct import first_occurrences

# fixed density-filter strength (both sides must agree; not SEI-coded)
MIN_NEIGHBORS = 4
# threads that take a batch's surviving rows on the host, a cloud each
# (numpy's take lets go of the interpreter lock; most of its time is the
# page faults of the new arrays)
_GATHER_THREADS = 4


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


def _note(**counts) -> None:
    """Count on the span open at the call (the decoder's stage)."""
    sp = timing.current()
    if sp is not None:
        for key, value in counts.items():
            sp.note(key, value)


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
    _note(points=sum(ps.point_count for ps in clouds),
          recolored=sum(n for _, n in smoothed))
    return clouds


def _remove_duplicates(ps: PointSet, device) -> PointSet:
    """``ps.remove_duplicates()`` with the search for the first of each
    position on ``device`` (the host's row sort of a few 100,000 points
    costs more than the smoothing filter itself)."""
    if ps.point_count == 0:
        return ps
    with timing.span("dedup"):
        return _first_of_each(ps, device)


def _first_of_each(ps: PointSet, device) -> PointSet:
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


def _smoothed_cloud(ps: PointSet, pos: np.ndarray, keep: np.ndarray,
                    attr_transfer_filter_type: int) -> PointSet:
    """The cloud ``ps`` with the smoothed positions ``pos`` and the points
    that ``keep`` holds."""
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
    return PointSet(
        positions=pos[keep],
        colors=colors,
        reflectances=(
            None if ps.reflectances is None else ps.reflectances[keep]
        ),
        types=None if ps.types is None else ps.types[keep],
        partition=None if ps.partition is None else ps.partition[keep],
    )


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
        return _grid_smoothing(clouds, sei, coord_bits,
                               attr_transfer_filter_type, resolve(device))
    _note(points=sum(ps.point_count for ps in clouds),
          moved=sum(int(moved) for _, _, moved in smoothed))
    out = []
    for ps, (pos, keep, _moved) in zip(clouds, smoothed):
        with timing.span("smooth_filter"):
            ps2 = _smoothed_cloud(ps, pos, keep, attr_transfer_filter_type)
        out.append(_remove_duplicates(ps2, device))
    return out


def _grid_smoothing(clouds: list[PointSet], sei: SeiGeometrySmoothing,
                    coord_bits: int, attr_transfer_filter_type: int,
                    device: torch.device) -> list[PointSet]:
    """The grid filter of SEI method 1 over ``clouds``, batched.  Only
    patch-boundary points (types 1; every point of a cloud without types)
    may move (identifyBoundaryPoints), and only they may be dropped by the
    density test; then the first point at each position is kept."""
    out = [None if ps.point_count else _rows(ps, np.zeros(0, np.int64),
                                              ps.positions[:0])
           for ps in clouds]
    members = [i for i, ps in enumerate(clouds) if ps.point_count]
    threshold = float(np.float32(sei.gs_smoothing_threshold))
    grid_size = sei.gs_smoothing_grid_size_minus2 + 2
    grid_dim = max(2, (1 << coord_bits) // grid_size)
    moved = 0
    for batch in sm._batches(members):
        todo = [clouds[i] for i in batch]
        counts = [ps.point_count for ps in todo]
        # cloud by cloud: no host copy of the batch's positions
        pts = torch.cat([to_device(np.ascontiguousarray(
            ps.positions, np.int32), device) for ps in todo])
        eligible = to_device(np.concatenate([
            np.ones(n, bool) if ps.types is None else ps.types == 1
            for ps, n in zip(todo, counts)]), device)
        new, keep, move = sm.smooth_grid(
            pts, eligible, counts, threshold,
            float(np.float32(MIN_NEIGHBORS)), grid_size, grid_dim)
        with timing.span("dedup"):
            n_moved, deduped, survivors = _survivors(
                new, keep | ~eligible, move, counts)
        moved += n_moved
        with timing.span("smooth_filter"), cf.ThreadPoolExecutor(
                min(_GATHER_THREADS, len(batch))) as ex:
            smoothed = ex.map(
                lambda job: _smoothed(*job, deduped,
                                      attr_transfer_filter_type),
                [(ps, *rows) for ps, rows in zip(todo, survivors)])
            for i, cloud in zip(batch, smoothed):
                out[i] = cloud
    _note(points=sum(ps.point_count for ps in clouds), moved=moved)
    return out


def _survivors(new: torch.Tensor, kept: torch.Tensor, move: torch.Tensor,
               counts: list[int]):
    """The rows of a batch of clouds (``counts`` points each) that ``kept``
    holds, and of those the first at each (cloud, position), found and
    compacted on the device and brought to the host in one download with
    the new positions of the rows that moved (the others' are the host's)
    -> (points moved, whether the first of each was found (not when a
    coordinate lies outside ``first_occurrences``' packed key), per cloud
    (its surviving rows, ascending, the indices into them of the rows that
    moved, and their positions (K, 3) int32))."""
    b = len(counts)
    rows = torch.nonzero(kept).squeeze(1)
    cloud = sm.cloud_index(counts, new.device)[rows]
    first = first_occurrences(cloud, new[rows])
    if first is not None:
        rows, cloud = rows[first], cloud[first]
    moved = torch.nonzero(move[rows]).squeeze(1)
    host = to_host(torch.cat([
        move.sum().view(1).int(), torch.bincount(cloud, minlength=b).int(),
        torch.bincount(cloud[moved], minlength=b).int(), rows.int(),
        moved.int(), new[rows[moved]].reshape(-1)]))
    kept_n, moved_n = host[1:1 + b], host[1 + b:1 + 2 * b]
    rows_h, moved_h, moved_pos = np.split(
        host[1 + 2 * b:], np.cumsum([kept_n.sum(), moved_n.sum()]))
    survivors = [
        (r - start, mv - offset, mp) for start, offset, r, mv, mp in zip(
            np.cumsum([0] + counts), np.cumsum([0, *kept_n]),
            np.split(rows_h, np.cumsum(kept_n)[:-1]),
            np.split(moved_h, np.cumsum(moved_n)[:-1]),
            np.split(moved_pos.reshape(-1, 3), np.cumsum(moved_n)[:-1]))]
    return int(host[0]), first is not None, survivors


def _smoothed(ps: PointSet, rows: np.ndarray, moved: np.ndarray,
              moved_pos: np.ndarray, deduped: bool,
              attr_transfer_filter_type: int) -> PointSet:
    """The cloud ``ps`` reduced to its surviving ``rows``, the rows
    ``moved`` of them at ``moved_pos``; without ``deduped`` the first of
    each position is found here."""
    positions = np.take(ps.positions, rows, axis=0).astype(np.int32,
                                                           copy=False)
    positions[moved] = moved_pos
    if not deduped:
        idx = np.unique(positions, axis=0, return_index=True)[1]
        idx.sort()
        rows, positions = rows[idx], positions[idx]
    return _rows(ps, rows, positions, attr_transfer_filter_type)


def _rows(ps: PointSet, rows: np.ndarray, positions: np.ndarray,
          attr_transfer_filter_type: int = 0) -> PointSet:
    """The cloud ``ps`` reduced to its rows ``rows`` (ascending), now at
    ``positions``; attr_transfer_filter_type != 0 gives the rows that moved
    the colours of the cloud before smoothing (``_smoothed_cloud``'s
    transfer)."""

    def take(a):
        return None if a is None else np.take(a, rows, axis=0)

    colors = take(ps.colors)
    if attr_transfer_filter_type and colors is not None:
        moved = np.any(positions != ps.positions[rows], axis=1)
        if moved.any():
            from ..ops.recolor import transfer_colors

            colors[moved] = transfer_colors(
                ps.positions.astype(np.float32), ps.colors,
                positions[moved].astype(np.float32), k=8)
    return PointSet(positions=positions, colors=colors,
                    reflectances=take(ps.reflectances), types=take(ps.types),
                    partition=take(ps.partition))
