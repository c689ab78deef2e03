"""Geometry and colour smoothing (decoder post-processing), as torch ops.

Port of ``rabbit_transcoding_tpu/ops/smoothing.py``: the grid filters
``grid_smooth``, ``color_grid_smooth``, ``color_grid_smooth_gated`` with the
host wrappers ``smooth_cloud`` / ``smooth_colors``, the full-KNN geometry
smoothing ``knn_smooth`` (its KNN on the device, ``ops/knn.py``) and the
encoder's colour pre-smoothing ``presmooth_colors`` (host numpy over a
cKDTree, as in the reference).  One scatter-add builds
a per-cell accumulation grid for the whole cloud; each point gathers the
stats of its 27-cell neighbourhood in the fixed order of ``_OFFSETS``.

The reference pads a cloud to a power of two with weight-0 points; no sum
changes without them, so the port runs the real points only.  It can also
run several clouds in one call: ``group`` names each point's cloud, and
every cloud gets its own grid (its cells follow the previous cloud's in one
accumulator), so a GOF's frames cost a few hundred launches per batch
instead of per frame.  The host wrappers batch ``_BATCH_CLOUDS`` clouds.

Order of the scatter-add: the geometry sums and the colour sums add
integers below 2^24 and are exact in any order.  The gated colour filter
also adds luma values and their squares, which are not integers, so there
the order decides bits: the reference adds in point order, and so does
``_scatter_sum`` (a serial loop on the CPU; on CUDA ``index_put_`` with
``accumulate=True``, which sorts the indices stably and adds each cell's
points in that order, run to run the same).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from .rbv_tools import fma, scalar

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]

# BT.709 luma weights
_LW = tuple(float(np.float32(x)) for x in (0.2126, 0.7152, 0.0722))


def _scatter_sum(flat: torch.Tensor, vals: torch.Tensor,
                 cells: int) -> torch.Tensor:
    """(cells, C) float32 sums of the rows of ``vals`` (N, C) by cell
    ``flat`` (N,), each cell's rows added in point order."""
    acc = torch.zeros((cells, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    if vals.is_cuda:
        acc.index_put_((flat,), vals, accumulate=True)
        return acc
    cols = [torch.zeros(cells, dtype=torch.float32).index_add_(
        0, flat, vals[:, k].contiguous()) for k in range(vals.shape[1])]
    return torch.stack(cols, dim=1)


# clouds per call of the host wrappers: bounds the accumulators (a 128^3
# grid of 6 floats is 50 MB per cloud)
_BATCH_CLOUDS = 8


def _cells(points: torch.Tensor, grid_size: int, grid_dim: int, group):
    """Per point: its cell (N, 3), the flat index of its cloud's first cell
    (0 without ``group``) and the flat index of its cell."""
    gs = torch.tensor(grid_size, dtype=torch.int32, device=points.device)
    cell = torch.div(points, gs, rounding_mode="floor").clamp(
        0, grid_dim - 1).long()
    base = 0 if group is None else group.long() * grid_dim ** 3
    return cell, base, base + _flat(cell, grid_dim)


def _flat(cell: torch.Tensor, grid_dim: int) -> torch.Tensor:
    return (cell[:, 0] * grid_dim + cell[:, 1]) * grid_dim + cell[:, 2]


def _neighbours(cell: torch.Tensor, grid_dim: int, base):
    """The flat indices of the 27 neighbour cells, in ``_OFFSETS`` order
    (clamped at the grid's faces, as the reference clamps)."""
    for off in _OFFSETS:
        nb = (cell + torch.tensor(off, device=cell.device)).clamp(
            0, grid_dim - 1)
        yield base + _flat(nb, grid_dim)


def _dot_lw(x: torch.Tensor) -> torch.Tensor:
    """``x @ lw`` for (N, 3) float32 rows, in the reference's order."""
    return fma(x[:, 2], _LW[2], fma(x[:, 1], _LW[1], x[:, 0] * _LW[0]))


def grid_smooth(
    points: torch.Tensor,        # (N, 3) int32
    valid: torch.Tensor,         # (N,) bool
    threshold: float,            # sq distance triggering the centroid snap
    min_neighbors: float,        # below this 27-cell count -> drop point
    eligible: torch.Tensor,      # (N,) bool: only these may MOVE
    grid_size: int = 8,
    grid_dim: int = 128,
    group: torch.Tensor | None = None,   # (N,) each point's cloud
    groups: int = 1,
):
    """-> (points (N,3) int32, keep (N,) bool, moved (N,) bool)."""
    dev = points.device
    cell, base, flat = _cells(points, grid_size, grid_dim, group)
    w = valid.to(torch.float32)
    pf = points.to(torch.float32)
    acc = _scatter_sum(flat, torch.cat([pf * w[:, None], w[:, None]], dim=1),
                       groups * grid_dim ** 3)
    stats = torch.zeros((points.shape[0], 4), dtype=torch.float32, device=dev)
    for nb in _neighbours(cell, grid_dim, base):
        stats = stats + acc[nb]
    count = stats[:, 3]
    centroid = stats[:, :3] / torch.maximum(count, scalar(1.0, dev))[:, None]
    diff = pf - centroid
    d2 = _sum_squares(diff)
    # density test: the point itself contributes 1
    keep = valid & (count > min_neighbors)
    move = keep & eligible & (d2 > threshold) & (count > 4.0)
    out = torch.where(move[:, None], torch.round(centroid).to(torch.int32),
                      points)
    return out, keep, move


def _sum_squares(diff: torch.Tensor) -> torch.Tensor:
    """Sum of the squares of the 3 columns, in the reference's order."""
    return fma(diff[:, 2], diff[:, 2],
               fma(diff[:, 1], diff[:, 1], diff[:, 0] * diff[:, 0]))


def color_grid_smooth(
    points: torch.Tensor,       # (N, 3) int32
    colors: torch.Tensor,       # (N, 3) uint8
    valid: torch.Tensor,        # (N,) bool
    threshold: float,           # luma distance beyond which a point snaps
    grid_size: int = 8,
    grid_dim: int = 128,
    group: torch.Tensor | None = None,
    groups: int = 1,
):
    """Colour smoothing without patch indices: points whose colour deviates
    from their neighbourhood mean by more than ``threshold`` (BT.709 luma
    distance) are pulled to the mean.  -> (colors (N,3) uint8, moved)."""
    dev = points.device
    cell, base, flat = _cells(points, grid_size, grid_dim, group)
    w = valid.to(torch.float32)
    c = colors.to(torch.float32)
    acc = _scatter_sum(flat, torch.cat([c * w[:, None], w[:, None]], dim=1),
                       groups * grid_dim ** 3)
    stats = torch.zeros((points.shape[0], 4), dtype=torch.float32, device=dev)
    for nb in _neighbours(cell, grid_dim, base):
        stats = stats + acc[nb]
    count = torch.maximum(stats[:, 3], scalar(1.0, dev))
    mean = stats[:, :3] / count[:, None]
    dev_l = torch.abs(_dot_lw(c - mean))
    move = valid & (dev_l > threshold) & (stats[:, 3] > 4.0)
    out = torch.where(
        move[:, None],
        torch.clamp(torch.round(mean), 0, 255).to(torch.uint8), colors)
    return out, move


def color_grid_smooth_gated(
    points: torch.Tensor,        # (N, 3) int32
    colors: torch.Tensor,        # (N, 3) uint8
    valid: torch.Tensor,         # (N,) bool
    partition: torch.Tensor,     # (N,) int32 patch index per point
    eligible: torch.Tensor,      # (N,) bool: boundary points only
    threshold: float,            # thresholdColorSmoothing
    thr_variation: float,        # thresholdColorVariation
    thr_difference: float,       # thresholdColorDifference
    grid_size: int = 8,
    grid_dim: int = 128,
    group: torch.Tensor | None = None,
    groups: int = 1,
):
    """Fully gated colour smoothing: a boundary point's colour snaps to its
    neighbourhood mean only when
      - its own cell holds points of more than one patch,
      - the cell's luma spread (std-dev) is at most thr_variation,
      - neighbour cells whose luma mean differs from the own cell's by more
        than thr_difference are excluded from the centroid,
      - the luma distance to the centroid (x10) reaches threshold.
    -> (colors (N,3) uint8, moved (N,) bool)."""
    dev = points.device
    n = points.shape[0]
    cells = groups * grid_dim ** 3
    one = scalar(1.0, dev)
    cell, base, flat = _cells(points, grid_size, grid_dim, group)
    w = valid.to(torch.float32)
    c = colors.to(torch.float32)
    lum = _dot_lw(c)
    acc = _scatter_sum(
        flat,
        torch.cat([c * w[:, None], w[:, None], (lum * w)[:, None],
                   (lum * lum * w)[:, None]], dim=1),
        cells)
    big = 1 << 30
    part = partition.to(torch.int32)
    pmin = torch.full((cells,), big, dtype=torch.int32, device=dev)
    pmax = torch.full((cells,), -big, dtype=torch.int32, device=dev)
    pmin.scatter_reduce_(0, flat, torch.where(valid, part, big), "amin")
    pmax.scatter_reduce_(0, flat, torch.where(valid, part, -big), "amax")

    def spread(st):
        cnt = torch.maximum(st[:, 3], one)
        mean_lum = st[:, 4] / cnt
        var = torch.clamp(_variance(st[:, 5] / cnt, mean_lum), min=0.0)
        return mean_lum, torch.sqrt(var)

    own_mean_lum, own_sd = spread(acc[flat])
    own_ok = own_sd <= thr_variation
    mixed = pmax[flat] != pmin[flat]

    csum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ccnt = torch.zeros((n,), dtype=torch.float32, device=dev)
    for nb in _neighbours(cell, grid_dim, base):
        st = acc[nb]
        mean_lum, sd = spread(st)
        use = ((st[:, 3] > 0.0)
               & (torch.abs(mean_lum - own_mean_lum) <= thr_difference)
               & (sd <= thr_variation)).to(torch.float32)
        # use is 0 or 1: the products are exact, fused or not
        csum = csum + st[:, :3] * use[:, None]
        ccnt = ccnt + st[:, 3] * use
    mean = csum / torch.maximum(ccnt, one)[:, None]
    dev_l = torch.abs(lum - _dot_lw(mean)) * 10.0
    move = (valid & eligible & mixed & own_ok & (dev_l >= threshold)
            & (ccnt > 0.0))
    out = torch.where(
        move[:, None],
        torch.clamp(torch.round(mean), 0, 255).to(torch.uint8), colors)
    return out, move


def _variance(mean_sq: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """E[x^2] - E[x]^2 as the reference's compiled code forms it: one fused
    multiply-add, fma(-mean, mean, mean_sq)."""
    return fma(-mean, mean, mean_sq)


def _color_grid(positions: np.ndarray, grid_size: int,
                coord_bits: int) -> tuple[int, int]:
    """(grid_size, grid_dim) of a cloud's colour grid."""
    # clamp the cell grid to the occupied extent (rounded to a power of two)
    occ_dim = int(positions.max()) // grid_size + 2
    grid_dim = max(2, min(
        (1 << coord_bits) // grid_size,
        1 << (occ_dim - 1).bit_length(),
    ))
    # memory guard: coarsen the cell size instead of a grid beyond 128^3;
    # both sides derive the same grid from the same decoded cloud
    while grid_dim > 128:
        grid_size *= 2
        grid_dim = (grid_dim + 1) // 2
    return grid_size, grid_dim


def _batches(indices: list[int]):
    for i in range(0, len(indices), _BATCH_CLOUDS):
        yield indices[i:i + _BATCH_CLOUDS]


def _stacked(arrays: list, dtype, device) -> torch.Tensor:
    """The clouds' arrays, one after another, on the device."""
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate(arrays), dtype)).to(device)


def _groups(counts: list[int], device) -> torch.Tensor:
    """(N,) the index of each point's cloud within its batch."""
    return torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.tensor(counts, device=device))


def smooth_colors_many(
    clouds: list[tuple],
    threshold: float = 10.0,
    grid_size: int = 8,
    coord_bits: int = 10,
    threshold_variation: float = 255.0,
    threshold_difference: float = 255.0,
    device: torch.device | str = "cuda",
) -> list[tuple[np.ndarray, int]]:
    """Colour smoothing of several clouds, each a tuple (positions, colors,
    partition or None, eligible or None) -> per cloud (colors, moved
    count), as ``smooth_colors`` gives them one by one.  Clouds of one grid
    run batched."""
    device = resolve(device)
    out: list = [None] * len(clouds)
    by_grid: dict[tuple, list[int]] = {}
    for i, (positions, colors, partition, _) in enumerate(clouds):
        if len(positions) == 0:
            out[i] = (colors, 0)
            continue
        key = _color_grid(positions, grid_size, coord_bits) + (
            partition is None,)
        by_grid.setdefault(key, []).append(i)
    thr = float(np.float32(threshold))
    for (gsize, gdim, plain), members in by_grid.items():
        for batch in _batches(members):
            counts = [len(clouds[i][0]) for i in batch]
            pts = _stacked([clouds[i][0] for i in batch], np.int32, device)
            cols = _stacked([clouds[i][1] for i in batch], np.uint8, device)
            valid = torch.ones(len(pts), dtype=torch.bool, device=device)
            group = _groups(counts, device)
            if plain:
                new, moved = color_grid_smooth(
                    pts, cols, valid, thr, gsize, gdim, group, len(batch))
            else:
                part = _stacked([clouds[i][2] for i in batch], np.int32,
                                device)
                elig = _stacked(
                    [np.ones(n, bool) if clouds[i][3] is None
                     else clouds[i][3] for i, n in zip(batch, counts)],
                    bool, device)
                new, moved = color_grid_smooth_gated(
                    pts, cols, valid, part, elig, thr,
                    float(np.float32(threshold_variation)),
                    float(np.float32(threshold_difference)), gsize, gdim,
                    group, len(batch))
            moved = torch.bincount(group[moved], minlength=len(batch))
            for i, c, m in zip(batch, np.split(new.cpu().numpy(),
                                               np.cumsum(counts)[:-1]),
                               moved.cpu().tolist()):
                out[i] = (c, m)
    return out


def smooth_colors(
    positions: np.ndarray,
    colors: np.ndarray,
    threshold: float = 10.0,
    grid_size: int = 8,
    coord_bits: int = 10,
    partition: np.ndarray | None = None,
    eligible: np.ndarray | None = None,
    threshold_variation: float = 255.0,
    threshold_difference: float = 255.0,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, int]:
    """Host wrapper for colour smoothing.  With a per-point ``partition``
    (patch index) the fully gated algorithm runs; without one, the
    neighbourhood-mean filter."""
    return smooth_colors_many(
        [(positions, colors, partition, eligible)], threshold, grid_size,
        coord_bits, threshold_variation, threshold_difference, device)[0]


def smooth_clouds(
    clouds: list[tuple],
    threshold: float = 64.0,
    min_neighbors: int = 4,
    grid_size: int = 8,
    coord_bits: int = 10,
    device: torch.device | str = "cuda",
) -> list[tuple[np.ndarray, np.ndarray, int]]:
    """Grid geometry smoothing of several clouds, each a tuple (positions,
    eligible or None) -> per cloud (positions, keep mask, moved count), as
    ``smooth_cloud`` gives them one by one; the clouds run batched."""
    device = resolve(device)
    out: list = [None] * len(clouds)
    members = []
    for i, (positions, _) in enumerate(clouds):
        if len(positions) == 0:
            out[i] = (positions, np.zeros(0, bool), 0)
        else:
            members.append(i)
    grid_dim = max(2, (1 << coord_bits) // grid_size)
    for batch in _batches(members):
        counts = [len(clouds[i][0]) for i in batch]
        pts = _stacked([clouds[i][0] for i in batch], np.int32, device)
        elig = _stacked([np.ones(n, bool) if clouds[i][1] is None
                         else clouds[i][1] for i, n in zip(batch, counts)],
                        bool, device)
        valid = torch.ones(len(pts), dtype=torch.bool, device=device)
        group = _groups(counts, device)
        new, keep, moved = grid_smooth(
            pts, valid, float(np.float32(threshold)),
            float(np.float32(min_neighbors)), elig, grid_size, grid_dim,
            group, len(batch))
        moved = torch.bincount(group[moved], minlength=len(batch))
        cuts = np.cumsum(counts)[:-1]
        for i, p, k, m in zip(batch, np.split(new.cpu().numpy(), cuts),
                              np.split(keep.cpu().numpy(), cuts),
                              moved.cpu().tolist()):
            out[i] = (p, k, m)
    return out


def smooth_cloud(
    positions: np.ndarray,
    threshold: float = 64.0,
    min_neighbors: int = 4,
    grid_size: int = 8,
    coord_bits: int = 10,
    eligible: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host wrapper for grid geometry smoothing.
    eligible: optional (N,) bool: only these points may move (the patch
    boundary points); None = all movable.
    Returns (positions, keep mask over input order, moved count)."""
    return smooth_clouds([(positions, eligible)], threshold, min_neighbors,
                         grid_size, coord_bits, device)[0]


def knn_smooth(
    positions: np.ndarray,
    partition: np.ndarray,
    neighbor_count: int = 64,
    radius2: float = 64.0,
    radius2_boundary: float = 64.0,
    threshold: float = 64.0,
    eligible: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, int]:
    """Full-KNN geometry smoothing (PCCCodec::smoothPointCloud, the
    gridSmoothing=0 path; knobs neighborCountSmoothing / radius2Smoothing /
    radius2BoundaryDetection / thresholdSmoothing).

    Per point: neighbours within sqrt(radius2) (at most neighbor_count); if
    any neighbour within sqrt(radius2_boundary) belongs to a DIFFERENT patch
    and the rounded-centroid distance reaches ``threshold``, the point snaps
    to the rounded neighbourhood centroid (the reference's integer
    rounding).  The KNN runs on ``device``; the rest is host integer
    arithmetic."""
    from .knn import grid_knn

    n = len(positions)
    if n == 0:
        return positions, 0
    k = max(1, neighbor_count)
    if k > 64:
        import sys

        print(
            f"warning: neighborCountSmoothing={k} exceeds the device KNN "
            "kernel's 64-neighbor tile; smoothing with 64",
            file=sys.stderr,
        )
        k = 64
    pos = positions.astype(np.int32)
    pos_dev = torch.from_numpy(pos).to(resolve(device))
    d2, idx = grid_knn(pos_dev, pos_dev, k=min(k, 64),
                       cap=max(32, min(k, 64)))
    d2 = d2.cpu().numpy()
    idx = idx.cpu().numpy()
    inr = (d2 <= radius2) & (idx >= 0)
    safe = np.clip(idx, 0, n - 1)
    cnt = inr.sum(axis=1)
    centroid = (pos[safe] * inr[..., None]).sum(axis=1)
    other = (
        inr & (d2 <= radius2_boundary)
        & (partition[safe] != partition[:, None])
    ).any(axis=1)
    nc = np.maximum(cnt, 1)
    # the reference's integer centroid rounding
    cent_i = ((centroid + (nc // 2)[:, None]) // nc[:, None]).astype(np.int64)
    # reference: |sum(neighbors) - n*point|^2 / n  ==  n * |mean - point|^2
    d2c = np.floor(
        ((centroid - pos * nc[:, None]).astype(np.float64) ** 2).sum(axis=1)
        + nc / 2.0
    ) / nc
    move = other & (d2c >= threshold)
    if eligible is not None:
        move &= eligible
    out = pos.copy()
    out[move] = cent_i[move].astype(np.int32)
    return out, int(move.sum())


def presmooth_colors(
    positions: np.ndarray,
    colors: np.ndarray,
    eligible: np.ndarray | None = None,
    radius2: float = 64.0,
    max_neighbors: int = 64,
    threshold: float = 10.0,
    entropy_threshold: float = 4.5,
) -> tuple[np.ndarray, int]:
    """Encoder-side colour pre-smoothing (presmoothPointCloudColor: radius
    KNN per boundary point; the colour snaps to the neighbourhood centroid
    only where the local luma ENTROPY is low, flat regions, and the L1
    colour distance to the centroid reaches thresholdColorPreSmoothing).
    Invisible to the decoder."""
    from scipy.spatial import cKDTree

    n = len(positions)
    if n == 0:
        return colors, 0
    k = min(max(1, max_neighbors), n)
    tree = cKDTree(positions)
    cand = np.arange(n) if eligible is None else np.nonzero(eligible)[0]
    if len(cand) == 0:
        return colors, 0
    d, idx = tree.query(positions[cand], k=k)
    if k == 1:
        d = d[:, None]
        idx = idx[:, None]
    inr = (d * d) <= radius2
    nc = np.maximum(inr.sum(axis=1), 1)
    cols = colors.astype(np.int64)
    centroid = (cols[idx] * inr[..., None]).sum(axis=1)
    centroid = (centroid + (nc // 2)[:, None]) // nc[:, None]
    # local luma Shannon entropy over the in-radius neighbors
    lum = (
        0.2126 * cols[idx][..., 0] + 0.7152 * cols[idx][..., 1]
        + 0.0722 * cols[idx][..., 2]
    ).astype(np.int32)
    # per-row Shannon entropy: in-radius luma values scatter-added into a
    # (rows, 256) histogram
    rows = len(cand)
    hist = np.zeros((rows, 256), np.int32)
    rr = np.repeat(np.arange(rows), k)
    lv = np.clip(lum.reshape(-1), 0, 255)
    sel = inr.reshape(-1)
    np.add.at(hist, (rr[sel], lv[sel]), 1)
    tot = np.maximum(hist.sum(axis=1, keepdims=True), 1)
    pmat = hist / tot
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.where(pmat > 0, pmat * np.log2(pmat), 0.0).sum(axis=1)
    dist1 = np.abs(centroid - cols[cand]).sum(axis=1)
    move = (dist1 >= threshold) & (ent < entropy_threshold)
    out = colors.copy()
    out[cand[move]] = np.clip(centroid[move], 0, 255).astype(colors.dtype)
    return out, int(move.sum())
