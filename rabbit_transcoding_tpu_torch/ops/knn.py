"""Grid-hash K-nearest-neighbour search on the device, as torch ops.

Port of ``rabbit_transcoding_tpu/ops/knn.py``.  Voxelised point clouds hash
into a uniform grid: the reference points are sorted by cell id and a CSR
start index is built over the cells; every query gathers up to ``cap``
candidates from each of its 27 neighbouring cells (masked), computes all
candidate distances at once and keeps the ``k`` smallest.  Queries run in
chunks, so that the (chunk, 27, cap, 3) candidate tensor stays bounded.

Exactness: neighbours are found within one cell radius (cell edge
``1 << cell_bits``); points farther away come back as unfound (``inf``
distance, index -1), which the callers handle.  Squared distances of
integer coordinates below 2^24 are exact in float32.  The ``k`` smallest are
taken by a stable sort of each query's candidates, so that equal distances
keep candidate order, as the reference's ``top_k`` keeps them: indices
equal the reference's, ties included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def grid_knn(
    queries: torch.Tensor,   # (Q, 3) integer
    refs: torch.Tensor,      # (R, 3) integer, on the queries' device
    k: int = 1,
    cell_bits: int = 2,      # cell edge = 4 voxels
    grid_dim: int = 256,
    cap: int = 32,           # most candidates taken per cell
    chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (squared distances (Q, k) float32, ``inf`` when unfound; indices
    (Q, k) int32 into ``refs``, -1 when unfound)."""
    dev = queries.device
    refs = refs.to(torch.int64)
    r_cell = (refs >> cell_bits).clamp(0, grid_dim - 1)
    r_id = (r_cell[:, 0] * grid_dim + r_cell[:, 1]) * grid_dim + r_cell[:, 2]
    order = torch.argsort(r_id, stable=True)
    sorted_refs = refs[order].to(torch.float32)
    n_cells = grid_dim ** 3
    counts = torch.bincount(r_id, minlength=n_cells)
    starts = torch.cumsum(counts, 0) - counts
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    n_refs = refs.shape[0]

    d2_out, idx_out = [], []
    for s in range(0, queries.shape[0], chunk):
        qc = queries[s:s + chunk].to(torch.int64)
        nb = (qc >> cell_bits).clamp(0, grid_dim - 1)[:, None, :] + offs
        valid_cell = ((nb >= 0) & (nb < grid_dim)).all(dim=-1)
        nb_id = ((nb[..., 0] * grid_dim + nb[..., 1]) * grid_dim
                 + nb[..., 2]).clamp(0, n_cells - 1)
        st = starts[nb_id]                                  # (C, 27)
        ct = counts[nb_id].clamp(max=cap)
        cand = st[..., None] + lane                         # (C, 27, cap)
        cand_valid = (lane < ct[..., None]) & valid_cell[..., None]
        cand = cand.clamp(0, n_refs - 1)
        diff = sorted_refs[cand] - qc[:, None, None, :].to(torch.float32)
        d2 = (diff * diff).sum(dim=-1)
        d2 = torch.where(cand_valid, d2, torch.inf)
        flat_d2 = d2.reshape(qc.shape[0], -1)
        top_d2, top_pos = torch.sort(flat_d2, dim=1, stable=True)
        top_d2, top_pos = top_d2[:, :k], top_pos[:, :k]
        top_sorted = torch.gather(cand.reshape(qc.shape[0], -1), 1, top_pos)
        d2_out.append(top_d2)
        idx_out.append(torch.where(torch.isinf(top_d2), -1,
                                   order[top_sorted]).to(torch.int32))
    if not d2_out:
        return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    return torch.cat(d2_out), torch.cat(idx_out)


def choose_cell_bits(refs: np.ndarray, k: int, coord_bits: int,
                     cap: int) -> int:
    """The largest cell that (a) gives every query enough in-radius
    candidates for ``k`` and (b) keeps the occupied cells under ``cap``
    points, measured on the data (one bincount per candidate size)."""
    r64 = refs.astype(np.int64)
    cell_bits = 1
    for cb in range(1, 6):
        gd = max(2, (1 << coord_bits) >> cb)
        ids = np.clip(r64 >> cb, 0, gd - 1) @ np.array([gd * gd, gd, 1],
                                                       np.int64)
        occ_counts = np.bincount(ids)
        occ_counts = occ_counts[occ_counts > 0]
        p99 = np.percentile(occ_counts, 99) if len(occ_counts) else 0
        median = np.median(occ_counts) if len(occ_counts) else 0
        cell_bits = cb
        if p99 > cap:
            cell_bits = max(1, cb - 1)
            break
        if median * 27 >= 4 * k:
            break
    return cell_bits


def knn(
    queries: np.ndarray,
    refs: np.ndarray,
    k: int = 1,
    cell_bits: int | None = None,
    coord_bits: int = 10,
    cap: int = 32,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Host wrapper with automatic cell sizing; the search runs on
    ``device``.  Returns (squared distances, indices) as host arrays;
    unfound neighbours have ``inf`` distance and index -1."""
    device = resolve(device)
    if cell_bits is None:
        cell_bits = choose_cell_bits(refs, k, coord_bits, cap)
    grid_dim = max(2, (1 << coord_bits) >> cell_bits)
    d2, idx = grid_knn(
        torch.from_numpy(queries.astype(np.int32)).to(device),
        torch.from_numpy(refs.astype(np.int32)).to(device),
        k=k, cell_bits=cell_bits, grid_dim=grid_dim, cap=cap,
    )
    return d2.cpu().numpy(), idx.cpu().numpy()
