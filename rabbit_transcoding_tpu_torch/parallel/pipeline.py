"""The decoder's reconstruction and the metrics' nearest-neighbour reduction
over a device mesh.

Port of ``rabbit_transcoding_tpu/parallel/pipeline.py``.  Neither stage has
a stream or space axis of its own, so both split over every device of the
mesh (both axes flattened, in row order):

* ``sharded_reproject``: ``ops/reproject.reproject`` is frame-local, so the
  frames split over the devices (sizes may differ by one) and the results
  come back to the caller's device in frame order, equal to the one-device
  call;
* ``make_sharded_nn_mse``: the queries split over the devices, the
  reference set is copied to each, ``ops/knn.grid_knn`` runs per shard, and
  the (sum, count, unfound) partials are added on the mesh's first device
  in shard order.

Every shard launches before any partial comes back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import knn as knn_ops
from ..ops import reproject as repro_ops
from .mesh import Mesh, gather, scatter


def _tensor(x, device: torch.device) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x)).to(device)


def sharded_reproject(
    mesh: Mesh,
    geo,                  # (F, H, W) integer depth plane
    occ,                  # (F, H, W) binary occupancy
    table,                # (F, maxP, FIELDS) patch table
    counts,               # (F,)
    block_size: int,
    reverse: bool = False,
):
    """``ops/reproject.reproject`` with the frames split over every mesh
    device -> (points, valid, b2p) on ``geo``'s device (tensors, or numpy
    arrays that go to the mesh's first device), equal to the one-device
    call: the computation is frame-local, so the split changes the device
    assignment and nothing else."""
    dev = geo.device if isinstance(geo, torch.Tensor) else mesh.first
    geo, occ, table, counts = (_tensor(x, dev)
                               for x in (geo, occ, table, counts))
    devices = mesh.flat
    shards = [scatter(x, devices) for x in (geo.to(torch.int32), occ, table,
                                            counts)]
    outs = [repro_ops.reproject(g, o, t, c, block_size, reverse=reverse)
            for g, o, t, c in zip(*shards) if g is not None]
    return tuple(gather([o[k] for o in outs], dev) for k in range(3))


def make_sharded_nn_mse(
    mesh: Mesh,
    k_cell_bits: int = 2,
    grid_dim: int = 256,
    cap: int = 32,
    chunk: int = 4096,
):
    """The sharded D1-style reduction: mean squared nearest-neighbour
    distance of ``queries`` against ``refs``.  Returns ``nn_mse(queries,
    refs) -> float`` for integer (N, 3) host arrays.

    Each shard's squared distances (integers, exact in float32) are summed
    in float64, so every partial and the total are exact; the reference
    sums in float32, exact while a partial stays below 2^24, and the two
    are then equal.  Raises ``ValueError`` when a query finds no neighbour
    within the grid search radius."""

    def partial_sums(q: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        d2, _ = knn_ops.grid_knn(q, refs, k=1, cell_bits=k_cell_bits,
                                 grid_dim=grid_dim, cap=cap, chunk=chunk)
        d2 = d2[:, 0]
        unfound = torch.isinf(d2)
        found = torch.where(unfound, 0.0, d2)
        return torch.stack([found.sum(dtype=torch.float64),
                            torch.tensor(float(q.shape[0]),
                                         dtype=torch.float64,
                                         device=q.device),
                            unfound.sum(dtype=torch.float64)])

    def nn_mse(queries: np.ndarray, refs: np.ndarray) -> float:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.int32))
        r = torch.from_numpy(np.ascontiguousarray(refs, np.int32))
        devices = mesh.flat
        # the reference set copied once to each distinct device
        r_on = {d: r.to(d) for d in dict.fromkeys(devices)}
        parts = [partial_sums(c, r_on[d])
                 for d, c in zip(devices, scatter(q, devices))
                 if c is not None]
        total = torch.zeros(3, dtype=torch.float64, device=mesh.first)
        for p in parts:
            total = total + p.to(mesh.first)
        s, c, unfound = total.tolist()
        if unfound > 0:
            raise ValueError(
                f"{int(unfound)} queries found no neighbour within the "
                f"{(1 << k_cell_bits) * 3}-voxel grid search radius: "
                "increase cell_bits/cap for this content")
        return s / max(c, 1.0)

    return nn_mse
