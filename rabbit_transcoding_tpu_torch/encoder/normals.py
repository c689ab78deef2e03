"""Normal estimation: PCA over KNN neighborhoods.

Port of ``rabbit_transcoding_tpu/encoder/normals.py``.  Capability parity
with PCCNormalsGenerator3 (source/lib/PccLibEncoder/source/
PCCNormalsGenerator.cpp:61-533): per-point normals from the
eigen-decomposition of the local covariance, then sign orientation.

The KNN graph is built once on the host (the native voxel-grid KNN, or
scipy's cKDTree — the nanoflann analog); the per-point covariance + eigh and
the sweeps run batched as torch ops on the device the caller names (the card
unless it asks for the CPU).  Orientation is the native spanning-tree
propagation on the host; without the native library it falls back to
viewpoint disambiguation (flip toward the outward ray from the cloud
centroid) followed by KNN sign-consistency voting sweeps on the device.

Floats.  The covariances are reproduced: the reference's compiled CPU code
adds the k neighbours in index order and accumulates the 3x3 products in one
fused multiply-add chain over k (``_cov`` does the same, rounding once per
step).  The eigenvectors are not: ``torch.linalg.eigh`` (LAPACK on the CPU,
cuSOLVER on the card) and the reference's ``eigh`` agree to float32
precision where the smallest eigenvalue is simple, and pick different
vectors where it is repeated; the orientation fixes the sign afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..device import resolve
from ..ops.rbv_tools import fma


def _grid_knn(points: np.ndarray, k: int):
    """Native voxel-grid exact KNN when points are integral (V-PCC clouds
    always are); None -> caller falls back to cKDTree."""
    from .. import native

    if len(points) == 0:
        return None
    if not np.issubdtype(points.dtype, np.integer):
        if np.abs(points).max() >= 2**30 or (points != np.round(points)).any():
            return None
    try:
        return native.knn_grid(points, points, k)
    except (RuntimeError, ValueError, OverflowError):
        return None


def knn_indices(points: np.ndarray, k: int) -> np.ndarray:
    """(N, 3) -> (N, k) neighbor indices (self included as first column)."""
    got = _grid_knn(points, k)
    if got is not None:
        idx = got[0]
        return np.where(idx < 0, idx[:, :1], idx)  # tiny clouds: self pad
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)), workers=-1)
    if idx.ndim == 1:
        idx = idx[:, None]
    if idx.shape[1] < k:  # tiny clouds: pad with self
        pad = np.repeat(idx[:, :1], k - idx.shape[1], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return idx.astype(np.int32)


def _sum_k(x: torch.Tensor) -> torch.Tensor:
    """(N, k, ...) -> (N, ...): the k terms added in index order."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _cov(centered: torch.Tensor) -> torch.Tensor:
    """(N, k, 3) -> (N, 3, 3) scatter matrices ``sum_k c_i c_j``: one fused
    multiply-add chain over k in index order, as the reference's compiled
    einsum."""
    n, k, _ = centered.shape
    acc = torch.zeros(n, 3, 3, dtype=centered.dtype, device=centered.device)
    for j in range(k):
        c = centered[:, j]
        acc = fma(c[:, :, None].expand(n, 3, 3), c[:, None, :].expand(n, 3, 3),
                  acc)
    return acc


# matrices per ``torch.linalg.eigh`` call
_EIGH_BATCH = 16384


def _eigh(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of (N, 3, 3) matrices -> (ascending values,
    vectors), in batches of ``_EIGH_BATCH``: on the card cuSOLVER's batched
    solver refuses a large batch (``CUSOLVER_STATUS_INVALID_VALUE`` from
    32,767 matrices on, 16,384 pass; torch 2.11 with CUDA 12.8)."""
    if cov.shape[0] <= _EIGH_BATCH:
        return torch.linalg.eigh(cov)
    parts = [torch.linalg.eigh(c) for c in cov.split(_EIGH_BATCH)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _pca_normals(points: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Smallest-eigenvector normals of local covariance, batched per point."""
    nbrs = points[nbr_idx]                      # (N, k, 3)
    mean = (_sum_k(nbrs) / nbrs.shape[1])[:, None, :]
    cov = _cov(nbrs - mean)
    # eigh returns ascending eigenvalues; the smallest's vector is the normal
    _, vecs = _eigh(cov)
    return vecs[:, :, 0]


def _orient_sweep(normals: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """One sign-consistency sweep: flip each normal if the majority of its
    neighbors' normals disagree in sign."""
    nbr_n = normals[nbr_idx]                    # (N, k, 3)
    agree = (nbr_n * normals[:, None, :]).sum(dim=2)
    vote = agree.sum(dim=1)
    return torch.where(vote[:, None] < 0, -normals, normals)


def _unit(n: torch.Tensor) -> torch.Tensor:
    return n / torch.clamp(torch.linalg.norm(n, dim=1, keepdim=True),
                           min=1e-12)


def _orient_all(normals: torch.Tensor, points: torch.Tensor,
                nbr_idx: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Viewpoint disambiguation + all consistency sweeps + normalisation."""
    centroid = points.mean(dim=0, keepdim=True)
    outward = points - centroid
    flip = (normals * outward).sum(dim=1) < 0
    n = torch.where(flip[:, None], -normals, normals)
    for _ in range(sweeps):
        n = _orient_sweep(n, nbr_idx)
    return _unit(n)


def orient_spanning_tree(
    normals: np.ndarray,
    points: np.ndarray,
    nbr_idx: np.ndarray,
    nbr_ok: np.ndarray | None = None,
    viewpoint: tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> np.ndarray:
    """TRUE spanning-tree sign propagation (orientNormals,
    PCCNormalsGenerator.cpp:178-234): grow a maximum spanning tree over the
    KNN graph with |n_a.n_b| edge weights, flipping each point to agree
    with its tree parent; per-component seeding from visited neighbours
    and a final majority flip toward the viewpoint.

    Inherently sequential, so it runs in native C++
    (native/normals_tree.cpp); raises RuntimeError when the native library
    is unavailable — callers fall back to the sweep orientation."""
    from .. import native

    out = np.ascontiguousarray(normals, np.float32).copy()
    if nbr_ok is None:
        nbr_ok = np.ones(nbr_idx.shape, np.uint8)
    native.orient_normals_tree(
        out, points.astype(np.float32), nbr_idx, nbr_ok,
        np.asarray(viewpoint, np.float32),
    )
    return out


def _index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx)).to(device).long()


def compute_normals(
    points: np.ndarray,
    k: int = 16,
    orient_sweeps: int = 2,
    nbr_idx: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """-> (normals (N,3) float32 unit, knn indices (N,k)).  The KNN graph is
    returned for reuse by segmentation refinement.

    Orientation: spanning-tree propagation (the reference's default — it
    follows the surface, so thin sheets and multi-body scenes keep outward
    normals where global-viewpoint sweeps mis-orient).  Falls back to the
    viewpoint + consistency sweeps on the device when the native library is
    unavailable."""
    device = resolve(device)
    if nbr_idx is None:
        nbr_idx = knn_indices(points, k)
    pts = torch.from_numpy(points.astype(np.float32)).to(device)
    idx = _index(nbr_idx, device)
    n = _pca_normals(pts, idx)
    n_host = n.cpu().numpy()    # outside the try: a device error is no fallback
    try:
        n_np = orient_spanning_tree(n_host, points, nbr_idx)
        norm = np.linalg.norm(n_np, axis=1, keepdims=True)
        return (n_np / np.maximum(norm, 1e-12)).astype(np.float32), \
            np.asarray(nbr_idx)
    except RuntimeError:
        # viewpoint disambiguation + consistency sweeps on the device
        n = _orient_all(n, pts, idx, orient_sweeps)
        return n.cpu().numpy(), np.asarray(nbr_idx)


# ---------------------------------------------------------------------------
# Full PCCNormalsGenerator3 parameter surface (PccAppNormalGenerator analog).
#
# The reference (PCCNormalsGenerator.cpp:61-575 + PccAppNormalGenerator.cpp)
# exposes per-stage KNN counts, radius caps, iterative normal smoothing and
# four orientation strategies.  Same capabilities here, but each stage is one
# batched device pass over a host-built KNN graph instead of per-point TBB
# loops.


@dataclasses.dataclass
class NormalsGenParams:
    """PCCNormalsGenerator3Parameters analog (PCCNormalsGenerator.h)."""

    view_point: tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius_normal_smoothing: float = float("inf")
    radius_normal_estimation: float = float("inf")
    radius_normal_orientation: float = float("inf")
    weight_normal_smoothing: float = float("inf")  # MAX_VAL → pure neighbor avg
    knn_normal_smoothing: int = 16
    knn_normal_estimation: int = 16
    knn_normal_orientation: int = 16
    smoothing_iterations: int = 0
    # 0 NONE | 1 SPANNING_TREE | 2 VIEW_POINT | 3 CUBEMAP_PROJECTION
    orientation_strategy: int = 1
    store_eigenvalues: bool = False
    store_number_of_nearest_neighbors: bool = False
    store_centroids: bool = False


def knn_graph(points: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(N,3) -> ((N,k) indices incl. self, (N,k) distances)."""
    got = _grid_knn(points, k)
    if got is not None:
        idx, d2 = got
        return (np.where(idx < 0, idx[:, :1], idx),
                np.sqrt(d2))  # -1 pads carry inf distance already
    tree = cKDTree(points)
    dist, idx = tree.query(points, k=min(k, len(points)), workers=-1)
    if idx.ndim == 1:
        idx, dist = idx[:, None], dist[:, None]
    if idx.shape[1] < k:
        pad = k - idx.shape[1]
        idx = np.concatenate([idx, np.repeat(idx[:, :1], pad, axis=1)], axis=1)
        dist = np.concatenate(
            [dist, np.full((len(points), pad), np.inf)], axis=1
        )
    return idx.astype(np.int32), dist.astype(np.float32)


def _pca_normals_full(
    points: torch.Tensor, nbr_idx: torch.Tensor, nbr_ok: torch.Tensor,
    view_point: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radius-gated PCA normals + eigenvalues (ascending) + barycenters +
    per-point used-neighbor counts.  Estimation-time viewpoint sign flip
    matches the reference's computeNormal (PCCNormalsGenerator.cpp:148-151)."""
    nbrs = points[nbr_idx]                                # (N, k, 3)
    w = nbr_ok[..., None].to(points.dtype)                # (N, k, 1)
    count = torch.clamp(_sum_k(w), min=1.0)               # (N, 1)
    bary = _sum_k(nbrs * w) / count
    centered = (nbrs - bary[:, None, :]) * w
    cov = _cov(centered)
    cov = cov / torch.clamp(count - 1.0, min=1.0)[..., None]
    vals, vecs = _eigh(cov)                               # ascending
    n = vecs[:, :, 0]
    flip = (n * (view_point[None] - points)).sum(dim=1) < 0
    n = torch.where(flip[:, None], -n, n)
    return n, torch.abs(vals), bary, count[:, 0]


def _smooth_normals(
    normals: torch.Tensor, nbr_idx: torch.Tensor, nbr_ok: torch.Tensor,
    weight: float, iterations: int,
) -> torch.Tensor:
    """smoothNormals analog (PCCNormalsGenerator.cpp:533-573): per iteration
    each normal blends with the sign-aligned sum of its radius-gated
    neighbors: n <- normalize(w0*n + w2*normalize(sum sign*nbr))."""
    w2 = torch.tensor(float(weight), dtype=normals.dtype,
                      device=normals.device)
    w0 = 1.0 - w2
    # neighbor column 0 is self — the reference sums i in [1, count)
    ok = nbr_ok.clone()
    ok[:, 0] = False
    ok = ok[..., None].to(normals.dtype)
    n = normals
    for _ in range(iterations):
        nbr_n = n[nbr_idx]                                # (N, k, 3)
        sign = torch.sign((nbr_n * n[:, None, :]).sum(dim=2))[..., None]
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        acc = _unit((nbr_n * sign * ok).sum(dim=1))
        n = _unit(w0 * n + w2 * acc)
    return n


def _orient_cubemap(
    points: np.ndarray, normals: np.ndarray, nbr_idx: np.ndarray, sweeps: int = 8
) -> np.ndarray:
    """CUBEMAP_PROJECTION orientation (PCCNormalsGenerator.cpp:263-460):
    rasterize the cloud onto the 6 bounding-box faces; a point visible from a
    face gets its sign fixed toward that face's outward normal, then signs
    propagate to occluded points by majority vote over the KNN graph (the
    reference grows regions from visited seeds)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum((hi - lo).astype(np.int64) + 1, 1)
    face_normals = np.array(
        [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
        np.float32,
    )
    seed_sign = np.zeros(len(points), np.float32)
    seed_conf = np.zeros(len(points), np.float32)
    rel = (points - lo).astype(np.int64)
    for face in range(6):
        axis = face % 3
        u, v = (axis + 1) % 3, (axis + 2) % 3
        # the reference rasterizes 1:1 pixels (dense CTC clouds); coarsen the
        # plane for sparse clouds so columns actually occlude — without this
        # every point is "visible" from both opposing faces and the seeds
        # carry no information
        # target ~8 points per column: the surface is 2D, so a column must be
        # wide enough to catch both the front and back sheets before its
        # min-depth winner means "visible"
        shift = 0
        while ((span[u] >> shift) * (span[v] >> shift)
               > max(len(points) // 8, 1)):
            shift += 1
        pix = (rel[:, u] >> shift) * ((span[v] >> shift) + 1) + (
            rel[:, v] >> shift)
        depth = rel[:, axis] if face < 3 else span[axis] - 1 - rel[:, axis]
        order = np.lexsort((depth, pix))
        first = np.ones(len(points), bool)
        first[1:] = pix[order][1:] != pix[order][:-1]
        visible = order[first]
        # seed from the best-aligned face a point is visible from: a face
        # tangent to the surface says nothing about the sign
        agree = np.einsum("nc,c->n", normals[visible], face_normals[face])
        better = np.abs(agree) > seed_conf[visible]
        upd = visible[better]
        seed_sign[upd] = np.where(agree[better] >= 0, 1.0, -1.0)
        seed_conf[upd] = np.abs(agree[better])
    sign = seed_sign.copy()
    # only confident seeds (face nearly parallel to the normal) stay pinned;
    # tangent-face seeds are refined by propagation like unseeded points
    pinned = seed_conf > 0.5
    for _ in range(sweeps):
        # smoothness vote: neighbors' oriented normals should agree with ours
        nbr_n = normals[nbr_idx] * sign[nbr_idx][..., None]
        vote = np.einsum("nkc,nc->n", nbr_n, normals)
        new = np.where(vote != 0, np.sign(vote), sign)
        sign = np.where(pinned, seed_sign, new)
    sign = np.where(sign == 0, 1.0, sign)
    return normals * sign[:, None]


def generate_normals(
    points: np.ndarray, params: NormalsGenParams | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """PCCNormalsGenerator3::compute analog: estimation → optional smoothing
    → orientation.  Returns {'normals', and optionally 'eigenvalues',
    'centroids', 'nn_counts'} per the store* flags."""
    device = resolve(device)
    params = params or NormalsGenParams()
    pts32 = points.astype(np.float32)
    idx_e, dist_e = knn_graph(pts32, params.knn_normal_estimation)
    ok_e = dist_e <= params.radius_normal_estimation
    ok_e[:, 0] = True
    pts = torch.from_numpy(pts32).to(device)
    vp = torch.from_numpy(np.asarray(params.view_point, np.float32)).to(device)
    n, vals, bary, counts = _pca_normals_full(
        pts, _index(idx_e, device), torch.from_numpy(ok_e).to(device), vp
    )
    if params.smoothing_iterations > 0:
        if params.knn_normal_smoothing == params.knn_normal_estimation:
            idx_s, dist_s = idx_e, dist_e
        else:
            idx_s, dist_s = knn_graph(pts32, params.knn_normal_smoothing)
        ok_s = dist_s <= params.radius_normal_smoothing
        w2 = params.weight_normal_smoothing
        if not np.isfinite(w2):
            w2 = 1.0  # reference default MAX_VAL degenerates to neighbor avg
        n = _smooth_normals(
            n, _index(idx_s, device), torch.from_numpy(ok_s).to(device),
            float(np.float32(np.clip(w2, 0.0, 1.0))),
            params.smoothing_iterations,
        )
    strategy = params.orientation_strategy
    if strategy in (1, 2, 3):
        if params.knn_normal_orientation == params.knn_normal_estimation:
            idx_o, dist_o = idx_e, dist_e
        else:
            idx_o, dist_o = knn_graph(pts32, params.knn_normal_orientation)
        if strategy == 1:
            ok_o = dist_o <= params.radius_normal_orientation
            ok_o[:, 0] = True
            n_host = n.cpu().numpy()
            try:
                n = torch.from_numpy(orient_spanning_tree(
                    n_host, pts32, idx_o, ok_o, params.view_point,
                )).to(device)
            except RuntimeError:  # no native lib: sweep fallback
                n = _orient_all(n, pts, _index(idx_o, device), 2)
        elif strategy == 2:
            flip = np.einsum(
                "nc,nc->n", n.cpu().numpy(),
                np.asarray(params.view_point, np.float32)[None] - pts32,
            ) < 0
            n = torch.where(torch.from_numpy(flip).to(device)[:, None], -n, n)
        else:
            n = torch.from_numpy(
                _orient_cubemap(pts32, n.cpu().numpy(), idx_o)).to(device)
    out = {"normals": _unit(n).cpu().numpy()}
    if params.store_eigenvalues:
        out["eigenvalues"] = vals.cpu().numpy()
    if params.store_centroids:
        out["centroids"] = bary.cpu().numpy()
    if params.store_number_of_nearest_neighbors:
        out["nn_counts"] = counts.cpu().numpy().astype(np.uint32)
    return out
