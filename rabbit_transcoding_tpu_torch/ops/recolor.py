"""Attribute transfer (recolouring): source cloud -> reconstructed cloud.

The nearest-neighbour / inverse-distance transfer of
``rabbit_transcoding_tpu/ops/recolor.py`` (``transfer_colors``, a host
cKDTree lookup), which geometry smoothing calls to re-colour moved points.
The encoder's recolouring modes are not ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def transfer_colors(
    src_points: np.ndarray,
    src_colors: np.ndarray,
    dst_points: np.ndarray,
    k: int = 1,
) -> np.ndarray:
    """-> (M, 3) uint8 colors for dst_points.

    k=1 nearest-neighbour transfer (the reference's base mode); k>1 applies
    inverse-distance weighting over the k nearest source points."""
    if len(dst_points) == 0:
        return np.zeros((0, 3), np.uint8)
    tree = cKDTree(src_points)
    if k == 1:
        _, idx = tree.query(dst_points, k=1, workers=-1)
        return src_colors[idx]
    dist, idx = tree.query(dst_points, k=min(k, len(src_points)), workers=-1)
    if idx.ndim == 1:
        return src_colors[idx]
    w = 1.0 / np.maximum(dist, 1e-9)
    w /= w.sum(axis=1, keepdims=True)
    blended = (src_colors[idx].astype(np.float64) * w[..., None]).sum(axis=1)
    return np.clip(np.round(blended), 0, 255).astype(np.uint8)
