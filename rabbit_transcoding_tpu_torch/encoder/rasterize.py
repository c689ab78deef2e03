"""Rasterize segmented patches into atlas planes.

The encoder half of the atlas mapping (PCCEncoder::generateOccupancyMap /
generateGeometryVideo concept, PCCEncoder.cpp:152-227): each patch's
patch-space D0 depth map + occupancy scatter into the (H, W) canvas through
the patch's placement orientation.  Vectorised NumPy scatter per patch
(hundreds of patches, zero per-pixel Python loops).
"""

from __future__ import annotations

import numpy as np

from .segment import SegmentedPatch


def rasterize_frame(
    segs: list[SegmentedPatch], width: int, height: int,
    with_eom: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (geo0, geo1 (H, W) uint16 relative near/far depth, occ (H, W) uint8).

    with_eom: occupancy value = 1 | (eom_bits << 1) — the EOM bit planes ride
    the lossless occupancy video (requires occupancyPrecision 1)."""
    geo0 = np.zeros((height, width), np.uint16)
    geo1 = np.zeros((height, width), np.uint16)
    occ = np.zeros((height, width), np.uint8)
    for seg in segs:
        u, v = np.nonzero(seg.occupancy)
        if len(u) == 0:
            continue
        x, y = seg.patch.patch_to_canvas(u, v)
        geo0[y, x] = seg.depth0[u, v].astype(np.uint16)
        geo1[y, x] = seg.depth1[u, v].astype(np.uint16)
        if with_eom and seg.eom is not None:
            occ[y, x] = 1 | (seg.eom[u, v] << 1)
        else:
            occ[y, x] = 1
    return geo0, geo1, occ


def paint_attribute_frame(
    colors_rgb: np.ndarray,   # (N, 3) uint8 colors of valid pixels
    pixel_index: np.ndarray,  # (N,) flat pixel index (y * W + x)
    width: int,
    height: int,
) -> np.ndarray:
    """Scatter per-point colors back into an (H, W, 3) RGB canvas."""
    canvas = np.zeros((height * width, 3), np.uint8)
    canvas[pixel_index] = colors_rgb
    return canvas.reshape(height, width, 3)
