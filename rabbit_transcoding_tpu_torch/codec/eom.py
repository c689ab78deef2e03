"""EOM (Enhanced Occupancy Mode) patches: points between D0 and D1.

Capability parity with the reference's EOM path (generateEomPatch,
PCCEncoder.cpp:4142; EOM recovery in PCCCodec raw/EOM reconstruction):
for (near-)lossless operation, surface voxels strictly between the near
and far depth layers are coded as per-pixel bit masks carried in the
lossless occupancy plane (value = 1 | bits<<1; bit k = depth D0+1+k
occupied), with their colors stored sequentially in the auxiliary
attribute video after the raw-points block.

Requires occupancyPrecision == 1 (downscaling would destroy the bit
planes), mirroring the reference's lossless CTC configuration.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.syntax import EOMPatchDataUnit
from ..core.patch import Patch

MAX_EOM_BITS = 7  # uint8 occupancy plane: 1 occupied bit + 7 EOM bits


def eom_bits_for_cells(
    points_rel: np.ndarray,   # (N,) internal-space depth rel to patch d1
    flat_cells: np.ndarray,   # (N,) flattened patch-space cell index
    depth0: np.ndarray,       # flattened D0 map (rel depths, -1 empty)
    depth1: np.ndarray,       # flattened D1 map
    max_bits: int = MAX_EOM_BITS,
) -> np.ndarray:
    """Bit mask per patch cell for points strictly between D0 and D1.
    max_bits = EOMFixBitCount (asps_eom_fix_bit_count): deeper interior
    points are not representable and stay in the missed set."""
    bits = np.zeros(depth0.shape, np.uint8)
    d0 = depth0[flat_cells]
    d1 = depth1[flat_cells]
    k = points_rel - d0 - 1
    between = (d0 >= 0) & (points_rel > d0) & (points_rel < d1) & (
        k < min(max_bits, MAX_EOM_BITS)
    ) & (k >= 0)
    np.bitwise_or.at(
        bits, flat_cells[between],
        np.left_shift(np.uint8(1), k[between].astype(np.uint8)),
    )
    return bits


def enumerate_frame_eom_points(
    patches: list[Patch],
    eom_plane: np.ndarray,   # (H, W) uint8 bit masks (atlas space)
    geo_plane: np.ndarray,   # (H, W) D0 relative depths
    b2p_pixel: np.ndarray,   # (H, W) int32 per-pixel owner (patch index + 1)
) -> np.ndarray:
    """Deterministic enumeration of a frame's EOM points: canvas raster
    order major, depth bit minor.  Encoder and decoder both call this, so
    the aux-video color stream aligns positionally."""
    ys, xs = np.nonzero(eom_plane)
    if len(ys) == 0:
        return np.zeros((0, 3), np.int32)
    owner = b2p_pixel[ys, xs] - 1
    bits = eom_plane[ys, xs]
    d0 = geo_plane[ys, xs].astype(np.int32)
    w = eom_plane.shape[1]

    all_pts = []
    all_keys = []
    for pi, patch in enumerate(patches):
        sel_p = owner == pi
        if not sel_p.any():
            continue
        pys, pxs = ys[sel_p], xs[sel_p]
        pbits, pd0 = bits[sel_p], d0[sel_p]
        for k in range(MAX_EOM_BITS):
            sel = (pbits >> k) & 1 > 0
            if not sel.any():
                continue
            u, v = patch.canvas_to_patch(pxs[sel], pys[sel])
            pts = patch.generate_point(u, v, pd0[sel] + 1 + k)
            all_pts.append(pts.reshape(-1, 3))
            all_keys.append(
                (pys[sel].astype(np.int64) * w + pxs[sel]) * MAX_EOM_BITS + k
            )
    if not all_pts:
        return np.zeros((0, 3), np.int32)
    pts = np.concatenate(all_pts, axis=0)
    keys = np.concatenate(all_keys)
    return pts[np.argsort(keys, kind="stable")].astype(np.int32)


def make_eom_patch_unit(total_points: int) -> EOMPatchDataUnit:
    return EOMPatchDataUnit(
        epdu_patch_in_auxiliary_video_flag=True,
        epdu_associated_patches_count_minus1=0,
        epdu_associated_patch_idx=[0],
        epdu_points=[total_points],
    )
