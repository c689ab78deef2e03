"""Temporal patch matching for spatially consistent packing + inter coding.

Capability parity with the reference's spatialConsistencyPackFlexible
(PCCEncoder.cpp:1268) and the inter-patch coding it enables: patches are
matched to the previous frame by projection identity + 3D bounding-box
overlap; matched patches keep their atlas position (stable video content ->
cheap P frames) and code as InterPatchDataUnits (deltas only).
"""

from __future__ import annotations

import numpy as np

from .segment import SegmentedPatch


def _bbox3d(seg: SegmentedPatch) -> tuple[np.ndarray, np.ndarray]:
    p = seg.patch
    lo = np.zeros(3, np.int64)
    hi = np.zeros(3, np.int64)
    lo[p.tangent_axis] = p.u1
    hi[p.tangent_axis] = p.u1 + p.size_u
    lo[p.bitangent_axis] = p.v1
    hi[p.bitangent_axis] = p.v1 + p.size_v
    if p.projection_mode == 0:
        lo[p.normal_axis] = p.d1
        hi[p.normal_axis] = p.d1 + p.size_d + 1
    else:
        lo[p.normal_axis] = p.d1 - p.size_d - 1
        hi[p.normal_axis] = p.d1
    return lo, hi


def _iou(a: SegmentedPatch, b: SegmentedPatch) -> float:
    lo_a, hi_a = _bbox3d(a)
    lo_b, hi_b = _bbox3d(b)
    inter = np.maximum(
        0, np.minimum(hi_a, hi_b) - np.maximum(lo_a, lo_b)
    ).prod()
    if inter == 0:
        return 0.0
    vol_a = np.maximum(1, hi_a - lo_a).prod()
    vol_b = np.maximum(1, hi_b - lo_b).prod()
    return float(inter) / float(vol_a + vol_b - inter)


def pad_seg_to_quantizer(seg: SegmentedPatch, qx: int, qy: int) -> None:
    """Pad a SegmentedPatch's arrays up to (qx, qy) multiples so the coded
    pdu_2d_size_{x,y} (in ath_patch_size_*_info_quantizer units) equal the
    exact patch dims — the placement-orientation inverses and the PLR block
    maps require exact coded sizes (see PARITY invariants)."""
    su, sv = seg.occupancy.shape
    nu = -(-su // qx) * qx
    nv = -(-sv // qy) * qy
    if (nu, nv) == (su, sv):
        return

    def pad2(a, fill):
        out = np.full((nu, nv), fill, a.dtype)
        out[:su, :sv] = a
        return out

    seg.occupancy = pad2(seg.occupancy, False)
    seg.depth0 = pad2(seg.depth0, -1)
    seg.depth1 = pad2(seg.depth1, -1)
    if seg.eom is not None:
        seg.eom = pad2(seg.eom, 0)
    p = seg.patch
    res = p.occupancy_resolution
    p.size_u, p.size_v = nu, nv
    p.size_u0 = (nu + res - 1) // res
    p.size_v0 = (nv + res - 1) // res


def align_matched_patch(
    seg: SegmentedPatch,
    ref: SegmentedPatch,
    max_grow: int = 48,
    max_depth: int = 1023,
    max_size_d: int = 255,
    qx: int = 1,
    qy: int = 1,
) -> None:
    """Rebase a matched patch's 3D offsets (u1/v1/d1) onto the reference's
    so identical surface voxels land on identical canvas pixels with
    identical depth-plane values — this is what makes the video P-frames
    cheap.  Alignment happens per axis and only when the reference offset
    contains the patch's (maps are padded, never cropped)."""
    p = seg.patch
    r = ref.patch
    du = p.u1 - r.u1
    dv = p.v1 - r.v1
    if 0 < du <= max_grow:
        seg.depth0 = np.pad(seg.depth0, ((du, 0), (0, 0)),
                            constant_values=-1)
        seg.depth1 = np.pad(seg.depth1, ((du, 0), (0, 0)),
                            constant_values=-1)
        seg.occupancy = np.pad(seg.occupancy, ((du, 0), (0, 0)))
        if seg.eom is not None:
            seg.eom = np.pad(seg.eom, ((du, 0), (0, 0)))
        p.u1 = r.u1
        p.size_u += du
        du = 0
    if 0 < dv <= max_grow:
        seg.depth0 = np.pad(seg.depth0, ((0, 0), (dv, 0)),
                            constant_values=-1)
        seg.depth1 = np.pad(seg.depth1, ((0, 0), (dv, 0)),
                            constant_values=-1)
        seg.occupancy = np.pad(seg.occupancy, ((0, 0), (dv, 0)))
        if seg.eom is not None:
            seg.eom = np.pad(seg.eom, ((0, 0), (dv, 0)))
        p.v1 = r.v1
        p.size_v += dv
        dv = 0
    # depth rebase: shift relative depths so the coded plane values align
    dd = (p.d1 - r.d1) if p.projection_mode == 0 else (r.d1 - p.d1)
    if 0 < dd <= max_grow:
        occ = seg.occupancy
        if seg.depth1[occ].max(initial=0) + dd <= max_depth:
            seg.depth0 = np.where(occ, seg.depth0 + dd, -1)
            seg.depth1 = np.where(occ, seg.depth1 + dd, -1)
            p.d1 = r.d1
            # size_d stays within the coded range budget (informational
            # field; the depths themselves are bounded by max_depth above)
            p.size_d = min(p.size_d + dd, max_size_d)
    p.size_u0 = -(-p.size_u // p.occupancy_resolution)
    p.size_v0 = -(-p.size_v // p.occupancy_resolution)
    if qx > 1 or qy > 1:
        # u1/v1 alignment grows sizes by arbitrary deltas; re-pad so the
        # coded (quantized) sizes stay exact — PLR block maps and the
        # orientation inverses both derive from the coded sizes
        pad_seg_to_quantizer(seg, qx, qy)


def match_patches(
    prev: list[SegmentedPatch],
    cur: list[SegmentedPatch],
    iou_threshold: float = 0.25,
    max_candidate_count: int = 0,
) -> None:
    """Greedy best-IoU matching; sets cur[i].patch.best_match_idx to the
    matched prev index (-1 = unmatched).  Only same-projection patches match
    (inter coding inherits the projection from the reference).

    max_candidate_count > 0 keeps only the N best-IoU reference candidates
    per current patch before the greedy pass (reference maxCandidateCount,
    PCCEncoderParameters.cpp:82 — bounds the ordering search)."""
    for seg in cur:
        seg.patch.best_match_idx = -1
    if not prev or not cur:
        return
    per_cur: list[list[tuple[float, int, int]]] = [[] for _ in cur]
    for ci, c in enumerate(cur):
        for pi, pr in enumerate(prev):
            if (
                c.patch.normal_axis != pr.patch.normal_axis
                or c.patch.projection_mode != pr.patch.projection_mode
                or c.patch.rotation_axis != pr.patch.rotation_axis
            ):
                continue
            iou = _iou(c, pr)
            if iou >= iou_threshold:
                per_cur[ci].append((iou, ci, pi))
    if max_candidate_count > 0:
        for ci in range(len(cur)):
            per_cur[ci].sort(reverse=True)
            del per_cur[ci][max_candidate_count:]
    candidates = [t for lst in per_cur for t in lst]
    candidates.sort(reverse=True)
    used_cur: set[int] = set()
    used_prev: set[int] = set()
    for iou, ci, pi in candidates:
        if ci in used_cur or pi in used_prev:
            continue
        cur[ci].patch.best_match_idx = pi
        used_cur.add(ci)
        used_prev.add(pi)
