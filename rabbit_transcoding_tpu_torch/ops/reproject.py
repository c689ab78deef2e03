"""Batched patch->3D reprojection and block-to-patch ownership, as torch ops.

Port of ``rabbit_transcoding_tpu/ops/reproject.py``.  The whole atlas is
processed as dense (frames, H, W) int32 tensors:

* ``block_to_patch``: the reference paints each patch's block bounding box
  onto the block grid in a scan over the patch table, the first-coded patch
  winning a contested block (``reverse``: the last-coded).  Here the same
  integers come from a closed form: the least (``reverse``: the greatest)
  patch index whose block box covers an occupied block, one reduction over a
  (F, maxP, nby, nbx) mask instead of maxP tiny steps.
* ``reproject``: every pixel takes its owning patch's parameters, applies
  the inverse placement orientation and becomes a 3D point by one-hot axis
  composition.  A patch's parameters are constant over a block, so they are
  gathered once per block and broadcast over the block's pixels through a
  (F, nby, bs, nbx, bs) view of the planes.  Invalid pixels (unoccupied or
  unowned) are masked, not dropped: the output stays dense.

Patch table layout (int32, PATCH_TABLE_FIELDS per patch):
  [cx0, cy0, cw, ch,  w, h,  u1, v1, d1,  normal, tangent, bitangent,
   proj_mode, orientation, lod_x, lod_y, rotation_axis, rot_offset]
where (cx0, cy0, cw, ch) is the canvas-space bounding box (orientation
already applied) and (w, h) the patch-space pixel size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.patch import Patch

PATCH_TABLE_FIELDS = 18

(
    F_CX0, F_CY0, F_CW, F_CH, F_W, F_H, F_U1, F_V1, F_D1,
    F_NORMAL, F_TANGENT, F_BITANGENT, F_PROJ_MODE, F_ORIENT, F_LODX, F_LODY,
    F_ROT, F_ROT_OFFSET,
) = range(PATCH_TABLE_FIELDS)


def build_patch_table(
    patch_lists: list[list[Patch]], max_patches: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame patch lists -> (table (F, maxP, FIELDS) int32,
    counts (F,) int32), padded to max_patches."""
    f = len(patch_lists)
    table = np.zeros((f, max_patches, PATCH_TABLE_FIELDS), np.int32)
    counts = np.zeros((f,), np.int32)
    for fi, patches in enumerate(patch_lists):
        counts[fi] = len(patches)
        for pi, p in enumerate(patches):
            cx0, cy0, cw, ch = p.canvas_bounds()
            table[fi, pi] = [
                cx0, cy0, cw, ch,
                p.size_u_pix, p.size_v_pix,
                p.u1, p.v1, p.d1,
                p.normal_axis, p.tangent_axis, p.bitangent_axis,
                p.projection_mode, int(p.orientation), p.lod_x, p.lod_y,
                p.rotation_axis, p.rot_offset,
            ]
    return table, counts


# ===========================================================================
def block_to_patch(
    occ: torch.Tensor,        # (F, H, W) uint8 binary occupancy
    table: torch.Tensor,      # (F, maxP, FIELDS) int32
    counts: torch.Tensor,     # (F,) int32
    block_size: int,
    reverse: bool = False,
) -> torch.Tensor:
    """-> (F, H/bs, W/bs) int32; 0 = unowned, k = owned by patch k-1.

    Default: the FIRST-coded patch covering a block owns it
    (asps_patch_precedence_order_flag=1).  reverse=True: the LAST-coded
    patch wins (flag=0)."""
    f, h, w = occ.shape
    bs = block_size
    nby, nbx = h // bs, w // bs
    dev = occ.device
    occ_block = occ[:, :nby * bs, :nbx * bs].reshape(
        f, nby, bs, nbx, bs).amax(dim=(2, 4)) > 0
    max_p = table.shape[1]
    if max_p == 0:
        return torch.zeros((f, nby, nbx), dtype=torch.int32, device=dev)
    table = table.to(torch.int32)
    x0 = (table[..., F_CX0] // bs)[:, :, None, None]
    y0 = (table[..., F_CY0] // bs)[:, :, None, None]
    x1 = ((table[..., F_CX0] + table[..., F_CW] + bs - 1) // bs)[
        :, :, None, None]
    y1 = ((table[..., F_CY0] + table[..., F_CH] + bs - 1) // bs)[
        :, :, None, None]
    bx = torch.arange(nbx, dtype=torch.int32, device=dev)[None, None, None, :]
    by = torch.arange(nby, dtype=torch.int32, device=dev)[None, None, :, None]
    idx = torch.arange(max_p, dtype=torch.int32, device=dev)
    coded = (idx[None, :] < counts.to(torch.int32)[:, None])[:, :, None, None]
    inside = ((bx >= x0) & (bx < x1) & (by >= y0) & (by < y1) & coded)
    idx = idx[None, :, None, None]
    if reverse:
        owner = torch.where(inside, idx, -1).amax(dim=1)
    else:
        owner = torch.where(inside, idx, max_p).amin(dim=1)
        owner = torch.where(owner == max_p, -1, owner)
    return torch.where(occ_block, owner + 1, 0).to(torch.int32)


# ===========================================================================
def _select(conds, cases, default):
    """The first case whose condition holds (``jnp.select``)."""
    out = default
    for cond, case in zip(reversed(conds), reversed(cases)):
        out = torch.where(cond, case, out)
    return out


def _inverse_orientation(dx, dy, w, h, orient):
    """Canvas-relative (dx, dy) -> patch (u, v) for all 8 orientations.
    Table matches core.patch.Patch.canvas_to_patch."""
    cases_u = [dx, dy, dy, w - 1 - dx, w - 1 - dy, w - 1 - dx, w - 1 - dy, dx]
    cases_v = [dy, dx, h - 1 - dx, h - 1 - dy, dx, dy, h - 1 - dx, h - 1 - dy]
    conds = [orient == i for i in range(8)]
    return _select(conds, cases_u, dx), _select(conds, cases_v, dy)


def reproject(
    geo: torch.Tensor,        # (F, H, W) integer depth plane
    occ: torch.Tensor,        # (F, H, W) uint8 binary occupancy
    table: torch.Tensor,      # (F, maxP, FIELDS) int32
    counts: torch.Tensor,     # (F,) int32
    block_size: int,
    reverse: bool = False,
):
    """-> (points (F, H*W, 3) int32, valid (F, H*W) bool, b2p (F, nby, nbx)).

    Every occupied pixel owned by a patch becomes one 3D point (the D0/near
    layer).  H and W are multiples of ``block_size``.  Output is dense and
    masked; compaction happens downstream."""
    f, h, w = geo.shape
    bs = block_size
    nby, nbx = h // bs, w // bs
    dev = geo.device
    b2p = block_to_patch(occ, table, counts, bs, reverse)

    pidx = b2p - 1                                       # -1 = unowned
    max_p = table.shape[1]
    safe = pidx.clamp(0, max(max_p - 1, 0)).long()
    frame = torch.arange(f, device=dev)[:, None, None]
    # (F, nby, 1, nbx, 1, FIELDS): one row per block, broadcast over pixels
    params = table.to(torch.int32)[frame, safe][:, :, None, :, None, :]

    def par(field):
        return params[..., field]

    def pix(x):
        return x.reshape(f, nby, bs, nbx, bs)

    valid = (pix(occ) > 0) & (pidx >= 0)[:, :, None, :, None]
    px = pix(torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
             .expand(f, h, w))
    py = pix(torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
             .expand(f, h, w))
    dx = px - par(F_CX0)
    dy = py - par(F_CY0)
    u, v = _inverse_orientation(dx, dy, par(F_W), par(F_H), par(F_ORIENT))
    depth = pix(geo.to(torch.int32))
    d = torch.where(par(F_PROJ_MODE) == 0, par(F_D1) + depth,
                    par(F_D1) - depth)
    tang = par(F_U1) + u * par(F_LODX)
    bitang = par(F_V1) + v * par(F_LODY)

    def axis(a):
        return (d * (par(F_NORMAL) == a) + tang * (par(F_TANGENT) == a)
                + bitang * (par(F_BITANGENT) == a))

    x_, y_, z_ = axis(0), axis(1), axis(2)
    # 45-degree patches: coordinates live in a rotated space; apply the
    # exact integer inverse rotation for the patch's axis: 1 = about Y,
    # 2 = about X, 3 = about Z.  The shifts are arithmetic (the sums can be
    # negative), never a division.
    rot = par(F_ROT)
    off = par(F_ROT_OFFSET)
    # about Y: sum in x', diff in z'
    y_dz = z_ - off
    y_x = (x_ - y_dz + 1) >> 1
    y_z = (x_ + y_dz + 1) >> 1
    # about X: diff in y', sum in z'
    x_dy = y_ - off
    x_y = (x_dy + z_ + 1) >> 1
    x_z = (z_ - x_dy + 1) >> 1
    # about Z: diff in x', sum in y'
    z_dx = x_ - off
    z_x = (z_dx + y_ + 1) >> 1
    z_y = (y_ - z_dx + 1) >> 1
    conds = [rot == 1, rot == 2, rot == 3]
    pts = torch.stack(
        [
            _select(conds, [y_x, x_, z_x], x_),
            _select(conds, [y_, x_y, z_y], y_),
            _select(conds, [y_z, x_z, z_], z_),
        ],
        dim=-1,
    )
    return pts.reshape(f, h * w, 3), valid.reshape(f, h * w), b2p
