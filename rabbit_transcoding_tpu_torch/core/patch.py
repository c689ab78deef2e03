"""Patch representation + patch<->canvas<->3D geometry mapping.

Capability parity with PCCPatch (source/lib/PccLibCommon/
include/PCCPatch.h:1-524): atlas placement (u0,v0,size_u0,size_v0 in
occupancy-block units), 3D offsets (u1,v1,d1), projection axes, projection
mode, the 8 placement orientations, LoD scales, and the geometry mappings
``generatePoint`` / ``patch2Canvas`` / ``canvasTo3D``.

Design difference: every mapping has a **vectorised** form operating on whole
(u, v) index grids at once, because the TPU decoder reprojects entire patches
as single gather/scatter ops (see ops/reproject.py) — there is no per-pixel
``generatePoint`` loop anywhere in the hot path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.enums import PatchOrientation, PatchType


@dataclasses.dataclass
class Patch:
    index: int = 0
    # atlas placement, in occupancy-resolution block units
    u0: int = 0
    v0: int = 0
    size_u0: int = 0
    size_v0: int = 0
    # 3D offsets (tangent, bitangent, depth)
    u1: int = 0
    v1: int = 0
    d1: int = 0
    size_d: int = 0
    # exact pixel size of the patch (<= size_u0*occ_res etc.)
    size_u: int = 0
    size_v: int = 0
    # projection geometry
    normal_axis: int = 2
    tangent_axis: int = 0
    bitangent_axis: int = 1
    projection_mode: int = 0  # 0: d = d1 + depth ; 1: d = d1 - depth
    orientation: PatchOrientation = PatchOrientation.DEFAULT
    occupancy_resolution: int = 16
    lod_x: int = 1
    lod_y: int = 1
    patch_type: PatchType = PatchType.INTRA
    # point-local-reconstruction mode (0 = none; 1 = fill D0+1), single-map
    plr_mode: int = 0
    # block-level PLR: (size_v0, size_u0) uint8 mode grid in PATCH-LOCAL
    # block coords (orientation-free on both encode and decode sides, which
    # map canvas pixels through canvas_to_patch); None = patch-level only
    plr_block_modes: "np.ndarray | None" = None
    # 45-degree extended projection — the reference's axisOfAdditionalPlane
    # numbering (PCCCodec.cpp:2503): 0 = none, 1 = about Y (r = (x+z, y,
    # z-x+off)), 2 = about X (r = (x, y-z+off, y+z)), 3 = about Z
    # (r = (x-y+off, x+y, z)).  Each is an EXACT integer bijection (sum and
    # difference share parity), so inverse rotation loses nothing on clean
    # data and rounds half-units under geometry quantisation error.
    rotation_axis: int = 0
    rot_offset: int = 1024
    # inter prediction bookkeeping
    ref_index: int = -1
    best_match_idx: int = -1
    tile_index: int = 0
    frame_index: int = 0

    # ------------------------------------------------------------------
    @property
    def size_u_pix(self) -> int:
        return self.size_u if self.size_u else self.size_u0 * self.occupancy_resolution

    @property
    def size_v_pix(self) -> int:
        return self.size_v if self.size_v else self.size_v0 * self.occupancy_resolution

    # ------------------------------------------------------------------
    def patch_to_canvas(self, u, v, canvas_w: int | None = None):
        """Map patch coords -> canvas pixel coords for this patch's
        orientation.  Accepts scalars or arrays (vectorised).
        Orientation table documented in utils.enums.PatchOrientation;
        behavioural parity with PCCPatch::patch2Canvas (PCCPatch.h:211)."""
        u = np.asarray(u)
        v = np.asarray(v)
        w = self.size_u_pix
        h = self.size_v_pix
        x0 = self.u0 * self.occupancy_resolution
        y0 = self.v0 * self.occupancy_resolution
        o = self.orientation
        if o == PatchOrientation.DEFAULT:
            x, y = x0 + u, y0 + v
        elif o == PatchOrientation.SWAP:
            x, y = x0 + v, y0 + u
        elif o == PatchOrientation.ROT90:
            x, y = x0 + (h - 1 - v), y0 + u
        elif o == PatchOrientation.ROT180:
            x, y = x0 + (w - 1 - u), y0 + (h - 1 - v)
        elif o == PatchOrientation.ROT270:
            x, y = x0 + v, y0 + (w - 1 - u)
        elif o == PatchOrientation.MIRROR:
            x, y = x0 + (w - 1 - u), y0 + v
        elif o == PatchOrientation.MROT90:
            x, y = x0 + (h - 1 - v), y0 + (w - 1 - u)
        elif o == PatchOrientation.MROT180:
            x, y = x0 + u, y0 + (h - 1 - v)
        else:
            raise ValueError(f"bad orientation {o}")
        return x, y

    def canvas_to_patch(self, x, y):
        """Inverse of patch_to_canvas (vectorised)."""
        x = np.asarray(x)
        y = np.asarray(y)
        w = self.size_u_pix
        h = self.size_v_pix
        dx = x - self.u0 * self.occupancy_resolution
        dy = y - self.v0 * self.occupancy_resolution
        o = self.orientation
        if o == PatchOrientation.DEFAULT:
            u, v = dx, dy
        elif o == PatchOrientation.SWAP:
            u, v = dy, dx
        elif o == PatchOrientation.ROT90:
            u, v = dy, h - 1 - dx
        elif o == PatchOrientation.ROT180:
            u, v = w - 1 - dx, h - 1 - dy
        elif o == PatchOrientation.ROT270:
            u, v = w - 1 - dy, dx
        elif o == PatchOrientation.MIRROR:
            u, v = w - 1 - dx, dy
        elif o == PatchOrientation.MROT90:
            u, v = w - 1 - dy, h - 1 - dx
        elif o == PatchOrientation.MROT180:
            u, v = dx, h - 1 - dy
        else:
            raise ValueError(f"bad orientation {o}")
        return u, v

    # ------------------------------------------------------------------
    def generate_point(self, u, v, depth):
        """Patch coords + depth -> 3D point (vectorised).
        Behavioural parity with PCCPatch::generatePoint (PCCPatch.h:201);
        45-degree patches compute in rotated space then inverse-rotate
        (inverseRotatePosition45DegreeOnAxis analog, PCCCodec.cpp:2503)."""
        u = np.asarray(u)
        v = np.asarray(v)
        depth = np.asarray(depth)
        pts = np.zeros(np.broadcast(u, v, depth).shape + (3,), np.int64)
        if self.projection_mode == 0:
            d = self.d1 + depth
        else:
            d = self.d1 - depth
        pts[..., self.normal_axis] = d
        pts[..., self.tangent_axis] = self.u1 + u * self.lod_x
        pts[..., self.bitangent_axis] = self.v1 + v * self.lod_y
        if self.rotation_axis == 1:   # about Y: sum in x', diff in z'
            rx = pts[..., 0]
            rz = pts[..., 2] - self.rot_offset
            x = (rx - rz + 1) >> 1
            z = (rx + rz + 1) >> 1
            pts = np.stack([x, pts[..., 1], z], axis=-1)
        elif self.rotation_axis == 2:  # about X: diff in y', sum in z'
            ry = pts[..., 1] - self.rot_offset
            rz = pts[..., 2]
            y = (ry + rz + 1) >> 1
            z = (rz - ry + 1) >> 1
            pts = np.stack([pts[..., 0], y, z], axis=-1)
        elif self.rotation_axis == 3:  # about Z: diff in x', sum in y'
            rx = pts[..., 0] - self.rot_offset
            ry = pts[..., 1]
            x = (rx + ry + 1) >> 1
            y = (ry - rx + 1) >> 1
            pts = np.stack([x, y, pts[..., 2]], axis=-1)
        return pts.astype(np.int32)

    def canvas_to_3d(self, x, y, depth):
        """Canvas pixel + depth -> 3D point (PCCPatch::canvasTo3D analog)."""
        u, v = self.canvas_to_patch(x, y)
        return self.generate_point(u, v, depth)

    # ------------------------------------------------------------------
    def canvas_bounds(self) -> tuple[int, int, int, int]:
        """(x0, y0, w, h) of the patch's bounding box in the canvas."""
        o = self.orientation
        w = self.size_u_pix
        h = self.size_v_pix
        if o in (
            PatchOrientation.SWAP,
            PatchOrientation.ROT90,
            PatchOrientation.ROT270,
            PatchOrientation.MROT90,
        ):
            w, h = h, w
        return (
            self.u0 * self.occupancy_resolution,
            self.v0 * self.occupancy_resolution,
            w,
            h,
        )

    def axes_struct(self) -> np.ndarray:
        """Pack the static per-patch parameters into a flat int32 vector for
        device-side batched reprojection (see ops/reproject.py PATCH_FIELDS)."""
        return np.array(
            [
                self.u0 * self.occupancy_resolution,
                self.v0 * self.occupancy_resolution,
                self.size_u_pix,
                self.size_v_pix,
                self.u1,
                self.v1,
                self.d1,
                self.normal_axis,
                self.tangent_axis,
                self.bitangent_axis,
                self.projection_mode,
                int(self.orientation),
                self.lod_x,
                self.lod_y,
                self.rotation_axis,
                self.rot_offset,
            ],
            np.int32,
        )


# Field order of Patch.axes_struct, used by device kernels.
PATCH_FIELDS = (
    "x0", "y0", "w", "h", "u1", "v1", "d1",
    "normal_axis", "tangent_axis", "bitangent_axis",
    "projection_mode", "orientation", "lod_x", "lod_y",
    "rotation_axis", "rot_offset",
)
