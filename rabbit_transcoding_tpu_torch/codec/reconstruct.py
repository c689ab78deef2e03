"""Shared 3D reconstruction engine: occupancy maps, block-to-patch
ownership, patch->3D reprojection and colouring for a whole GOF.

Port of ``rabbit_transcoding_tpu/codec/reconstruct.py``; with a mesh
(``GeneratePointCloudParameters.mesh``) the reprojection's frames split over
its devices (``parallel/pipeline.py``).  The GOF's occupancy, geometry and attribute planes go to the
device once; reprojection, colour conversion, the boundary tags, the
compaction of the valid pixels into points and the removal of duplicate
points run there as dense masked tensor ops; only the compacted points come
back to the host, where they are split into per-frame ``PointSet``s.  The
clouds equal the reference's arrays in order: compaction keeps raster order
within a layer, layers follow one another per frame as in the reference,
and of co-located points the first stays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.image import Video
from ..core.patch import Patch
from ..core.pointset import PointSet
from ..device import resolve
from ..ops import occupancy as occ_ops
from ..ops import reproject as repro_ops
from ..parallel.pipeline import sharded_reproject
from ..ops.color import yuv420_to_rgb8
from ..utils.enums import ColorFormat


@dataclasses.dataclass
class GeneratePointCloudParameters:
    """Reconstruction knobs (GeneratePointCloudParameters analog)."""

    occupancy_resolution: int = 16
    occupancy_precision: int = 4
    flag_geometry_smoothing: bool = False
    grid_size: int = 8
    neighbor_count_smoothing: int = 64
    threshold_smoothing: float = 64.0
    flag_color_smoothing: bool = False
    threshold_color_smoothing: float = 10.0
    remove_duplicate_points: bool = True
    pixel_deinterleaving: bool = False
    point_local_reconstruction: bool = False
    # PLR mode table indexed by coded plrd mode value; entry 0 is the
    # implicit no-op mode, later entries come from the ASPS plri descriptors
    # (interpolate, filling, minimum_depth, neighbor).  The default is the
    # single "+1 layer" mode (minD1=1).
    plr_modes: tuple = ((False, False, 0, 1), (False, False, 1, 1))
    # occupancy synthesis / PBF (from the SeiOccupancySynthesis SEI):
    # erode dilated occupancy rims whose geometry deviates off-surface
    pbf_enable: bool = False
    pbf_passes: int = 2
    pbf_filter_size: int = 3
    pbf_threshold: float = 4.0
    # full-KNN geometry smoothing knobs (no SEI carries them; both sides
    # must configure identically)
    grid_smoothing: bool = True
    # b2p precedence (asps_patch_precedence_order_flag): True = first-coded
    # patch wins contested blocks; False = last-coded wins
    patch_precedence: bool = True
    radius2_smoothing: float = 64.0
    radius2_boundary_detection: float = 64.0
    # post-smoothing attribute re-transfer selector (attrTransferFilterType;
    # 0 = geometry smoothing excluded from attribute transfer)
    attr_transfer_filter_type: int = 0
    # a parallel.mesh.Mesh splits the reprojection's frames over its
    # devices (parallel/pipeline.py; equal to the one-device call, the
    # results gathered back on the engine's device).  None = one device.
    mesh: object = None


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _like_input(out: torch.Tensor, x):
    return out if isinstance(x, torch.Tensor) else out.numpy()


def occupancy_boundary(occ):
    """(F, H, W) occupancy -> (F, H*W) bool marking occupied pixels missing
    an 8-neighbour (or on the atlas border): the points tagged type 1.
    Geometry smoothing only moves these; interior surface points stay put.
    Takes and returns a numpy array, or a tensor on any device."""
    b = _as_tensor(occ).to(torch.bool)
    interior = b.clone()
    interior[:, 1:, :] &= b[:, :-1, :]
    interior[:, :-1, :] &= b[:, 1:, :]
    interior[:, :, 1:] &= b[:, :, :-1]
    interior[:, :, :-1] &= b[:, :, 1:]
    # diagonals: a staircase contour pixel with all 4 axial neighbours
    # occupied is still a boundary point
    interior[:, 1:, 1:] &= b[:, :-1, :-1]
    interior[:, 1:, :-1] &= b[:, :-1, 1:]
    interior[:, :-1, 1:] &= b[:, 1:, :-1]
    interior[:, :-1, :-1] &= b[:, 1:, 1:]
    interior[:, 0, :] = False
    interior[:, -1, :] = False
    interior[:, :, 0] = False
    interior[:, :, -1] = False
    return _like_input((b & ~interior).flatten(1), occ)


def occupancy_near_boundary(occ):
    """Type-2 boundary ring: occupied pixels NOT type 1 with an unoccupied
    pixel at chebyshev distance exactly 2 (the 16 ring offsets; out-of-
    bounds ring cells do not count).  Colour pre-smoothing gates on this
    set.  Takes and returns a numpy array or a tensor."""
    b = _as_tensor(occ).to(torch.bool)
    f, h, w = b.shape
    hole_near = torch.zeros_like(b)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if abs(dy) <= 1 and abs(dx) <= 1:
                continue
            sy = slice(max(dy, 0), h + min(dy, 0))
            sx = slice(max(dx, 0), w + min(dx, 0))
            ty = slice(max(-dy, 0), h + min(-dy, 0))
            tx = slice(max(-dx, 0), w + min(-dx, 0))
            hole_near[:, ty, tx] |= ~b[:, sy, sx]
    type1 = occupancy_boundary(b).reshape(b.shape)
    return _like_input((b & ~type1 & hole_near).flatten(1), occ)


def plr_mode_map(
    patch_lists: list[list[Patch]],
    h: int,
    w: int,
    owner: np.ndarray,
) -> np.ndarray:
    """(F, H*W) uint8 per-pixel PLR mode values.

    Patch-level modes (plrd_level=1) apply to every owned pixel; patches
    carrying plrd_block_modes (plrd_level=0) override per PATCH-LOCAL
    packing block.  owner is the (F, H*W) pixel-level patch index (-1 =
    none): patch bounding boxes may interleave, so only pixels owned by the
    patch are touched.  Canvas pixels map to patch-local coords via
    canvas_to_patch, so the block grid is orientation-free."""
    from ..utils.enums import PatchOrientation

    swapped = {
        PatchOrientation.SWAP, PatchOrientation.ROT90,
        PatchOrientation.ROT270, PatchOrientation.MROT90,
    }
    f = len(patch_lists)
    modes = np.zeros((f, h * w), np.uint8)
    for fi, pl in enumerate(patch_lists):
        if not pl:
            continue
        vals = np.zeros(len(pl) + 1, np.uint8)
        for pi, p in enumerate(pl):
            vals[pi] = 0 if p.plr_block_modes is not None else p.plr_mode
        own = owner[fi]
        modes[fi] = vals[np.clip(own, 0, len(pl) - 1)] * (own >= 0)
        frame_modes = modes[fi].reshape(h, w)
        frame_owner = own.reshape(h, w)
        for pi, p in enumerate(pl):
            if p.plr_block_modes is None or p.plr_mode == 0:
                continue
            res = p.occupancy_resolution
            x0 = p.u0 * res
            y0 = p.v0 * res
            if p.orientation in swapped:
                wc, hc = p.size_v_pix, p.size_u_pix
            else:
                wc, hc = p.size_u_pix, p.size_v_pix
            wc = min(wc, w - x0)
            hc = min(hc, h - y0)
            if wc <= 0 or hc <= 0:
                continue
            yy, xx = np.mgrid[y0:y0 + hc, x0:x0 + wc]
            u, v = p.canvas_to_patch(xx, yy)
            bv, bu = p.plr_block_modes.shape
            bi = np.clip(v // res, 0, bv - 1)
            bj = np.clip(u // res, 0, bu - 1)
            owned = frame_owner[y0:y0 + hc, x0:x0 + wc] == pi
            blk = p.plr_block_modes[bi, bj]
            frame_modes[y0:y0 + hc, x0:x0 + wc] = np.where(
                owned, blk, frame_modes[y0:y0 + hc, x0:x0 + wc]
            )
    return modes


_PLR_NEIGHBOR_THRESHOLD = 4  # g_neighborThreshold

# canonical PLR mode table, (interpolate, filling, minD1, neighbor); entry 0
# is the implicit no-op mode, nbPlrmMode selects the first N entries
PLR_MODE_TABLE = (
    (False, False, 0, 1), (True, False, 0, 1), (True, True, 0, 1),
    (True, False, 0, 2), (True, True, 0, 2),
    (False, False, 1, 1), (True, False, 1, 1), (True, True, 1, 1),
    (True, False, 1, 2), (True, True, 1, 2),
)


def plr_delta_neighbors(geo: np.ndarray, radius: int) -> np.ndarray:
    """Per pixel, the largest positive depth step to any pixel within the
    (2r+1)^2 window that stays <= g_neighborThreshold, minus one.  Depths
    are patch-relative (D1 >= D0 for both projection modes)."""
    f, h, w = geo.shape
    g = geo.astype(np.int32)
    delta = np.zeros((f, h, w), np.int32)
    pad = np.pad(g, ((0, 0), (radius, radius), (radius, radius)),
                 mode="edge")
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[:, radius + dy: radius + dy + h,
                     radius + dx: radius + dx + w]
            d = nb - g
            ok = d <= _PLR_NEIGHBOR_THRESHOLD
            delta = np.where(ok & (d > delta), d, delta)
    return np.where(delta > 0, delta - 1, 0)


def synthesize_plr_layers(
    patch_lists: list[list[Patch]],
    geo0: np.ndarray,            # (F, H, W) rel-depth map-0 DECODED plane
    valid: np.ndarray,           # (F, H*W) bool occupied-and-owned pixels
    b2p0: np.ndarray,            # (F, H/bs, W/bs) block ownership (1-based)
    occ_dev: torch.Tensor, table_dev: torch.Tensor, counts_dev: torch.Tensor,
    block: int,
    plr_modes,                   # mode table incl. implicit entry 0
    reverse: bool,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Shared PLR layer synthesis: per pixel, delta = neighbourhood depth
    step when the mode interpolates, clamped up to the mode's minD1; a point
    lands at rel depth + delta and intermediate depths fill when requested.
    Returns [(points (F,H*W,3) int32, mask (F,H*W) bool)], tensors on
    ``occ_dev``'s device.  Called by BOTH the decoder and the encoder's
    closed loop so the reconstructions stay identical."""
    f, h, w = geo0.shape
    dev = occ_dev.device
    owner = np.repeat(
        np.repeat(b2p0, block, axis=1), block, axis=2
    )[:, :h, :w].reshape(f, h * w) - 1
    mode_px = plr_mode_map(patch_lists, h, w, owner)
    table_m = np.asarray([list(m) for m in plr_modes], np.int32)
    top = int(mode_px.max()) if mode_px.size else 0
    if top >= len(table_m):
        # fail loudly rather than synthesizing with a remapped mode
        raise ValueError(
            f"coded PLR mode {top} exceeds the ASPS mode table "
            f"({len(table_m)} entries)"
        )
    interp_px = table_m[mode_px, 0].astype(bool)
    fill_px = table_m[mode_px, 1].astype(bool)
    mind_px = table_m[mode_px, 2]
    neigh_px = table_m[mode_px, 3]
    delta_px = np.zeros((f, h * w), np.int32)
    if interp_px.any():
        for r in np.unique(neigh_px[interp_px]):
            dmap = plr_delta_neighbors(geo0, int(r)).reshape(f, -1)
            sel = interp_px & (neigh_px == r)
            delta_px = np.where(sel, dmap, delta_px)
    delta_px = np.maximum(delta_px, mind_px)
    delta_px = np.where(valid, delta_px, 0)
    layers: list[tuple[torch.Tensor, torch.Tensor]] = []
    max_delta = int(delta_px.max()) if delta_px.size else 0
    # the plane goes to the device ONCE; each layer adds its k there
    geo_dev = (torch.from_numpy(geo0.astype(np.int32)).to(dev)
               if max_delta else None)
    for k in range(1, max_delta + 1):
        mask_k = valid & ((delta_px == k) | (fill_px & (k < delta_px)))
        if not mask_k.any():
            continue
        pts_k, _, _ = repro_ops.reproject(
            geo_dev + k, occ_dev, table_dev, counts_dev,
            block, reverse=reverse,
        )
        layers.append((pts_k, torch.from_numpy(mask_k).to(dev)))
    return layers


# coordinates are packed 3 x 16 bits under the frame index for the
# duplicate search on the device
_KEY_BITS = 16
_KEY_OFFSET = 1 << (_KEY_BITS - 1)


def first_occurrences(frame: torch.Tensor, pos: torch.Tensor):
    """Indices (ascending) of the rows that are the first with their
    (frame, position), or None when a coordinate does not fit the packed
    key (the caller then removes duplicates on the host)."""
    if pos.numel() == 0:
        return torch.arange(0, device=pos.device)
    lo, hi = int(pos.min()), int(pos.max())
    if lo < -_KEY_OFFSET or hi >= _KEY_OFFSET:
        return None
    p = pos.long() + _KEY_OFFSET
    key = ((frame.long() << _KEY_BITS | p[:, 0]) << _KEY_BITS
           | p[:, 1]) << _KEY_BITS | p[:, 2]
    _, inv = torch.unique(key, return_inverse=True)
    n = key.shape[0]
    first = torch.full((int(inv.max()) + 1,), n, dtype=torch.long,
                       device=pos.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=pos.device), "amin")
    return torch.sort(first).values


class ReconstructionEngine:
    def __init__(self, params: GeneratePointCloudParameters | None = None,
                 device: torch.device | str = "cuda"):
        self.params = params or GeneratePointCloudParameters()
        self.device = resolve(device)

    def _dev(self, x: np.ndarray, dtype=None) -> torch.Tensor:
        """A host plane on the device.  16-bit planes widen on the host
        (torch has no uint16 arithmetic)."""
        x = np.asarray(x)
        if x.dtype == np.uint16:
            x = x.astype(np.int32)
        elif not x.flags.writeable:
            x = x.copy()      # torch does not take a read-only buffer
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return t if dtype is None else t.to(dtype)

    # ------------------------------------------------------------------
    def occupancy_maps(
        self, occ_video: Video, width: int, height: int,
        threshold: int = 0,
    ) -> np.ndarray:
        """Occupancy video (possibly precision-downscaled, possibly lossy)
        -> (F, H, W) binary uint8 maps at full atlas resolution.
        ``threshold`` is the lossy-occupancy threshold (0 for lossless
        streams)."""
        plane = np.asarray(occ_video.planes[0])
        f, oh, ow = plane.shape
        factor = width // ow
        occ = occ_ops.binarize(self._dev(plane), threshold)
        if factor > 1:
            occ = occ_ops.upsample_nearest(occ, factor)
        return occ[:, :height, :width].cpu().numpy()

    def _table(self, patch_lists, max_patches):
        if max_patches is None:
            raw_max = max((len(p) for p in patch_lists), default=1)
            max_patches = max(1, round_up(raw_max, 32))
        table, counts = repro_ops.build_patch_table(patch_lists, max_patches)
        return self._dev(table), self._dev(counts)

    # ------------------------------------------------------------------
    def generate_point_clouds(
        self,
        patch_lists: list[list[Patch]],
        occ_maps: np.ndarray,          # (F, H, W) uint8
        geo_video: Video,              # F*map_count frames, map-interleaved
        attr_video: Video | None,      # F*map_count frames, map-interleaved
        max_patches: int | None = None,
        map_count: int = 1,
        refl_video: Video | None = None,  # reflectance plane, map-interleaved
    ) -> list[PointSet]:
        """Batched patch->3D reprojection + colouring for a whole GOF.

        Dual-map streams (frames [D0_0, D1_0, D0_1, ...]) reproject once
        per map; the layers merge per frame (duplicates removed when
        enabled)."""
        f, h, w = occ_maps.shape
        reverse = not self.params.patch_precedence
        table_dev, counts_dev = self._table(patch_lists, max_patches)
        # the first NON-EMPTY frame's resolution (frame 0 can be all-raw)
        block = next(
            (pl[0].occupancy_resolution for pl in patch_lists if pl), 16
        )
        occ_dev = self._dev(occ_maps)
        geo_all = self._dev(geo_video.planes[0], torch.int32)

        if self.params.pbf_enable:
            geo0_pbf = geo_all[::map_count][:f, :h, :w]
            b2p_blk = repro_ops.block_to_patch(
                occ_dev, table_dev, counts_dev, block, reverse=reverse)
            owner_px = occ_ops.upsample_nearest(b2p_blk, block)[:, :h, :w]
            occ_dev = occ_ops.pbf_refine(
                occ_dev, geo0_pbf, owner_px,
                float(np.float32(self.params.pbf_threshold)),
                passes=self.params.pbf_passes,
                radius=max(1, self.params.pbf_filter_size // 2),
            ).to(torch.uint8)
        pts_maps = []
        valid = None
        b2p0 = None
        for m in range(map_count):
            geo_m = geo_all[m::map_count][:f, :h, :w]
            if self.params.mesh is not None:
                pts_m, valid_m, b2p_m = sharded_reproject(
                    self.params.mesh, geo_m, occ_dev, table_dev, counts_dev,
                    block, reverse=reverse)
            else:
                pts_m, valid_m, b2p_m = repro_ops.reproject(
                    geo_m, occ_dev, table_dev, counts_dev, block,
                    reverse=reverse)
            pts_maps.append(pts_m)
            if valid is None:
                valid, b2p0 = valid_m, b2p_m

        # PLR: single-map streams synthesize extra layers per the coded mode
        # table: delta = neighbourhood depth step when the mode
        # interpolates, clamped up to minD1; the point lands at rel depth +
        # delta, with intermediate depths filled when the mode asks.
        plr_layers: list[tuple[torch.Tensor, torch.Tensor]] = []
        if map_count == 1 and any(
            p.plr_mode for pl in patch_lists for p in pl
        ):
            plr_layers = synthesize_plr_layers(
                patch_lists, geo_all[:f, :h, :w].cpu().numpy(),
                valid.cpu().numpy(), b2p0.cpu().numpy(),
                occ_dev, table_dev, counts_dev, block,
                self.params.plr_modes, reverse=reverse,
            )

        refl_maps = None
        if refl_video is not None:
            rp = self._dev(refl_video.planes[0])[:, :h, :w]
            refl_maps = [rp[m::map_count][:f].reshape(f, h * w)
                         for m in range(map_count)]

        colors_maps = None
        if attr_video is not None:
            if attr_video.format == ColorFormat.RGB444:
                # 444 streams carry RGB planes directly
                rgb = torch.stack(
                    [self._dev(pl) for pl in attr_video.planes], dim=-1
                )[:, :h, :w]
            else:
                rgb = yuv420_to_rgb8(
                    *(self._dev(pl) for pl in attr_video.planes[:3])
                )[:, :h, :w]
            colors_maps = [rgb[m::map_count][:f].reshape(f, h * w, 3)
                           for m in range(map_count)]

        boundary = occupancy_boundary(occ_dev[:, :h, :w]).to(torch.uint8)
        # per-point patch index (the partition vector): pixel block
        # ownership minus one, the source the PLR path uses too
        owner_pt = occ_ops.upsample_nearest(b2p0, block)[
            :, :h, :w].reshape(f, h * w) - 1

        # the layers in the order the reference concatenates them per frame:
        # the maps, then the PLR layers (which take their pixel's map-0
        # colour and reflectance)
        layers = [(pts_maps[m], valid, m) for m in range(map_count)]
        layers += [(pts_k, mask_k, 0) for pts_k, mask_k in plr_layers]
        parts = {"frame": [], "pos": [], "col": [], "refl": [], "typ": [],
                 "part": [], "layer": []}
        for li, (pts_l, mask_l, src) in enumerate(layers):
            fr, px = mask_l.nonzero(as_tuple=True)   # frame-major, raster
            parts["frame"].append(fr)
            parts["layer"].append(torch.full_like(fr, li))
            parts["pos"].append(pts_l[fr, px])
            parts["typ"].append(boundary[fr, px])
            parts["part"].append(owner_pt[fr, px])
            if colors_maps is not None:
                parts["col"].append(colors_maps[src][fr, px])
            if refl_maps is not None:
                parts["refl"].append(refl_maps[src][fr, px])
        got = {k: torch.cat(v) for k, v in parts.items() if v}
        # frame by frame, layer after layer, raster order within a layer
        order = torch.sort(got["frame"] * len(layers) + got.pop("layer"),
                           stable=True).indices
        got = {k: v[order] for k, v in got.items()}
        host_dedup = False
        if self.params.remove_duplicate_points:
            first = first_occurrences(got["frame"], got["pos"])
            if first is None:
                host_dedup = True
            else:
                got = {k: v[first] for k, v in got.items()}
        counts = torch.bincount(got["frame"], minlength=f).cpu().tolist()
        host = {k: v.cpu().numpy() for k, v in got.items() if k != "frame"}
        if "refl" in host:
            host["refl"] = host["refl"].astype(
                np.asarray(refl_video.planes[0]).dtype)
        clouds: list[PointSet] = []
        start = 0
        for n in counts:
            sl = slice(start, start + n)
            start += n
            ps = PointSet(
                positions=host["pos"][sl],
                colors=host["col"][sl] if "col" in host else None,
                reflectances=host["refl"][sl] if "refl" in host else None,
                types=host["typ"][sl], partition=host["part"][sl])
            clouds.append(ps.remove_duplicates() if host_dedup else ps)
        return clouds

    # ------------------------------------------------------------------
    def block_to_patch_maps(
        self,
        patch_lists: list[list[Patch]],
        occ_maps: np.ndarray,
        block_size: int = 16,
        max_patches: int | None = None,
    ) -> np.ndarray:
        """(F, H/bs, W/bs) int32 block ownership maps (0 = none)."""
        table_dev, counts_dev = self._table(patch_lists, max_patches)
        return repro_ops.block_to_patch(
            self._dev(occ_maps), table_dev, counts_dev, block_size,
            reverse=not self.params.patch_precedence,
        ).cpu().numpy()
