"""Patch packing into the atlas.

Capability parity with PCCEncoder::packFlexible (source/lib/
PccLibEncoder/source/PCCEncoder.cpp:2390): patches sorted by size, greedy
raster-scan first-fit over the block grid, trying all 8 orientations,
growing atlas height when full.  Packing is inherently sequential and tiny
(hundreds of patches) — it stays host-side by design (SURVEY.md §7.6).
"""

from __future__ import annotations

import numpy as np

from ..utils.enums import PatchOrientation
from .segment import SegmentedPatch

# orientation preference order: identity first, then swaps/rotations
_ORIENTATIONS = [
    PatchOrientation.DEFAULT,
    PatchOrientation.SWAP,
    PatchOrientation.ROT90,
    PatchOrientation.ROT180,
    PatchOrientation.ROT270,
    PatchOrientation.MIRROR,
    PatchOrientation.MROT90,
    PatchOrientation.MROT180,
]


def _block_footprint(seg: SegmentedPatch, block: int) -> np.ndarray:
    """Patch-space occupied block grid (size_u0, size_v0) bool."""
    su, sv = seg.occupancy.shape
    nbu = (su + block - 1) // block
    nbv = (sv + block - 1) // block
    fp = np.zeros((nbu, nbv), bool)
    occ = seg.occupancy
    pad = np.zeros((nbu * block, nbv * block), bool)
    pad[:su, :sv] = occ
    fp = pad.reshape(nbu, block, nbv, block).any(axis=(1, 3))
    return fp


def _oriented_footprint(fp: np.ndarray, o: PatchOrientation) -> np.ndarray:
    """Map a patch-space (u, v) block footprint into canvas-space (x, y) —
    returns array indexed [bx, by]."""
    if o == PatchOrientation.DEFAULT:
        return fp
    if o == PatchOrientation.SWAP:
        return fp.T
    if o == PatchOrientation.ROT90:
        return fp.T[::-1, :]          # x = h-1-v, y = u
    if o == PatchOrientation.ROT180:
        return fp[::-1, ::-1]
    if o == PatchOrientation.ROT270:
        return fp.T[:, ::-1]
    if o == PatchOrientation.MIRROR:
        return fp[::-1, :]
    if o == PatchOrientation.MROT90:
        return fp.T[::-1, ::-1]
    if o == PatchOrientation.MROT180:
        return fp[:, ::-1]
    raise ValueError(o)


class Packer:
    """Block-grid packer with first-fit placement, orientation search, atlas
    growth, pinned placement (spatially consistent packing), and chain
    ownership (global patch allocation: a temporally matched patch chain may
    re-claim its own blocks across the GOF)."""

    def __init__(self, width: int, height: int, block: int = 16,
                 try_orientations: bool = True, max_height: int = 4096,
                 safeguard: int = 0, low_delay: bool = False):
        self.width = width
        self.block = block
        self.nbx = width // block
        self.grow_rows = max(4, height // block)
        # owner grid: -1 free, otherwise owning chain id
        self.owner = np.full((max(4, height // block), self.nbx), -1,
                             np.int32)
        # useEightOrientations=0 keeps the 2 orientations a u(1)
        # pdu_orientation_index can code (DEFAULT/SWAP, reference FLEXIBLE)
        self.orientations = (
            _ORIENTATIONS if try_orientations
            else [PatchOrientation.DEFAULT, PatchOrientation.SWAP]
        )
        self.max_height = max_height
        self.used_height = 0
        # safeGuardDistance (checkFitPatchCanvas, PCCPatch.cpp:318): keep
        # this many free blocks between different patches — pays height for
        # less background-fill bleeding into dilated lossy occupancy
        self.safeguard = safeguard
        # lowDelayEncoding (PCCEncoder.cpp:1469-1474): a patch claims its
        # whole bounding box, not just its occupied blocks, so no later
        # patch ever interleaves into an earlier patch's rectangle
        self.low_delay = low_delay

    @property
    def used(self) -> np.ndarray:
        return self.owner >= 0

    def _fp(self, seg: SegmentedPatch) -> np.ndarray:
        fp = _block_footprint(seg, self.block)
        return np.ones_like(fp) if self.low_delay else fp

    def _mark(self, seg: SegmentedPatch, cfp: np.ndarray, bx: int, by: int,
              o: PatchOrientation, chain: int) -> None:
        w_b, h_b = cfp.shape
        region = self.owner[by : by + h_b, bx : bx + w_b]
        region[cfp.T] = chain
        seg.patch.u0 = bx
        seg.patch.v0 = by
        seg.patch.orientation = o
        self.used_height = max(self.used_height, (by + h_b) * self.block)

    def _conflicts(self, cfp: np.ndarray, bx: int, by: int, chain: int) -> bool:
        s = self.safeguard
        if s:
            cfp = self._dilated(cfp, s)
            bx, by = bx - s, by - s
        w_b, h_b = cfp.shape
        x0, y0 = max(bx, 0), max(by, 0)
        x1 = min(bx + w_b, self.nbx)
        y1 = min(by + h_b, self.owner.shape[0])
        if x1 <= x0 or y1 <= y0:
            return False
        region = self.owner[y0:y1, x0:x1]
        sub = cfp[x0 - bx : x1 - bx, y0 - by : y1 - by]
        return bool(((region >= 0) & (region != chain) & sub.T).any())

    @staticmethod
    def _dilated(cfp: np.ndarray, s: int) -> np.ndarray:
        """Footprint dilated by the safeguard radius (chebyshev)."""
        w_b, h_b = cfp.shape
        out = np.zeros((w_b + 2 * s, h_b + 2 * s), bool)
        for dx in range(2 * s + 1):
            for dy in range(2 * s + 1):
                out[dx : dx + w_b, dy : dy + h_b] |= cfp
        return out

    def try_place_at(self, seg: SegmentedPatch, bx: int, by: int,
                     o: PatchOrientation, chain: int = 0) -> bool:
        """Pin a patch to an exact position/orientation if the blocks are
        free or already owned by the same chain."""
        fp = self._fp(seg)
        cfp = _oriented_footprint(fp, o)
        w_b, h_b = cfp.shape
        while (by + h_b) > self.owner.shape[0]:
            if not self._grow():
                return False
        if bx < 0 or by < 0 or bx + w_b > self.nbx:
            return False
        if self._conflicts(cfp, bx, by, chain):
            return False
        self._mark(seg, cfp, bx, by, o, chain)
        return True

    def place(self, seg: SegmentedPatch, chain: int = 0,
              tetris: bool = False) -> None:
        if tetris:
            return self._place_tetris(seg, chain)
        fp = self._fp(seg)
        bx, by, o, cfp = self.place_footprint(fp, chain)
        self._mark(seg, cfp, bx, by, o, chain)

    def place_footprint(self, fp: np.ndarray, chain: int = 0):
        """First-fit a raw patch-space block footprint ([bu, bv] bool) with
        orientation search; marks the blocks and returns (bx, by,
        orientation, canvas footprint).  Raises RuntimeError on overflow —
        this is the placement core place() wraps, also used directly for
        GPA union patches (which have no SegmentedPatch)."""
        while True:
            for o in self.orientations:
                cfp = _oriented_footprint(fp, o)
                w_b, h_b = cfp.shape
                if w_b > self.nbx or h_b > self.owner.shape[0]:
                    continue
                if self.safeguard:
                    s = self.safeguard
                    used_p = np.zeros(
                        (self.owner.shape[0] + 2 * s, self.nbx + 2 * s), bool
                    )
                    used_p[s:-s, s:-s] = self.used
                    # dilated footprint in border-padded grid: found padded
                    # position == the patch origin in real coordinates
                    pos = _first_fit(used_p, self._dilated(cfp, s))
                else:
                    pos = _first_fit(self.used, cfp)
                if pos is None:
                    continue
                by, bx = pos
                region = self.owner[by : by + h_b, bx : bx + w_b]
                region[cfp.T] = chain
                self.used_height = max(
                    self.used_height, (by + h_b) * self.block
                )
                return bx, by, o, cfp
            if not self._grow():
                raise RuntimeError(
                    f"atlas overflow: cannot pack footprint of "
                    f"{int(fp.sum())} blocks into width {self.width} "
                    f"below max height {self.max_height}"
                )

    def reserve(self, mask: np.ndarray, chain: int = 1 << 30) -> None:
        """Pre-mark canvas blocks ([by, bx] bool) as owned by an immovable
        pseudo-chain (GPA: per-frame packers see the union grid as taken)."""
        while mask.shape[0] > self.owner.shape[0]:
            if not self._grow():
                raise RuntimeError("atlas overflow reserving GPA unions")
        region = self.owner[: mask.shape[0]]
        region[mask & (region < 0)] = chain

    # ------------------------------------------------------------------
    def _horizon(self) -> np.ndarray:
        """Skyline: per canvas column, first free row above everything used."""
        used = self.used
        rows = used.shape[0]
        any_col = used.any(axis=0)
        return np.where(
            any_col, rows - np.argmax(used[::-1, :], axis=0), 0
        ).astype(np.int64)

    def _place_tetris(self, seg: SegmentedPatch, chain: int = 0) -> None:
        """Scored tetris placement (packTetris, PCCEncoder.cpp:3290 +
        PCCPatch::calculateWastedSpace, PCCPatch.cpp:423): drop every
        orientation onto the skyline at every column and take the position
        with the least wasted space
            100*v0 + gap-under-the-patch + internal holes
        (the 100*v0 term biases toward the canvas top, exactly the
        reference's lambda)."""
        fp = self._fp(seg)
        LAM = 100
        while True:
            horizon = self._horizon()
            best = None  # (score, bx, by, o, cfp)
            for o in self.orientations:
                cfp = _oriented_footprint(fp, o)
                w_b, h_b = cfp.shape
                if w_b > self.nbx:
                    continue
                occ2 = cfp.T                       # (h_b rows, w_b cols)
                col_any = occ2.any(axis=0)
                bottom = np.where(col_any, np.argmax(occ2, axis=0), h_b)
                internal = int(
                    ((h_b - np.where(
                        col_any, np.argmax(occ2[::-1, :], axis=0), h_b
                    ) - bottom) * col_any).sum() - occ2.sum()
                )
                for bx in range(self.nbx - w_b + 1):
                    hseg = horizon[bx:bx + w_b]
                    by = int(((hseg - bottom) * col_any).max()) if (
                        col_any.any()
                    ) else 0
                    by = max(by, 0)
                    # skyline drop can overlap blocks hidden in holes
                    while (by + h_b <= self.owner.shape[0]
                           and self._conflicts(cfp, bx, by, chain)):
                        by += 1
                    if by + h_b > self.owner.shape[0]:
                        continue
                    external = int(((by + bottom - hseg) * col_any).sum())
                    score = LAM * by + external + internal
                    if best is None or score < best[0]:
                        best = (score, bx, by, o, cfp)
            if best is not None:
                _, bx, by, o, cfp = best
                self._mark(seg, cfp, bx, by, o, chain)
                return
            if not self._grow():
                raise RuntimeError(
                    f"atlas overflow: cannot tetris-pack patch of "
                    f"{seg.occupancy.sum()} blocks into width {self.width} "
                    f"below max height {self.max_height}"
                )

    def _grow(self) -> bool:
        if (self.owner.shape[0] + self.grow_rows) * self.block > self.max_height:
            return False
        self.owner = np.concatenate(
            [self.owner, np.full((self.grow_rows, self.nbx), -1, np.int32)],
            axis=0,
        )
        return True


def pack_patches(
    segs: list[SegmentedPatch],
    width: int,
    height: int,
    block: int = 16,
    try_orientations: bool = True,
    max_height: int = 4096,
    tetris: bool = False,
    safeguard: int = 0,
    low_delay: bool = False,
) -> int:
    """Assign (u0, v0, orientation) to every patch in place; returns the used
    atlas height (multiple of `block`, may exceed `height` up to max_height).
    tetris=True uses the lowest-skyline orientation choice (packTetris
    analog) instead of plain first-fit."""
    packer = Packer(width, height, block, try_orientations, max_height,
                    safeguard=safeguard, low_delay=low_delay)
    order = sorted(
        range(len(segs)),
        key=lambda i: segs[i].occupancy.sum(),
        reverse=True,
    )
    for chain, i in enumerate(order):
        packer.place(segs[i], chain=chain, tetris=tetris)
    return max(packer.used_height, block)


def pack_patches_consistent(
    segs: list[SegmentedPatch],
    prev_segs: list[SegmentedPatch],
    width: int,
    height: int,
    block: int = 16,
    try_orientations: bool = True,
    max_height: int = 4096,
    safeguard: int = 0,
    low_delay: bool = False,
) -> int:
    """Spatially consistent packing (spatialConsistencyPackFlexible analog):
    patches matched to the previous frame (patch.best_match_idx set by
    encoder.matching) keep the reference's position/orientation when those
    blocks are free; everything else first-fits into the gaps."""
    packer = Packer(width, height, block, try_orientations, max_height,
                    safeguard=safeguard, low_delay=low_delay)
    deferred = []
    order = sorted(
        range(len(segs)),
        key=lambda i: segs[i].occupancy.sum(),
        reverse=True,
    )
    for chain, i in enumerate(order):
        seg = segs[i]
        ref_idx = seg.patch.best_match_idx
        if 0 <= ref_idx < len(prev_segs):
            ref = prev_segs[ref_idx].patch
            if packer.try_place_at(seg, ref.u0, ref.v0, ref.orientation,
                                   chain=chain):
                continue
            # position lost: still usable as inter (deltas), just repacked
        deferred.append((chain, i))
    for chain, i in deferred:
        packer.place(segs[i], chain=chain)
    return max(packer.used_height, block)


def pack_gof_global(
    frame_segs: list[list[SegmentedPatch]],
    width: int,
    height: int,
    block: int = 16,
    try_orientations: bool = True,
    max_height: int = 4096,
    safeguard: int = 0,
    low_delay: bool = False,
) -> int:
    """Global patch allocation (performDataAdaptiveGPAMethod analog,
    PCCEncoder.cpp:6792): ONE packing grid for the whole GOF.  Temporally
    matched patch chains own their blocks for the GOF's duration (a chain
    may re-claim and grow its own region; nothing else may), so every
    matched patch keeps its position across ALL frames.  Requires
    patch.best_match_idx set frame-to-frame (encoder.matching)."""
    packer = Packer(width, height, block, try_orientations, max_height,
                    safeguard=safeguard, low_delay=low_delay)
    next_chain = 0
    chains_prev: list[int] = []
    for fi, segs in enumerate(frame_segs):
        chains: list[int] = [0] * len(segs)
        order = sorted(
            range(len(segs)),
            key=lambda i: segs[i].occupancy.sum(),
            reverse=True,
        )
        for i in order:
            seg = segs[i]
            ref_idx = seg.patch.best_match_idx
            if fi > 0 and 0 <= ref_idx < len(chains_prev):
                chain = chains_prev[ref_idx]
                ref = frame_segs[fi - 1][ref_idx].patch
                if packer.try_place_at(
                    seg, ref.u0, ref.v0, ref.orientation, chain=chain
                ):
                    chains[i] = chain
                    continue
                seg.patch.best_match_idx = -1  # chain broken: code as intra
            chain = next_chain = next_chain + 1
            chains[i] = chain
            packer.place(seg, chain=chain)
        chains_prev = chains
    return max(packer.used_height, block)


def _first_fit(used: np.ndarray, cfp: np.ndarray):
    """First raster-scan position where footprint `cfp` ([bx, by]) fits."""
    h_grid, w_grid = used.shape
    w_b, h_b = cfp.shape
    fpT = cfp.T  # [by, bx]
    # vectorised sliding-window test via summed-area of conflicts
    for by in range(h_grid - h_b + 1):
        window = used[by : by + h_b]
        # quick row skip: if window fully free, place at bx=0
        if not window.any():
            return by, 0
        for bx in range(w_grid - w_b + 1):
            if not (window[:, bx : bx + w_b] & fpT).any():
                return by, bx
    return None


def pack_gof_adaptive(
    frame_segs: list[list[SegmentedPatch]],
    width: int,
    height: int,
    block: int = 16,
    try_orientations: bool = True,
    max_height: int = 4096,
    safeguard: int = 0,
    min_union_ratio: float = 0.15,
    low_delay: bool = False,
    window: int = 0,
    reset_chains: bool = False,
    area_ratio_threshold: float = 0.0,
) -> int:
    """Data-adaptive GPA with union packing, ITERATIVE re-allocation and
    subcontext splitting (performDataAdaptiveGPAMethod parity,
    PCCEncoder.cpp:6792-6900):

     * temporally matched patch chains spanning the current subcontext are
       packed as UNION patches (OR of the members' block footprints) — every
       member gets the union's position/orientation, stable for the whole
       subcontext;
     * patches NOT in a spanning chain pack per frame into the gaps, so
       different frames' transient patches may SHARE canvas area (the win
       over one GOF-exclusive grid);
     * each time a frame joins the subcontext the unions are RE-packed from
       scratch (the iterative re-allocation); when the union/track ratio
       drops below 0.15 (badPatchCount), or unions or a frame overflow
       (badUnionsHeight/badGPAPacking), the subcontext ENDS at the previous
       frame — its last good packing stands — and a new one starts.

    Requires patch.best_match_idx chains (encoder.matching).  Mismatched
    orientations across a chain break are handled downstream by the encoder
    (inter patches inherit orientation, encoder.py drops the match if it
    changed).  Returns the atlas height."""
    n = len(frame_segs)
    # chain labels: follow best_match_idx links frame to frame.
    # globalPackingStrategyGOF windows cut chains (and, with Reset, the
    # coded inter links) at window boundaries (PCCEncoder.cpp:1843,1857);
    # globalPackingStrategyThreshold breaks links whose footprint areas
    # diverge (PCCEncoder.cpp:1768-1769)
    chain_of: list[list[int]] = []
    next_chain = 0
    for fi, segs in enumerate(frame_segs):
        at_window_start = window > 0 and fi % window == 0 and fi > 0
        row = []
        for seg in segs:
            ri = seg.patch.best_match_idx
            linked = not at_window_start and fi > 0 and (
                0 <= ri < len(chain_of[fi - 1])
            )
            if linked and area_ratio_threshold > 0.0:
                a1 = float(seg.occupancy.sum())
                a2 = float(frame_segs[fi - 1][ri].occupancy.sum())
                if a1 > 0 and a2 > 0 and min(a1 / a2, a2 / a1) < (
                    area_ratio_threshold
                ):
                    linked = False
            if linked:
                row.append(chain_of[fi - 1][ri])
            else:
                if at_window_start and reset_chains and ri >= 0:
                    seg.patch.best_match_idx = -1  # coded intra at the cut
                row.append(next_chain)
                next_chain += 1
        chain_of.append(row)
    members: dict[int, list[tuple[int, int]]] = {}
    for fi, row in enumerate(chain_of):
        for i, c in enumerate(row):
            members.setdefault(c, []).append((fi, i))

    def pack_window(s: int, e: int):
        """Pack frames [s, e] -> (placements, height) or None if bad."""
        window = range(s, e + 1)
        alive = {chain_of[fi][i] for fi in window
                 for i in range(len(frame_segs[fi]))}
        spanning = [
            c for c in sorted(alive)
            if len({fi for fi, _ in members[c] if s <= fi <= e})
            == e - s + 1
        ]
        if e > s and len(spanning) < min_union_ratio * len(alive):
            return None  # badPatchCount
        # union footprints, packed on one grid (re-packed per window).
        # Orientation is pinned to DEFAULT: chain members inherit the
        # union's (position, orientation) but anchor rotations/mirrors at
        # their OWN size — a member smaller than the union would rasterize
        # outside the blocks the union reserved and collide with transients
        # packed into the gap.  DEFAULT anchors at the corner regardless of
        # size, so member pixels always stay inside the union footprint.
        upacker = Packer(width, height, block, False,
                         max_height, safeguard=safeguard,
                         low_delay=low_delay)
        union_pos: dict[int, tuple[int, int, PatchOrientation]] = {}
        unions = []
        for c in spanning:
            fps = [
                _block_footprint(frame_segs[fi][i], block)
                for fi, i in members[c] if s <= fi <= e
            ]
            nbu = max(f.shape[0] for f in fps)
            nbv = max(f.shape[1] for f in fps)
            u = np.zeros((nbu, nbv), bool)
            for f in fps:
                u[: f.shape[0], : f.shape[1]] |= f
            if low_delay:
                u[:] = True
            unions.append((c, u))
        unions.sort(key=lambda cu: int(cu[1].sum()), reverse=True)
        for c, u in unions:
            bx, by, o, _ = upacker.place_footprint(u, chain=c)
            union_pos[c] = (bx, by, o)
        reserved = upacker.used.copy()
        h = max(upacker.used_height, block)

        plc: dict[tuple[int, int], tuple[int, int, PatchOrientation]] = {}
        span_set = set(spanning)
        for fi in window:
            fpk = Packer(width, height, block, try_orientations,
                         max_height, safeguard=safeguard,
                         low_delay=low_delay)
            fpk.reserve(reserved)
            order = sorted(
                (i for i in range(len(frame_segs[fi]))
                 if chain_of[fi][i] not in span_set),
                key=lambda i: int(frame_segs[fi][i].occupancy.sum()),
                reverse=True,
            )
            for i in order:
                seg = frame_segs[fi][i]
                # spatial consistency: keep the previous frame's position
                # for matched transients when those blocks are free
                ri = seg.patch.best_match_idx
                if (fi > s and 0 <= ri < len(frame_segs[fi - 1])
                        and (fi - 1, ri) in plc):
                    pu, pv, po = plc[(fi - 1, ri)]
                    if fpk.try_place_at(seg, pu, pv, po, chain=i + 1):
                        plc[(fi, i)] = (pu, pv, po)
                        continue
                fpk.place(seg, chain=i + 1)
                plc[(fi, i)] = (
                    seg.patch.u0, seg.patch.v0, seg.patch.orientation
                )
            h = max(h, fpk.used_height)
        for c in spanning:
            for fi, i in members[c]:
                if s <= fi <= e:
                    plc[(fi, i)] = union_pos[c]
        return plc, h

    total_h = block
    s = 0
    while s < n:
        last_good = None
        # a fixed strategy window caps how far a subcontext may grow
        e_max = min(n, s + window) if window > 0 else n
        for e in range(s, e_max):
            try:
                res = pack_window(s, e)
            except RuntimeError:
                res = None
            if res is None:
                break
            last_good = (e, *res)
        if last_good is None:
            raise RuntimeError(
                f"atlas overflow: GPA cannot pack frame {s} into width "
                f"{width} below max height {max_height}"
            )
        e_good, plc, h = last_good
        for (fi, i), (u0, v0, o) in plc.items():
            p = frame_segs[fi][i].patch
            p.u0, p.v0, p.orientation = u0, v0, o
        total_h = max(total_h, h)
        s = e_good + 1
    return total_h
