"""Group-of-frames container with parallel PLY I/O.

Parity with PCCGroupOfFrames (source/lib/PccLibCommon/include/
PCCGroupOfFrames.h:62-72): a vector of point clouds loaded/written in
parallel (the reference uses tbb::parallel_for; here a thread pool — PLY
parsing is NumPy-bound and releases the GIL in the hot paths).

The GOF is the framework's natural batching + checkpoint unit (SURVEY.md
§5.4): each GOF is independent, so (stream x GOF-frame) is the device-mesh
batch axis.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

from .pointset import PointSet


class GroupOfFrames:
    def __init__(self, frames: list[PointSet] | None = None):
        self.frames: list[PointSet] = frames or []

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int) -> PointSet:
        return self.frames[i]

    def __iter__(self):
        return iter(self.frames)

    def append(self, ps: PointSet) -> None:
        self.frames.append(ps)

    @classmethod
    def load(
        cls,
        path_template: str,
        start: int,
        count: int,
        max_workers: int = 8,
        color_transform: int = 0,
    ) -> "GroupOfFrames":
        """Load ``count`` frames from ``path_template % frame_index``.

        color_transform=1 converts source colors RGB->YCbCr at load time
        (the reference colorTransform option; PCCGroupOfFrames::load)."""
        paths = [path_template % (start + i) for i in range(count)]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)

        def _read(path: str) -> PointSet:
            ps = PointSet.read_ply(path)
            if color_transform == 1:
                ps.convert_rgb_to_yuv()
            return ps

        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            frames = list(ex.map(_read, paths))
        return cls(frames)

    def write(
        self,
        path_template: str,
        start: int,
        binary: bool = True,
        max_workers: int = 8,
        color_transform: int = 0,
    ) -> None:
        """color_transform=1 writes colors converted back YCbCr->RGB
        (inverse of the load-time transform)."""
        def _write(i: int) -> None:
            ps = self.frames[i]
            if color_transform == 1:
                ps = ps.copy()
                ps.convert_yuv_to_rgb()
            ps.write_ply(path_template % (start + i), binary=binary)

        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            list(ex.map(_write, range(len(self.frames))))
