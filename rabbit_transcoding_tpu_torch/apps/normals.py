"""rabbit-normals on PyTorch — PccAppNormalGenerator analog: estimate per-point normals
for a PLY sequence and write '*_n.ply' companions used by D2 metrics.

Port of ``rabbit_transcoding_tpu/apps/normals.py``; ``--device`` (``cuda``,
the default, raises when there is no GPU) is where the covariances and their
eigenvectors are computed.  Full option parity with source/app/PccAppNormalGenerator/
PccAppNormalGenerator.cpp:62-210 (viewpoint, per-stage KNN counts + radius
caps, iterative smoothing, four orientation strategies, store* flags); the
cfg-file-only UNUSED encoder options the reference registers are accepted and
ignored the same way."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from ..core.gof import GroupOfFrames
from ..device import resolve
from ..encoder.normals import NormalsGenParams, generate_normals
from .common import build_registry, parse_or_help

_MAX = float("inf")

# Options the reference registers purely so that encoder cfg files parse
# without "unhandled argument" noise (PccAppNormalGenerator.cpp:100-126).
_UNUSED_CFG_OPTIONS = (
    "geometry3dCoordinatesBitdepth", "geometryNominal2dBitdepth",
    "groupOfFramesSize", "iterationCountRefineSegmentation",
    "minNormSumOfInvDist4MPSelection", "partialAdditionalProjectionPlane",
    "maxPatchSize", "roiBoundingBoxMinX", "roiBoundingBoxMaxX",
    "roiBoundingBoxMinY", "roiBoundingBoxMaxY", "roiBoundingBoxMinZ",
    "roiBoundingBoxMaxZ", "numTilesHor", "tileHeightToWidthRatio",
    "numCutsAlong1stLongestAxis", "numCutsAlong2ndLongestAxis",
    "numCutsAlong3rdLongestAxis", "voxelDimensionRefineSegmentation",
    "minimumImageHeight", "flagColorPreSmoothing", "surfaceSeparation",
    "enhancedProjectionPlane", "skipAvgIfIdenticalSourcePointPresentBwd",
)


@dataclasses.dataclass
class NormalsParams:
    srcPlyPath: str = ""
    dstPlyPath: str = ""             # default: src with _n suffix
    uncompressedDataFolder: str = ""
    uncompressedDataPath: str = ""   # folder+path fallback for srcPlyPath
    startFrameNumber: int = 0
    frameCount: int = 1
    nbThread: int = 0
    viewPointX: float = 0.0
    viewPointY: float = 0.0
    viewPointZ: float = 0.0
    radiusNormalSmoothing: float = _MAX
    radiusNormalEstimation: float = _MAX
    radiusNormalOrientation: float = _MAX
    weightNormalSmoothing: float = _MAX
    numberOfNearestNeighborsInNormalSmoothing: int = 16
    numberOfNearestNeighborsInNormalEstimation: int = 16
    numberOfNearestNeighborsInNormalOrientation: int = 16
    numberOfIterationsInNormalSmoothing: int = 0
    # (0)NONE (1)SPANNING TREE (2)VIEWPOINT (3)CUBEMAP PROJECTION
    orientationStrategy: int = 1
    storeEigenvalues: int = 0
    storeNumberOfNearestNeighborsInNormalEstimation: int = 0
    storeCentroids: int = 0
    # legacy aliases kept from earlier rounds of this framework
    outputDataPath: str = ""
    knnCount: int = 0                # sets all three KNN counts when > 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = NormalsParams()
    reg = build_registry(
        params,
        extra={"device": ("cuda", "torch device: cuda (the GPU) or cpu"),
               **{name: ("", "accepted for cfg compatibility (unused)")
                  for name in _UNUSED_CFG_OPTIONS}},
    )
    if parse_or_help(reg, argv, params, "rabbit-normals") is None:
        return 0
    src = params.srcPlyPath or params.uncompressedDataPath
    if src and not params.srcPlyPath and params.uncompressedDataFolder:
        src = os.path.join(params.uncompressedDataFolder, src)
    if not src:
        print("error: --srcPlyPath (or --uncompressedDataPath) is required",
              file=sys.stderr)
        return 1
    device = resolve(reg["device"])
    default_out = (src[:-4] if src.endswith(".ply") else src) + "_n.ply"
    out_tpl = params.dstPlyPath or params.outputDataPath or default_out
    if params.knnCount > 0:
        params.numberOfNearestNeighborsInNormalEstimation = params.knnCount
        params.numberOfNearestNeighborsInNormalOrientation = params.knnCount
        params.numberOfNearestNeighborsInNormalSmoothing = params.knnCount
    gen = NormalsGenParams(
        view_point=(params.viewPointX, params.viewPointY, params.viewPointZ),
        radius_normal_smoothing=params.radiusNormalSmoothing,
        radius_normal_estimation=params.radiusNormalEstimation,
        radius_normal_orientation=params.radiusNormalOrientation,
        weight_normal_smoothing=params.weightNormalSmoothing,
        knn_normal_smoothing=params.numberOfNearestNeighborsInNormalSmoothing,
        knn_normal_estimation=(
            params.numberOfNearestNeighborsInNormalEstimation),
        knn_normal_orientation=(
            params.numberOfNearestNeighborsInNormalOrientation),
        smoothing_iterations=params.numberOfIterationsInNormalSmoothing,
        orientation_strategy=params.orientationStrategy,
        store_eigenvalues=bool(params.storeEigenvalues),
        store_number_of_nearest_neighbors=bool(
            params.storeNumberOfNearestNeighborsInNormalEstimation),
        store_centroids=bool(params.storeCentroids),
    )
    if "%" in src:
        gof = GroupOfFrames.load(
            src, params.startFrameNumber, params.frameCount,
            max_workers=params.nbThread or 8,
        )
    else:
        from ..core.pointset import PointSet

        gof = [PointSet.read_ply(src)]
    for i, ps in enumerate(gof):
        frame = params.startFrameNumber + i
        result = generate_normals(ps.positions.astype("float32"), gen,
                                  device)
        ps.normals = result["normals"]
        path = out_tpl % frame if "%" in out_tpl else out_tpl
        ps.write_ply(path)
        # the reference retains store* arrays in the generator object; the
        # CLI surfaces them as sidecar arrays next to the output PLY
        for key, suffix in (("eigenvalues", "_eigenvalues"),
                            ("centroids", "_centroids"),
                            ("nn_counts", "_nncounts")):
            if key in result:
                np.save(path[:-4] + suffix + ".npy", result[key])
        print(f"frame {frame}: {ps.point_count} normals "
              f"(strategy={params.orientationStrategy})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
