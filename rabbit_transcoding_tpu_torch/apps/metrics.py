"""rabbit-metrics on PyTorch — the PccAppMetrics analog: standalone
D1/D2/color metrics between two PLY sequences (PccAppMetrics).

Port of ``rabbit_transcoding_tpu/apps/metrics.py``.  The metrics are host
float64; ``--device`` (``cuda``, the default, raises when there is no GPU)
is where the source normals are computed when no ``--normalDataPath`` gives
them.

    python -m rabbit_transcoding_tpu_torch.apps.metrics \\
        --uncompressedDataPath=src_%04d.ply \\
        --reconstructedDataPath=rec_%04d.ply [--device=cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys

from ..core.gof import GroupOfFrames
from ..device import resolve
from ..metrics.metrics import MetricsParams, compute_sequence_metrics
from ..utils.timing import Stopwatch, print_run_footer
from .common import build_registry, parse_or_help


@dataclasses.dataclass
class MetricsAppParams:
    uncompressedDataPath: str = ""
    reconstructedDataPath: str = ""
    normalDataPath: str = ""
    startFrameNumber: int = 0
    frameCount: int = 1
    resolution: int = 1023
    # reference option names + defaults (PccAppMetrics.cpp:94-102):
    # dropDuplicates 0 keep | 1 drop | 2 average colors of co-located points
    dropDuplicates: int = 2
    # neighborsProc 0 first | 1 average | 2 weighted avg | 3 min | 4 max
    neighborsProc: int = 1
    csvFile: str = ""   # per-frame metric lines (PCCMetrics::writeLine analog)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = MetricsAppParams()
    reg = build_registry(
        params,
        extra={
            "device": ("cuda", "torch device of the normals: cuda (the GPU) "
                               "or cpu"),
            # full PccAppMetrics option-name parity (PccAppMetrics.cpp)
            "computeChecksum": (True, "compute checksums"),
            "computeMetrics": (True, "compute metrics"),
            "uncompressedDataFolder": ("", "base folder for the PLY paths"),
            "groupOfFramesSize": (32, "random access period"),
            "dropdups": (-1, "alias of dropDuplicates (reference name)"),
            "nbThread": (0, "thread count (0 = auto)"),
            # registered-and-ignored, like the reference
            "minimumImageHeight": (0, "ignored"),
            "flagColorPreSmoothing": (0, "ignored"),
            "surfaceSeparation": (0, "ignored"),
        },
    )
    if parse_or_help(reg, argv, params, "rabbit-metrics") is None:
        return 0
    if int(reg["dropdups"]) >= 0:
        params.dropDuplicates = int(reg["dropdups"])
    if reg["uncompressedDataFolder"]:
        params.uncompressedDataPath = os.path.join(
            reg["uncompressedDataFolder"], params.uncompressedDataPath
        )
    if not params.uncompressedDataPath or not params.reconstructedDataPath:
        print(
            "error: --uncompressedDataPath and --reconstructedDataPath required",
            file=sys.stderr,
        )
        return 1
    device = resolve(reg["device"])

    sw = Stopwatch()
    sw.start()
    src = GroupOfFrames.load(
        params.uncompressedDataPath, params.startFrameNumber, params.frameCount
    )
    rec = GroupOfFrames.load(
        params.reconstructedDataPath, params.startFrameNumber, params.frameCount
    )
    if params.normalDataPath and os.path.exists(
        params.normalDataPath % params.startFrameNumber
    ):
        normals = GroupOfFrames.load(
            params.normalDataPath, params.startFrameNumber, params.frameCount
        )
        for s, n in zip(src, normals):
            s.normals = n.normals
    if reg["computeChecksum"]:
        for i, (s, r) in enumerate(zip(src, rec)):
            print(f"checksum frame {params.startFrameNumber + i}: "
                  f"src {s.compute_checksum().hex()} "
                  f"rec {r.compute_checksum().hex()}")
    if reg["computeMetrics"]:
        per_frame, summary = compute_sequence_metrics(
            list(src), list(rec),
            MetricsParams(resolution=params.resolution,
                          drop_duplicates=int(params.dropDuplicates),
                          neighbors_proc=params.neighborsProc),
            device=device,
        )
        for i, m in enumerate(per_frame):
            print(f"frame {params.startFrameNumber + i}:")
            print(m.print())
        print(f"--- average over {len(per_frame)} frames ---")
        print(summary.print())
    else:
        per_frame, summary = [], None
    if params.csvFile and summary is not None:
        with open(params.csvFile, "w", encoding="utf-8") as f:
            f.write("frame;d1_psnr;d2_psnr;hausdorff_psnr;y;u;v\n")
            for i, m in enumerate(per_frame):
                f.write(f"{params.startFrameNumber + i};{m.csv_line()}\n")
            f.write(f"avg;{summary.csv_line()}\n")
        print(f"csv written to {params.csvFile}")
    sw.stop()
    print_run_footer("rabbit-metrics", sw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
