"""rabbit-encode on PyTorch: the PccAppEncoder analog.

Port of ``rabbit_transcoding_tpu/apps/encode.py``, GOF loop parity with
PccAppEncoder.cpp:1007-1106: load PLYs per GOF -> encode -> serialize units
-> append to the output stream; optional reconstruction output + checksum;
per-stage timings into timings.txt.

    python -m rabbit_transcoding_tpu_torch.apps.encode \\
        --uncompressedDataPath=src_%04d.ply --frameCount=2 \\
        --compressedStreamPath=out.bin [--device=cuda|cpu]

``--device=cuda`` (the default) raises when there is no GPU.
``--profileDir`` writes a ``torch.profiler`` trace of the run into that
directory.
"""

from __future__ import annotations

import os
import sys

from ..bitstream import V3CWriter
from ..core.gof import GroupOfFrames
from ..device import resolve
from ..encoder.encoder import Encoder
from ..encoder.params import EncoderParameters
from ..utils.timing import Stopwatch, print_run_footer
from .common import build_registry, parse_or_help, profile_to


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = EncoderParameters()
    reg = build_registry(
        params,
        extra={
            "uncompressedDataFolder": ("", "base folder for the PLY template"),
            "device": ("cuda", "torch device: cuda (the GPU) or cpu"),
            "nbThread": (0, "thread count (0 = auto)"),
            "computeChecksum": (True, "record reconstruction checksums"),
            "trace": (False, "write enc_* conformance trace logs"),
            "profileDir": ("", "write a torch.profiler trace to this "
                               "directory"),
            # metrics sub-options (PccAppEncoder.cpp metricsParams block)
            "computeMetrics": (False, "D1/D2/color metrics vs the source"),
            "normalDataPath": ("", "source normals PLY template (D2)"),
            "resolution": (1023, "geometry PSNR peak resolution"),
            "dropdups": (2, "0 detect | 1 drop | 2 average duplicates"),
            "neighborsProc": (1, "equidistant-neighbor handling 0-4"),
        },
    )
    if parse_or_help(reg, argv, params, "rabbit-encode") is None:
        return 0
    if not params.uncompressedDataPath:
        print("error: --uncompressedDataPath is required", file=sys.stderr)
        return 1
    device = resolve(reg["device"])
    with profile_to(reg["profileDir"], device, "rabbit-encode"):
        return _run(params, reg, device)


def _run(params, reg, device) -> int:
    template = os.path.join(
        reg["uncompressedDataFolder"], params.uncompressedDataPath
    )
    sw = Stopwatch()
    sw.start()
    writer = V3CWriter()
    units = []
    encoder = Encoder(params, device)
    tracer = None
    if reg["trace"]:
        from ..utils.tracing import TraceCategory, Tracer

        tracer = Tracer(prefix="enc_").enable(*TraceCategory)
    frame0 = params.startFrameNumber
    remaining = params.frameCount
    gof_index = 0
    while remaining > 0:
        gof_size = min(params.groupOfFramesSize, remaining)
        sources = GroupOfFrames.load(
            template, frame0, gof_size,
            color_transform=params.colorTransform,
        )
        context, recon = encoder.encode(sources)
        units.extend(writer.encode(context))
        if tracer is not None:
            from ..codec.patch_frame import decode_patch_frames
            from ..codec.trace import emit_conformance_traces

            emit_conformance_traces(
                tracer, context.atlas(0),
                decode_patch_frames(context.atlas(0)), recon,
                gof=gof_index,
            )
        if params.reconstructedDataPath:
            GroupOfFrames(recon).write(
                params.reconstructedDataPath, frame0,
                color_transform=params.colorTransform,
            )
        if reg["computeMetrics"]:
            from ..metrics.metrics import (
                MetricsParams,
                compute_sequence_metrics,
            )

            if reg["normalDataPath"]:
                normals = GroupOfFrames.load(
                    reg["normalDataPath"], frame0, gof_size
                )
                for s, n in zip(sources, normals):
                    s.normals = n.normals
            _, summary = compute_sequence_metrics(
                list(sources), list(recon),
                MetricsParams(resolution=int(reg["resolution"]),
                              drop_duplicates=int(reg["dropdups"]),
                              neighbors_proc=int(reg["neighborsProc"])),
                device=device,
            )
            print(summary.print())
        if reg["computeChecksum"]:
            for i, ps in enumerate(recon):
                print(f"checksum frame {frame0 + i}: "
                      f"{ps.compute_checksum().hex()}")
        print(f"GOF {gof_index}: frames {frame0}..{frame0 + gof_size - 1} encoded")
        frame0 += gof_size
        remaining -= gof_size
        gof_index += 1
    n = writer.write_file(
        units, params.compressedStreamPath,
        forced_precision=params.forcedSsvhUnitSizePrecisionBytes,
    )
    sw.stop()

    print(f"output: {params.compressedStreamPath} ({n} bytes)")
    print(writer.stat.report())
    if tracer is not None:
        tracer.close()
    encoder.timer.write("timings.txt")
    print(encoder.timer.report())
    print_run_footer("rabbit-encode", sw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
