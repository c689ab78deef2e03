"""rabbit-decode on PyTorch: the PccAppDecoder analog.

Port of ``rabbit_transcoding_tpu/apps/decode.py``: parse -> per-atlas decode
-> write PLYs, print the clouds' checksums, optional metrics vs the source
sequence (``--computeMetrics``), hash-SEI self check, ``--trace`` conformance
logs (``dec_*``), the conformance comparator (``--checkConformance``),
per-stage timings into timings_decoder.txt.

    python -m rabbit_transcoding_tpu_torch.apps.decode \\
        --compressedStreamPath=in.bin \\
        --reconstructedDataPath=rec_%04d.ply [--device=cuda|cpu]

``--device=cuda`` (the default) raises when there is no GPU.
``--profileDir`` writes a ``torch.profiler`` trace of the run into that
directory.
"""

from __future__ import annotations

import os
import sys

from ..bitstream import V3CReader
from ..codec.hash import verify_hash_sei
from ..codec.patch_frame import decode_patch_frames
from ..core.gof import GroupOfFrames
from ..decoder.decoder import Decoder, DecoderParameters
from ..device import resolve
from ..metrics.metrics import MetricsParams, compute_sequence_metrics
from ..utils.timing import Stopwatch, print_run_footer
from .common import build_registry, parse_or_help, profile_to


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = DecoderParameters()
    reg = build_registry(
        params,
        extra={
            "device": ("cuda", "torch device: cuda (the GPU) or cpu"),
            "uncompressedDataFolder": ("", "base folder for the source PLYs"),
            "resolution": (1023, "geometry PSNR peak resolution"),
            "nbThread": (0, "thread count (0 = auto)"),
            "trace": (False, "write dec_* conformance trace logs"),
            "profileDir": ("", "write a torch.profiler trace to this "
                                   "directory"),
            # metrics sub-options (PccAppDecoder.cpp:172-220 metricsParams)
            "normalDataPath": ("", "source normals PLY template (D2)"),
            "frameCount": (0, "frames to compare (0 = all decoded)"),
            "groupOfFramesSize": (32, "random access period (metrics)"),
            "dropdups": (2, "0 detect | 1 drop | 2 average duplicates"),
            "neighborsProc": (1, "equidistant-neighbor handling 0-4"),
            # conformance sub-options (PccAppDecoder.cpp:226-241)
            "checkConformance": (False, "run the conformance comparator"),
            "path": ("", "conformance files root + prefix"),
            "level": (30, "level indice for the limit checks"),
            "fps": (30, "frames per second for the level checks"),
            # registered-and-ignored, like the reference
            # (PccAppDecoder.cpp:221-223 'Ignore parameter')
            "minimumImageHeight": (0, "ignored"),
            "flagColorPreSmoothing": (0, "ignored"),
            "surfaceSeparation": (0, "ignored"),
        },
    )
    if parse_or_help(reg, argv, params, "rabbit-decode") is None:
        return 0
    if not params.compressedStreamPath:
        print("error: --compressedStreamPath is required", file=sys.stderr)
        return 1
    device = resolve(reg["device"])
    with profile_to(reg["profileDir"], device, "rabbit-decode"):
        return _run(params, reg, device)


def _run(params, reg, device) -> int:
    sw = Stopwatch()
    sw.start()
    reader = V3CReader()
    gofs = reader.read_file(params.compressedStreamPath)
    decoder = Decoder(params, device)
    tracer = None
    if reg["trace"]:
        from ..utils.tracing import TraceCategory, Tracer

        tracer = Tracer(prefix="dec_").enable(*TraceCategory)
    all_clouds = []
    frame0 = params.startFrameNumber
    for gof_index, gof in enumerate(gofs):
        context = reader.decode(gof)
        for atlas in context.atlases:
            ok, sei = verify_hash_sei(
                atlas, decode_patch_frames(atlas)
            )
            if sei is not None:
                print(f"hash SEI check: {'OK' if ok else 'MISMATCH'}")
                if not ok:
                    print("error: decoded atlas hash mismatch", file=sys.stderr)
            clouds = decoder.decode(context, atlas.atlas_id)
            if tracer is not None:
                from ..codec.trace import emit_conformance_traces

                emit_conformance_traces(
                    tracer, atlas, decode_patch_frames(atlas), clouds,
                    gof=gof_index, atlas_id=atlas.atlas_id,
                )
            all_clouds.extend(clouds)
    # colorTransform=1 streams already carry YCbCr in the decoded clouds
    # (the encoder transformed the sources at load and the attribute video
    # coded those values) — transforming again here would double-apply it;
    # the metrics sources below load with the same transform so both sides
    # compare in the coded space (PccAppDecoder passes the transform only
    # to source loading, never to the reconstruction).
    if params.reconstructedDataPath:
        GroupOfFrames(all_clouds).write(params.reconstructedDataPath, frame0)
    if params.computeChecksum:
        for i, ps in enumerate(all_clouds):
            print(f"checksum frame {frame0 + i}: {ps.compute_checksum().hex()}")
    sw.stop()

    if params.computeMetrics and params.uncompressedDataPath:
        template = os.path.join(
            reg["uncompressedDataFolder"], params.uncompressedDataPath
        )
        count = len(all_clouds)
        if reg["frameCount"]:
            count = min(count, int(reg["frameCount"]))
        sources = GroupOfFrames.load(
            template, frame0, count,
            color_transform=params.colorTransform,
        )
        if reg["normalDataPath"]:
            normals = GroupOfFrames.load(reg["normalDataPath"], frame0, count)
            for s, n in zip(sources, normals):
                s.normals = n.normals
        _, summary = compute_sequence_metrics(
            list(sources), all_clouds[:count],
            MetricsParams(resolution=reg["resolution"],
                          drop_duplicates=int(reg["dropdups"]),
                          neighbors_proc=int(reg["neighborsProc"])),
            device=device,
        )
        print(summary.print())

    if reg["checkConformance"]:
        from ..conformance.conformance import ConformanceParams, check

        result = check(ConformanceParams(
            path=reg["path"], level=int(reg["level"]), fps=int(reg["fps"]),
        ))
        print(result.report())
        if not result.ok:
            print("conformance: FAILED", file=sys.stderr)

    if tracer is not None:
        tracer.close()
    decoder.timer.write("timings_decoder.txt")
    print(decoder.timer.report())
    print_run_footer("rabbit-decode", sw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
