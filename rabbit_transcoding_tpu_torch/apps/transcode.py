"""rabbit-transcode on PyTorch: the PccAppTranscoder analog.

Port of ``rabbit_transcoding_tpu/apps/transcode.py``: parse options (the
reference's names) -> read the V3C stream -> per GOF decode, transcode each
atlas, re-encode -> write the out stream, wall time + '<test_name>.txt';
``--trace`` writes the ``enc_*`` conformance logs of the transcoded stream,
``--checkConformance`` runs the comparator, ``--profileDir`` writes a
``torch.profiler`` trace of the run into that directory.

    python -m rabbit_transcoding_tpu_torch.apps.transcode \\
        --compressedStreamPath=in.bin --outStreamPath=out.bin \\
        --geometryQP=32 --attributeQP=42 [--device=cuda|cpu]

``--device=cuda`` (the default) runs the fused transcode kernel on the GPU
and raises when there is none; ``--device=cpu`` runs the plain PyTorch
versions.
"""

from __future__ import annotations

import hashlib
import sys

from ..bitstream import V3CReader, V3CWriter
from ..device import resolve
from ..transcoder.params import TranscoderParameters
from ..transcoder.transcoder import Transcoder
from ..utils.timing import Stopwatch, print_run_footer, write_wall_seconds
from .common import build_registry, parse_or_help, profile_to


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = TranscoderParameters()
    reg = build_registry(
        params,
        extra={
            "device": ("cuda", "torch device: cuda (the GPU kernels) or cpu "
                               "(the plain PyTorch versions)"),
            "profileDir": ("", "write a torch.profiler trace to this "
                                   "directory"),
            "trace": (False, "write enc_* conformance trace logs for the "
                             "transcoded stream (PCCLogger analog)"),
            # conformance sub-options (PccAppTranscoder.cpp:225-241)
            "checkConformance": (False, "run the conformance comparator"),
            "path": ("", "conformance files root + prefix"),
            "level": (30, "level indice for the limit checks"),
            "fps": (30, "frames per second for the level checks"),
        },
    )
    if parse_or_help(reg, argv, params, "rabbit-transcode") is None:
        return 0
    if not params.compressedStreamPath:
        print("error: --compressedStreamPath is required", file=sys.stderr)
        return 1
    device = resolve(reg["device"])

    sw = Stopwatch()
    sw.start()
    with profile_to(reg["profileDir"], device, "rabbit-transcode"):
        transcoder, writer, n, tracer = _run(params, reg, device)
        sw.stop()

    print(f"output: {params.outStreamPath} ({n} bytes) on {device}")
    print(transcoder.timer.report())
    print(writer.stat.report())
    if tracer is not None:
        tracer.close()
    if reg["checkConformance"]:
        from ..conformance.conformance import ConformanceParams, check

        result = check(ConformanceParams(
            path=reg["path"], level=int(reg["level"]), fps=int(reg["fps"]),
        ))
        print(result.report())
        if not result.ok:
            print("conformance: FAILED", file=sys.stderr)
    write_wall_seconds(params.test_name, sw)
    print_run_footer("rabbit-transcode", sw)
    return 0


def _run(params, reg, device):
    reader = V3CReader()
    with open(params.compressedStreamPath, "rb") as f:
        data = f.read()
    print(
        f"input: {params.compressedStreamPath} ({len(data)} bytes, "
        f"md5 {hashlib.md5(data).hexdigest()})"
    )
    gofs = reader.read(data)
    transcoder = Transcoder(params, device)
    writer = V3CWriter()
    out_units = []
    tracer = None
    if reg["trace"]:
        from ..utils.tracing import TraceCategory, Tracer

        tracer = Tracer(prefix="enc_").enable(*TraceCategory)
    for gof_idx, gof in enumerate(gofs):
        context = reader.decode(gof)
        context.check_profile()  # PccAppTranscoder.cpp:318
        for atlas in list(context.atlases):
            transcoder.transcode(context, atlas.atlas_id)
        if tracer is not None:
            from ..codec.patch_frame import decode_patch_frames
            from ..codec.trace import emit_conformance_traces
            from ..decoder.decoder import Decoder

            # reconstruct the transcoded GOF so the pcframe log exists —
            # the conformance comparator requires every enc_/dec_ pair;
            # one emission per atlas, namespaced by atlas id (the dec side
            # emits the same keys per atlas)
            for atlas in context.atlases:
                emit_conformance_traces(
                    tracer, atlas, decode_patch_frames(atlas),
                    Decoder(device=device).decode(context, atlas.atlas_id),
                    gof=gof_idx, atlas_id=atlas.atlas_id,
                )
        out_units.extend(writer.encode(context))
        print(f"GOF {gof_idx}: {context.atlas_count} atlas(es) transcoded")
    n = writer.write_file(out_units, params.outStreamPath)
    return transcoder, writer, n, tracer


if __name__ == "__main__":
    sys.exit(main())
