"""rabbit-transcode on PyTorch: the PccAppTranscoder analog.

Port of ``rabbit_transcoding_tpu/apps/transcode.py``: parse options (the
reference's names) -> read the V3C stream -> per GOF decode, transcode each
atlas, re-encode -> write the out stream, wall time + '<test_name>.txt'.

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
from .common import build_registry, parse_or_help

# reference options the port accepts but does not implement yet
_NOT_PORTED = ("profileDir", "trace", "checkConformance")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = TranscoderParameters()
    reg = build_registry(
        params,
        extra={
            "device": ("cuda", "torch device: cuda (the GPU kernels) or cpu "
                               "(the plain PyTorch versions)"),
            "profileDir": ("", "profiler trace directory (not ported yet)"),
            "trace": (False, "conformance trace logs (not ported yet)"),
            "checkConformance": (False, "conformance comparator (not ported "
                                        "yet)"),
            "path": ("", "conformance files root + prefix"),
            "level": (30, "level indice for the limit checks"),
            "fps": (30, "frames per second for the level checks"),
        },
    )
    if parse_or_help(reg, argv, params, "rabbit-transcode") is None:
        return 0
    for name in _NOT_PORTED:
        if reg[name]:
            raise NotImplementedError(
                f"--{name} is not ported yet (ROADMAP, queue 1 item 9)")
    if not params.compressedStreamPath:
        print("error: --compressedStreamPath is required", file=sys.stderr)
        return 1
    device = resolve(reg["device"])

    sw = Stopwatch()
    sw.start()
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
    for gof_idx, gof in enumerate(gofs):
        context = reader.decode(gof)
        context.check_profile()
        for atlas in list(context.atlases):
            transcoder.transcode(context, atlas.atlas_id)
        out_units.extend(writer.encode(context))
        print(f"GOF {gof_idx}: {context.atlas_count} atlas(es) transcoded")
    n = writer.write_file(out_units, params.outStreamPath)
    sw.stop()

    print(f"output: {params.outStreamPath} ({n} bytes) on {device}")
    print(transcoder.timer.report())
    print(writer.stat.report())
    write_wall_seconds(params.test_name, sw)
    print_run_footer("rabbit-transcode", sw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
