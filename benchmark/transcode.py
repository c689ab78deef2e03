"""What the transcode protocols share: the input streams made from the seed,
the program's V3C read and write and its transcoder parameters, the stream
app's start-up link probe, and the judgement of a window's outputs against
the plain reference.  A protocol of another kind (a decode, say) brings its
own ``inputs``, ``expected`` and ``judge``."""

from __future__ import annotations

import hashlib
import struct
import zlib

from . import gen
from .harness import log
from .reference import check, stream as ref_stream


def read_v3c(data: bytes):
    from rabbit_transcoding_tpu_torch.bitstream import V3CReader

    reader = V3CReader()
    return reader.decode(reader.read(data)[0])


def write_v3c(context) -> bytes:
    from rabbit_transcoding_tpu_torch.bitstream import V3CWriter

    writer = V3CWriter()
    return writer.write(writer.encode(context))


def params(config: dict):
    from rabbit_transcoding_tpu_torch.transcoder import TranscoderParameters

    t = config["transcode"]
    return TranscoderParameters(
        geometryQP=config["geometry"]["qp_out"],
        attributeQP=config["attribute"]["qp_out"], mode=t["mode"],
        videoGopSize=t["gop_out"],
        occupancyPrecision=config["atlas"]["occupancy_precision"],
        computeHashSei=t["hash_sei"])


def probe_link(device) -> None:
    """The stream app's start-up probe: one timed host -> device push."""
    from rabbit_transcoding_tpu_torch.video import rbv

    if device.type == "cuda":
        log(f"link {rbv.measure_link_rate(device=device):.1f} MB/s")


def inputs(cell, seed: int, device) -> list[bytes]:
    """The cell's input streams: stream i from seed ``seed + i``."""
    out = []
    for i in range(cell.traffic["streams"]):
        data = gen.stream(cell.config, seed + i, device)
        log(f"input stream {i}: seed {seed + i}, {len(data)} bytes, sha256 "
            f"{hashlib.sha256(data).hexdigest()}")
        out.append(data)
    return out


def expected(cell, data: bytes, device) -> check.Gof:
    """What the configuration's transcode of ``data`` has to give."""
    cfg = cell.config
    return check.expected(data, {ref_stream.GVD: cfg["geometry"]["qp_out"],
                                 ref_stream.AVD: cfg["attribute"]["qp_out"]},
                          cfg["transcode"]["gop_out"], device)


def judge(cell, inputs: list[bytes], rec,
          device) -> dict[str, tuple[float, float]]:
    """Every distinct output of the window against the reference ->
    {number: (reading, limit)}."""
    numbers, unread = [], 0
    for i, data in enumerate(inputs):
        outs = rec.outputs.get(i, {})
        unread += not outs
        want = expected(cell, data, device)
        for out in outs.values():
            try:
                got = check.parse(out)
            except (ValueError, IndexError, KeyError, struct.error,
                    zlib.error) as e:
                log(f"stream {i}: an output does not parse: {e!r}")
                unread += 1
                continue
            numbers.append(check.compare(want, got, device))
    worst = check.worst(numbers) if numbers else {}
    worst["unread"] = unread
    limits = cell.config["limits"]
    return {k: (worst.get(k, float("inf")), limits[k]) for k in limits}
