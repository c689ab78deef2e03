"""In-process CTC rate-ladder runner (the fast path to RESULTS.md) on the
PyTorch port.

Twin of the repo's ``scripts/ladder.py``, same protocol as
``scripts/run_ctc.sh`` (encode once at high quality, transcode to r1..r5 in
all three modes, decode + D1/D2/Y metrics vs the source), in one process.
Every stage (``Encoder``, ``Transcoder``, ``Decoder``,
``compute_sequence_metrics``) runs on ``--device``: the card unless the
caller asks for the CPU (no card raises).

    python -m rabbit_transcoding_tpu_torch.scripts.ladder \\
        [sphere|blobs] [frames] [points] [--device cuda|cpu]

Prints the RESULTS.md tables as CSV on stdout (progress on stderr).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..bitstream import V3CReader, V3CWriter
from ..core.gof import GroupOfFrames
from ..decoder.decoder import Decoder
from ..device import resolve
from ..encoder.encoder import Encoder
from ..encoder.params import EncoderParameters
from ..metrics.metrics import MetricsParams, compute_sequence_metrics
from ..testdata import SCENES
from ..transcoder.params import TranscoderParameters
from ..transcoder.transcoder import Transcoder

RATES = {  # cfg/rate/ctc-r*.cfg: (geometryQP, attributeQP, occupancyPrecision)
    "r1": (32, 42, 4),
    "r2": (28, 37, 4),
    "r3": (24, 32, 4),
    "r4": (20, 27, 4),
    "r5": (16, 22, 2),
}
MODES = ("reencode", "requant", "auto")
HEADER = "scene;rate;mode;stream_bytes;d1_psnr;d2_psnr;y_psnr"
DELTA_HEADER = ("scene;rate;d1_reencode;d1_requant;d1_delta;d1_auto;"
                "d1_delta_auto;y_reencode;y_requant;y_delta;y_auto;"
                "y_delta_auto")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sources_of(scene: str, frames: int, points: int) -> list:
    return [SCENES[scene](i, n=points) for i in range(frames)]


def encode_hq(sources: list, device) -> bytes:
    """The high-quality input: QP 8 / 12, occupancy precision 2, one GOF."""
    enc = Encoder(EncoderParameters(
        minimumImageWidth=512, minimumImageHeight=128,
        geometryQP=8, attributeQP=12, occupancyPrecision=2,
        frameCount=len(sources), groupOfFramesSize=len(sources),
    ), device)
    context, _ = enc.encode(GroupOfFrames(sources))
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def run_cell(hq: bytes, sources: list, rate: tuple[int, int, int],
             mode: str, device):
    """One cell: transcode ``hq`` to ``rate`` (geometry QP, attribute QP,
    occupancy precision) in ``mode``, decode, measure -> (output bytes,
    decoded clouds, sequence metrics)."""
    gqp, aqp, occ = rate
    reader, writer = V3CReader(), V3CWriter()
    tc = Transcoder(TranscoderParameters(
        geometryQP=gqp, attributeQP=aqp, occupancyPrecision=occ,
        mode=mode, computeHashSei=False,
    ), device)
    ctx = reader.decode(reader.read(hq)[0])
    tc.transcode(ctx)
    out = writer.write(writer.encode(ctx))
    clouds = Decoder(device=device).decode(reader.decode(reader.read(out)[0]))
    _, m = compute_sequence_metrics(sources, clouds,
                                    MetricsParams(resolution=1023),
                                    device=device)
    return out, clouds, m


def run(scene: str = "sphere", frames: int = 4, points: int = 40000,
        device="cuda") -> tuple[bytes, dict]:
    """The ladder over ``RATES`` x ``MODES``, the CSV printed as it goes ->
    (hq bytes, {(rate, mode): (bytes, clouds, metrics)})."""
    device = resolve(device)
    t0 = time.time()
    sources = sources_of(scene, frames, points)
    log(f"{scene}: {frames} frames, "
        f"{[s.point_count for s in sources]} points")
    hq = encode_hq(sources, device)
    log(f"hq.bin: {len(hq)} bytes ({time.time() - t0:.0f}s)")

    print(HEADER)
    cells = {}
    for rate in RATES:
        for mode in MODES:
            t1 = time.time()
            out, clouds, m = run_cell(hq, sources, RATES[rate], mode,
                                      device)
            print(f"{scene};{rate};{mode};{len(out)};{m.d1_psnr:.4f};"
                  f"{m.d2_psnr:.4f};{m.color_psnr[0]:.4f}", flush=True)
            cells[(rate, mode)] = out, clouds, m
            log(f"  {rate}/{mode}: {time.time() - t1:.0f}s")
    log(f"total {time.time() - t0:.0f}s")
    return hq, cells


def delta_table(scene: str, cells: dict) -> None:
    """The within-bar table: auto must hold D1 delta <= 0.05 dB AND Y delta
    <= 0.1 dB vs the full-re-encode baseline."""
    d1 = {k: v[2].d1_psnr for k, v in cells.items()}
    ypsnr = {k: v[2].color_psnr[0] for k, v in cells.items()}
    print(DELTA_HEADER)
    for rate in RATES:
        base = d1[(rate, "reencode")]
        ybase = ypsnr[(rate, "reencode")]
        print(f"{scene};{rate};{base:.4f};{d1[(rate, 'requant')]:.4f};"
              f"{base - d1[(rate, 'requant')]:+.4f};"
              f"{d1[(rate, 'auto')]:.4f};{base - d1[(rate, 'auto')]:+.4f};"
              f"{ybase:.4f};{ypsnr[(rate, 'requant')]:.4f};"
              f"{ybase - ypsnr[(rate, 'requant')]:+.4f};"
              f"{ypsnr[(rate, 'auto')]:.4f};"
              f"{ybase - ypsnr[(rate, 'auto')]:+.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", nargs="?", default="sphere")
    ap.add_argument("frames", nargs="?", type=int, default=4)
    ap.add_argument("points", nargs="?", type=int, default=40000)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a "
                         "GPU) or cpu")
    args = ap.parse_args(argv)
    _, cells = run(args.scene, args.frames, args.points, args.device)
    delta_table(args.scene, cells)
    return 0


if __name__ == "__main__":
    sys.exit(main())
