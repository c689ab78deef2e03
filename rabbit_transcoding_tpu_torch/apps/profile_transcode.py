"""Where the time of the live transcode goes, at the benchmark cell.

    python -m rabbit_transcoding_tpu_torch.apps.profile_transcode \
        [--device cuda] [--frames 32] [--size 1024] [--runs 5] \
        [--tools plain|mc_intra] [--streams 1] [--out FILE]

Three views of the same transcode (the 1024x1024, 32-frame benchmark stream
to geometry QP 32 / attribute QP 42 in ``reencode`` mode, hash SEI on).
``--tools=mc_intra`` codes the stream's lossy planes as the repo's encoder
does by default (motion compensation with the occupancy-weighted search,
mosaic intra I frames), so the transcode runs the plain MC and intra chains
on the device instead of the fused kernel.  ``--streams=S`` (S > 1) times
and profiles S streams (the stream requantised to input QPs 16, 18, ...)
through one ``MultiStreamTranscoder`` call per GOF instead:

1. wall seconds per GOF over ``--runs`` runs after 2 warm-ups, with the
   transcoder's ``StageTimer`` stages (median over the runs);
2. ``torch.profiler`` over one more run: on a card, the device's busy share
   of the wall time (the union of its kernels, copies and sets) and its
   time per kernel and copy;
3. the program's own spans in that run (``utils/timing``): their summed
   milliseconds by name, then one row per lossy plane (and stream) with
   its ``entropy_decode``, ``submit`` and ``entropy_encode`` milliseconds,
   the backend that won the coefficient blob's race, and its blocking
   uploads and downloads with their bytes.

Everything printed is also written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from ..device import resolve
from ..ops.events import device_busy_s
from ..testdata import make_stream, with_input_qps
from ..transcoder import (
    MultiStreamTranscoder, Transcoder, TranscoderParameters, V3CReader,
    V3CWriter,
)
from ..utils import timing

GEO_QP, ATTR_QP = 32, 42


def _card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span_table(spans: list[timing.Span]) -> list[str]:
    """The spans' summed milliseconds by name (threads overlap, so the sums
    can pass the wall time), then one row per lossy plane: the stage it
    ran in, its stream and plane index, its entropy decode, submit and
    entropy encode milliseconds, the race's winner and its copies."""
    by_id = {s.id: s for s in spans}
    totals: dict[str, float] = defaultdict(float)
    rows: dict[tuple, dict] = {}
    for s in spans:
        totals[s.name] += 1e3 * (s.t1 - s.t0)
        if s.plane is None:
            continue
        # the stage the plane ran in: the ancestor just under ``transcode``
        top = s
        while top.parent in by_id and by_id[top.parent].name != "transcode":
            top = by_id[top.parent]
        row = rows.setdefault((top.name, s.stream, s.plane), defaultdict(
            float, won="-"))
        if s.name in ("upload", "download"):
            row[s.name + "s"] += 1
            row[s.name + "_bytes"] += s.counts["bytes"]
        elif s.name == "race":
            if s.counts["won"]:
                row["won"] = s.counts["candidate"]
        else:
            row[s.name] += 1e3 * (s.t1 - s.t0)
    lines = ["spans_ms " + json.dumps({k: round(v, 3)
                                       for k, v in totals.items()})]
    # a batched submit (stream None) before the streams of its plane
    for (stage, stream, plane), row in sorted(
            rows.items(), key=lambda kv: (kv[0][0], kv[0][2],
                                          -1 if kv[0][1] is None
                                          else kv[0][1])):
        lines.append(
            f"plane {stage} stream {stream} #{plane}: entropy_decode "
            f"{row['entropy_decode']:.3f} ms, submit {row['submit']:.3f} ms, "
            f"entropy_encode {row['entropy_encode']:.3f} ms, race won by "
            f"{row['won']}, {row['uploads']:.0f} uploads "
            f"({row['upload_bytes']:.0f} B), {row['downloads']:.0f} "
            f"downloads ({row['download_bytes']:.0f} B)")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--tools", choices=("plain", "mc_intra"),
                    default="plain")
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    lines: list[str] = []

    def emit(text: str) -> None:
        print(text, flush=True)
        lines.append(text)

    card = _card()
    emit(f"card {card}; torch {torch.__version__}; device {dev}; "
         f"{args.frames} frames of {args.size}x{args.size}; "
         f"tools {args.tools}; streams {args.streams}")
    mc_intra = args.tools == "mc_intra"
    data = make_stream(args.frames, args.size, args.size, device=dev,
                       motion=mc_intra, intra=mc_intra)
    params = TranscoderParameters(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                  mode="reencode", computeHashSei=True)
    reader = V3CReader()
    units = reader.read(data)[0]
    streams = [reader.read(with_input_qps(data, 16 + 2 * i, 22 + 2 * i,
                                          dev))[0]
               for i in range(args.streams)] if args.streams > 1 else []

    def run() -> tuple[float, dict[str, float]]:
        t0 = time.perf_counter()
        writer = V3CWriter()
        if streams:
            contexts = [reader.decode(list(u)) for u in streams]
            transcoder = MultiStreamTranscoder(params, dev)
            transcoder.transcode_many(contexts)
            for context in contexts:
                writer.write(writer.encode(context))
        else:
            context = reader.decode(list(units))
            transcoder = Transcoder(params, dev)
            transcoder.transcode(context)
            writer.write(writer.encode(context))
        _sync(dev)
        return time.perf_counter() - t0, transcoder.timer.stages

    # 1. wall per GOF and the transcoder's stages
    for _ in range(2):
        run()
    walls, stages = [], []
    for _ in range(args.runs):
        wall, st = run()
        walls.append(wall)
        stages.append(st)
    median = statistics.median(walls)
    emit(f"walls_s {walls!r} median_s {median!r} "
         f"frames_per_s {args.frames * max(1, args.streams) / median!r}")
    emit("stage_ms_median " + json.dumps(
        {k: statistics.median(s[k] for s in stages) for k in stages[0]}))

    # 2. the device's share of one run, 3. the program's spans in it
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    timing.RECORDER.clear()
    with profile(activities=activities) as prof:
        wall, _ = run()
    if dev.type == "cuda":
        busy_s = device_busy_s(prof)
        emit(f"profiled_wall_s {wall!r} device_busy_s {busy_s!r} "
             f"busy_share {busy_s / wall!r}")
        emit(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=15,
            max_name_column_width=60))
    else:
        emit("device busy share: not measured (CPU run)")
    for line in span_table(timing.RECORDER.spans):
        emit(line)

    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
