"""Where the time of the V-PCC decode goes, at the decode cell.

    python -m rabbit_transcoding_tpu_torch.apps.profile_decode \
        [--device cuda] [--frames 32] [--size 1024] [--runs 3] \
        [--smoothing 1] [--map-pair 0] [--out FILE]

Three views of ``Decoder(device).decode`` of one GOF of the patch-carrying
test stream (``testdata.make_stream(patches=True)``; ``--smoothing=1`` adds
the geometry- and attribute-smoothing SEIs, ``--map-pair=1`` codes two maps
in per-map sub-streams):

1. wall seconds per GOF over ``--runs`` runs after one warm-up, with the
   decoder's ``StageTimer`` stages (median over the runs) and the points per
   frame;
2. ``torch.profiler`` over one run: the device's busy share of the wall
   time and its time per kernel and copy (CUDA only);
3. ``cProfile`` over one run: the host functions by cumulative time.

Everything printed is also written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import subprocess
import time

import torch

from ..bitstream import V3CReader
from ..decoder.decoder import Decoder
from ..device import resolve
from ..ops.events import device_busy_us
from ..testdata import make_stream


def _card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--smoothing", type=int, default=1)
    ap.add_argument("--map-pair", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    lines: list[str] = []

    def emit(text: str) -> None:
        print(text, flush=True)
        lines.append(text)

    emit(f"card {_card()}; torch {torch.__version__}; device {dev}; "
         f"{args.frames} frames of {args.size}x{args.size}; smoothing "
         f"{args.smoothing}; map pair {args.map_pair}")
    data = make_stream(args.frames, args.size, args.size, device=dev,
                       patches=True, smoothing=bool(args.smoothing),
                       map_pair=bool(args.map_pair))
    reader = V3CReader()
    units = reader.read(data)[0]

    def run():
        t0 = time.perf_counter()
        decoder = Decoder(device=dev)
        clouds = decoder.decode(reader.decode(list(units)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, decoder.timer.stages, clouds

    # 1. wall per GOF and the decoder's stages
    run()
    walls, stages = [], []
    for _ in range(args.runs):
        wall, st, clouds = run()
        walls.append(wall)
        stages.append(st)
    median = statistics.median(walls)
    emit(f"walls_s {walls!r} median_s {median!r} "
         f"frames_per_s {args.frames / median!r}")
    emit("stage_ms_median " + json.dumps(
        {k: statistics.median(s[k] for s in stages) for k in stages[0]}))
    emit(f"points_per_frame {[ps.point_count for ps in clouds]!r}")

    # 2. the device's share of one run
    if dev.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _, _ = run()
        events = prof.key_averages()
        busy_us = device_busy_us(events)
        launches = sum(e.count for e in events
                       if e.device_type == DeviceType.CUDA)
        emit(f"profiled_wall_s {wall!r} device_busy_us {busy_us!r} "
             f"busy_share {busy_us * 1e-6 / wall!r} "
             f"device_launches {launches!r}")
        emit(events.table(sort_by="self_device_time_total", row_limit=15,
                          max_name_column_width=60))
    else:
        emit("device busy share: not measured (CPU run)")

    # 3. the host's side of one run
    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(25)
    emit(text.getvalue())

    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
