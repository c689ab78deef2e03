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
through one ``MultiStreamTranscoder`` call per GOF instead (views 1 and 2;
view 3 stays the first stream's):

1. wall seconds per GOF over ``--runs`` runs after 2 warm-ups, with the
   transcoder's ``StageTimer`` stages (median over the runs);
2. ``torch.profiler`` over one run: the device's busy share of the wall
   time and its time per kernel and copy (CUDA only);
3. the lossy planes one at a time, each step synchronised: entropy decode
   with upload, the device transcode (the fused kernel, or the MC / intra
   chains), the V3C read and write, and the whole entropy encode
   (``encode_blob_total``: freq-major gather, nonzero count, slab download
   and the backend race), with its first two parts also timed alone.

Everything printed is also written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import struct
import subprocess
import time

import numpy as np
import torch

from ..device import resolve
from ..ops.events import device_busy_us
from ..testdata import make_stream, with_input_qps
from ..transcoder import (
    ColorFormat, MultiStreamTranscoder, Transcoder, TranscoderParameters,
    V3CReader, V3CWriter, VideoType,
)
from ..video import rbv

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

    # 2. the device's share of one run
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = run()
        events = prof.key_averages()
        busy_us = device_busy_us(events)
        emit(f"profiled_wall_s {wall!r} device_busy_us {busy_us!r} "
             f"busy_share {busy_us * 1e-6 / wall!r}")
        emit(events.table(sort_by="self_device_time_total", row_limit=15,
                          max_name_column_width=60))
    else:
        emit("device busy share: not measured (CPU run)")

    # 3. the lossy planes one step at a time
    steps = dict.fromkeys(("v3c_read", "decode_blob", "device_transcode",
                           "freq_major_nnz", "slab_download",
                           "encode_blob_total", "v3c_write"), 0.0)

    def timed(name, fn, *a):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*a)
        _sync(dev)
        steps[name] += time.perf_counter() - t0
        return out

    context = timed("v3c_read", lambda: reader.decode(list(units)))
    atlas = context.atlas(0)
    for vt, qp in ((VideoType.GEOMETRY, GEO_QP), (VideoType.ATTRIBUTE,
                                                   ATTR_QP)):
        payload = atlas.get_video_bitstream(vt).data
        flags, w, h, bitdepth, chroma, f, b, gop, qp_in = rbv._parse_header(
            payload)
        dims = rbv._plane_dims(w, h, ColorFormat(chroma))
        for (ph, pw), blob in zip(dims, rbv._iter_blobs(payload, len(dims))):
            pl = timed("decode_blob", rbv._Plane, blob, flags, f, ph, pw, b,
                       gop, dev)
            q2, _ = timed("device_transcode", rbv._transcode_plane, pl,
                          rbv._f32(rbv.qstep_of(qp_in)),
                          rbv._f32(rbv.qstep_of(qp)),
                          float((1 << bitdepth) - 1), gop,
                          gop if pl.mv is not None else params.videoGopSize,
                          bool(flags & 4), bool(flags & 8), 0)

            def freq_major():
                qf = rbv._to_freq_major(q2)
                return qf, rbv._freq_nnz(qf).cpu().numpy()

            qf, nnz = timed("freq_major_nnz", freq_major)
            nz = np.nonzero(nnz)[0]
            kmax = rbv._bucket_kmax(int(nz.max()) + 1, b * b) if len(nz) else 0
            timed("slab_download", lambda: qf[:, :kmax].contiguous().cpu())
            out = timed("encode_blob_total", rbv._encode_coeff_blob, q2)
            (kmax_in,) = struct.unpack_from("<H", pl.coeff_blob, 1)
            (kmax_out,) = struct.unpack_from("<H", out, 1)
            emit(f"plane {vt.name} {pw}x{ph}: kmax in {kmax_in} "
                 f"({pl.coeff_blob[3:4].decode()}), out {kmax_out} "
                 f"({out[3:4].decode()})")
    writer = V3CWriter()
    timed("v3c_write", lambda: writer.write(writer.encode(context)))
    emit("serial_steps_s " + json.dumps(steps))

    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
