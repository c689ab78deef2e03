#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: the live RBV transcode,
the V-PCC decode, and the normals and quality metrics on streams that the
V-PCC encoder wrote.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one result line each; any failure raises and the exit code is not 0:

1. environment: the card's name and power limit, torch and nvcc versions,
   and the port's native library with its three sources (rANS, the grid
   KNN, the spanning-tree orientation; built with g++: without it the
   entropy coder would fall back to zlib and the KNN to a KD-tree, and
   change what is measured);
2. build: nvcc compiles the port's CUDA sources (``csrc/*.cu``); ptxas's
   registers and spills per kernel (no spills allowed);
3. kernel check: the fused transcode kernel against its plain PyTorch version
   on the card, at the test shapes and at the main path's shapes (geometry
   luma (32, 64, 64, 16, 16), chroma (32, 32, 32, 16, 16)), with both times
   and the kernel's bound (``ops.transcode.transcode_bound_ms``, and its
   dense count) and share of it.  The kernel's ``ms`` is timed around the
   wrapper call, host work included, as every earlier PR timed it;
   ``device_ms`` times the device work alone (``ops/events.py``);
4. main path: the 1024x1024, 32-frame benchmark stream (10-bit geometry and
   8-bit YUV420 attribute, lossy RBV at GOP 2; lossless occupancy),
   transcoded to geometry QP 32 / attribute QP 42 in ``reencode`` mode by
   ``Transcoder(device=cuda)``: one warm-up and 3 timed runs, 4 kernel
   launches per run, every output sub-stream decodes, and the coefficients
   match a ``device=cpu`` run of the same transcode;
5. MC + intra stream: the same content coded as the repo's encoder codes it
   by default (motion-compensated P frames with the occupancy-weighted
   search, mosaic intra I frames, GOP 2), built on the card;
6. MC + intra ``reencode``: that stream through ``Transcoder(device=cuda)``
   at the same QPs, one warm-up and 3 timed runs, with 0 launches of the
   kernel (the branch runs the plain chains on the card), every output
   sub-stream decoding, and the output held against a ``device=cpu`` run;
7. ``requant`` mode on both streams (the bench stream requantises drift-
   compensated, the MC + intra stream open-loop), timed and held against
   ``device=cpu`` runs in the same way;
8. batched kernel: the stream-axis launch over S = 4 luma stacks
   (4, 32, 64, 64, 16, 16) at input QPs 16/18/20/22 against 4 single-stream
   launches (equal) and against its plain version, with both times, the
   bound and the share;
9. multi-stream, bench streams: S = 1, 2, 4 streams (the bench stream
   requantised to input QPs 16/18/20/22) through
   ``MultiStreamTranscoder(device=cuda).transcode_many``, one warm-up and 3
   timed runs, 4 kernel launches per run whatever S, every output equal to
   ``Transcoder(device=cuda)`` on that stream alone; aggregate frames/s of
   the batched run and of the sequential loop;
10. multi-stream, MC + intra: phase 5's stream and a requantised copy, the
    batched plain chains against the sequential port;
11. lossless input over an occupancy map (push-pull fill), a predicted map
    pair (built without MC) and ABR (on the bench stream, targeting phase
    4's output bit rate at 30 fps), each at 1024x1024, timed, and held
    against a ``device=cpu`` run at 256x256, 8 frames;
12. stream app: ``transcode_streams_sharded`` over 2 streams x 2 GOFs equals
    ``transcode_stream`` on each, with no batched-round failure;
13. decode streams: the patch-carrying stream (256 patches per frame, both
    smoothing SEIs) at 1024x1024, 32 frames, built on the card, and the same
    with the MC + intra coding tools;
14. decode: ``Decoder(device=cuda).decode`` of that GOF, one warm-up and 3
    timed runs: decode frames/s, the decoder's stages, points per frame and
    the clouds' checksums; two runs give equal clouds (arrays, in order);
    the MC + intra stream once for its time.  Held against ``device=cpu``
    at 256x256, 8 frames, and at full size when the small CPU run predicts
    under a minute for it: positions, types and partition equal exactly;
    colours may differ at a share of points of at most 1e-4, and only at
    points the smoothing filters may move;
15. decode, map pair: the dual-map stream against ``device=cpu`` at 256x256,
    8 frames, and once at full size for its time;
16. transcode, then decode: phase 4's transcoded videos under the patch
    stream's atlas, decoded; the point count and the share of points at a
    position that the input's decode does not have; D1, D2 and Y/U/V PSNR
    of ``METRIC_FRAMES`` of the 32 transcoded clouds against the input
    stream's clouds (normals on the card), with the seconds per frame;
17. decode app: ``apps/decode.py --device=cuda`` on the stream file, PLYs
    written, checksums equal to the library call's;
18. normals: ``compute_normals`` and ``generate_normals`` on a dense cloud of
    a real frame's size (``make_dense_frame``), on the card and on the CPU:
    seconds of each, of the host KNN, the device's covariance + ``eigh`` and
    the host's spanning tree; covariances equal bit for bit; the share of
    oriented normals beyond 1e-5 and 1e-3 rad between card and CPU;
19. encoder streams: each committed stream that the V-PCC encoder wrote
    (``tests/fixtures_torch/``) decoded on the card: the reference decoder's
    checksums (committed beside the stream) and the ``device=cpu`` decode's;
    then transcoded on the card (``reencode``, geometry QP 32 / attribute QP
    42), bytes equal to ``device=cpu``;
20. metrics: ``compute_sequence_metrics`` of those decodes against the
    committed source clouds, normals on the card: every field that passes
    through no normal equal to the committed reference value, D2 within
    ``D2_BOUND_DB`` (PSNRs) and ``D2_BOUND_REL`` (mse, Hausdorff); the same
    of the transcoded streams' decodes (printed);
21. metrics apps: ``apps/decode.py --computeMetrics`` and ``apps/metrics.py``
    on the first encoder stream with ``--device=cuda``: summary lines equal
    to the library call's.

The kernel table as JSON and the card's name and power limit come before
the last line, ``{"ok": true, "device": {...}}``.  Imports only the port,
which imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import rabbit_transcoding_tpu_torch
from rabbit_transcoding_tpu_torch import native, testdata
from rabbit_transcoding_tpu_torch.ops import _build
from rabbit_transcoding_tpu_torch.ops import transcode as tc
from rabbit_transcoding_tpu_torch.apps import decode as decode_app
from rabbit_transcoding_tpu_torch.apps import metrics as metrics_app
from rabbit_transcoding_tpu_torch.apps import stream as stream_app
from rabbit_transcoding_tpu_torch.bitstream.video_bitstream import (
    VideoBitstream,
)
from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames
from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder
from rabbit_transcoding_tpu_torch.encoder import normals as nm
from rabbit_transcoding_tpu_torch.metrics.metrics import (
    compute_sequence_metrics,
)
from rabbit_transcoding_tpu_torch.ops.events import median_ms
from rabbit_transcoding_tpu_torch.testdata import (
    make_stream, stream_coeffs, stream_planes, with_input_qps,
)
from rabbit_transcoding_tpu_torch.transcoder import (
    MultiStreamTranscoder, Transcoder, TranscoderParameters, V3CReader,
    V3CWriter, VideoType,
)
from rabbit_transcoding_tpu_torch.video import rbv

# share of differing coefficients and largest |difference| the GPU output
# may show against the CPU's (a float rounding-order flip at a .5 boundary
# moves a coefficient by 1), for every path (coefficients and intra
# mode-map entries; motion vectors pass through or come from the stream and
# must be equal).  The kernel itself must equal its plain version exactly:
# both sum in the same order.
MAX_SHARE = 1e-4
MAX_DIFF = 1
FRAMES, WIDTH, HEIGHT = 32, 1024, 1024
GEO_QP, ATTR_QP = 32, 42
KERNEL_SOURCE = "rabbit_transcoding_tpu_torch/csrc/transcode_gops.cu"
REPLACES = "rabbit_transcoding_tpu/ops/pallas_transcode.py:86"
# input QPs (geometry; attribute + 6) of the multi-stream phases' streams
STREAM_QPS = (16, 18, 20, 22)
# the reduced size of the CPU runs that the lossless, map-pair and ABR
# phases are held against
SMALL = (8, 256, 256)
# share of points whose colour the GPU decode may give differently from the
# CPU decode (the gated colour filter adds non-integer luma sums per cell)
MAX_COLOR_SHARE = 1e-4
# a full-size CPU decode is run when the small one predicts less than this
CPU_FULL_LIMIT_S = 60.0
# the frames of the transcoded main-path GOF whose quality is measured
METRIC_FRAMES = tuple(range(0, FRAMES, 4))
# points asked of ``make_dense_frame`` for the normals phase (~480,000 left
# after the duplicates go: a real frame's size)
NORMALS_POINTS = 800_000
# oriented unit normals, card against CPU (cuSOLVER against LAPACK): the
# share of normals further than 1e-3 rad apart may be at most this (measured:
# none beyond 1e-5 rad, the largest angle 4.0e-6 rad; a flipped component of
# the spanning tree would show here)
MAX_NORMAL_SHARE = 1e-4
# D2 PSNRs with the normals computed on the card against the committed
# reference values (normals by the reference's eigh on the CPU), in dB
# (measured: at most 3.9e-7 dB)
D2_BOUND_DB = 1e-5
# the same of ``d2_mse`` and ``d2_hausdorff``, relative to the reference value
D2_BOUND_REL = 1e-6
D2_FIELDS = ("d2_mse", "d2_psnr", "d2_hausdorff", "d2_hausdorff_psnr")


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def compare(a: torch.Tensor, b: torch.Tensor) -> tuple[float, int]:
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return (d > 0).float().mean().item(), int(d.max().item())


def gpu_vs_cpu(name: str, got: bytes, want: bytes, dev, **fields) -> None:
    """Hold the card's output stream against the CPU's: equal bytes, or
    else every coefficient and mode-map entry within MAX_SHARE / MAX_DIFF
    and equal motion vectors."""
    a, b = stream_planes(got, dev), stream_planes(want, dev)
    worst_q, worst_mode, mv_equal = (0.0, 0), (0.0, 0), True
    check(a.keys() == b.keys(), f"{name}: video sets {a.keys()} {b.keys()}")
    for key in b:
        worst_q = max(worst_q, compare(a[key].q, b[key].q))
        if b[key].mode is not None:
            worst_mode = max(worst_mode, compare(
                torch.from_numpy(a[key].mode), torch.from_numpy(b[key].mode)))
        if b[key].mv is not None:
            mv_equal &= bool(np.array_equal(a[key].mv, b[key].mv))
    phase(name, bytes_equal=got == want, coeff_share=worst_q[0],
          coeff_max_abs_diff=worst_q[1], mode_share=worst_mode[0],
          mode_max_abs_diff=worst_mode[1], mv_equal=mv_equal, **fields)
    check(worst_q[0] <= MAX_SHARE and worst_q[1] <= MAX_DIFF,
          f"{name}: GPU vs CPU coefficients {worst_q}")
    check(worst_mode[0] <= MAX_SHARE and worst_mode[1] <= MAX_DIFF,
          f"{name}: GPU vs CPU mode maps {worst_mode}")
    check(mv_equal, f"{name}: GPU vs CPU motion vectors differ")


def check_decodes(out: bytes, dev) -> None:
    """Every output sub-stream decodes with the port at the stream's size."""
    reader_out = V3CReader()
    atlas = reader_out.decode(reader_out.read(out)[0]).atlas(0)
    for vt, vb in atlas.video_bitstreams.items():
        video = rbv.decode(vb.data, dev)
        want_w = WIDTH // 2 if vt == VideoType.OCCUPANCY else WIDTH
        check(video.frame_count == FRAMES and video.width == want_w
              and all(p.shape[0] == FRAMES for p in video.planes),
              f"{vt.name}: decoded {video.frame_count} frames of "
              f"{video.width}x{video.height}")


def timed_runs(run, n: int = 3) -> tuple[bytes, list[float]]:
    """One warm-up, then ``n`` timed runs: (last output, wall seconds)."""
    walls = []
    for i in range(n + 1):
        t0 = time.perf_counter()
        out = run()
        if i:
            walls.append(time.perf_counter() - t0)
    return out, walls


def qstep(qp: int) -> float:
    return float(np.float32(rbv.qstep_of(qp)))


def kernel_times(fn, n: int = 20) -> tuple[float, float]:
    """(ms, device_ms) of ``fn()`` by CUDA events: around the whole call
    (the wrapper's host work included, as in every earlier measurement), and
    of the device work alone."""
    return median_ms(fn, n), median_ms(fn, n, device_only=True)


def write_context(context) -> bytes:
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def transcode_bytes(data: bytes, device, params,
                    transcoder=None) -> bytes:
    """The first GOF of ``data`` through ``Transcoder(params, device)`` (or
    the given one) -> V3C bytes, the device synchronised."""
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    (transcoder or Transcoder(params, device)).transcode(context)
    out = write_context(context)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


def transcode_many_bytes(datas: list[bytes], device, params,
                         mst=None) -> list[bytes]:
    """The first GOF of each stream through one ``MultiStreamTranscoder``
    call -> V3C bytes per stream, the device synchronised."""
    reader = V3CReader()
    contexts = [reader.decode(reader.read(d)[0]) for d in datas]
    (mst or MultiStreamTranscoder(params, device)).transcode_many(contexts)
    outs = [write_context(c) for c in contexts]
    if device.type == "cuda":
        torch.cuda.synchronize()
    return outs


def batched_kernel_phase(streams: list[bytes], dev, card) -> dict:
    """8. The stream-axis launch over the luma of the streams (input QPs
    STREAM_QPS) against one launch per stream and the plain version."""
    c = torch.stack([stream_coeffs(d, dev)[("GEOMETRY", 0)]
                     for d in streams])
    check(tuple(c.shape) == (len(STREAM_QPS), FRAMES, HEIGHT // 16,
                             WIDTH // 16, 16, 16), f"stack {c.shape}")
    qs_in = torch.tensor([qstep(q) for q in STREAM_QPS], device=dev)
    qs_out = torch.full((len(streams),), qstep(GEO_QP), device=dev)
    args = (c, qs_in, qs_out, 1023.0, 2, 2)
    got = tc.transcode_coeffs_batched(*args)

    def singles():
        return [tc.transcode_coeffs(c[i], qstep(q), qstep(GEO_QP), 1023.0,
                                    2, 2)
                for i, q in enumerate(STREAM_QPS)]

    equal = all(torch.equal(got[i], one) for i, one in enumerate(singles()))
    want = tc.transcode_coeffs_batched_ref(*args)
    share, diff = compare(got, want)
    b_ms, b_dev = kernel_times(lambda: tc.transcode_coeffs_batched(*args))
    s_ms = median_ms(singles)
    p_ms = median_ms(lambda: tc.transcode_coeffs_batched_ref(*args), n=5)
    bound, by = tc.transcode_bound_ms(tuple(c.shape), 2)
    dense, _ = tc.transcode_bound_ms(tuple(c.shape), 2, dense=True)
    phase("batched_kernel", shape=tuple(c.shape), input_qps=STREAM_QPS,
          equal_to_single_launches=equal, share=share, max_abs_diff=diff,
          kernel_ms=f"{b_ms:.4f}", device_ms=f"{b_dev:.4f}",
          single_launches_ms=f"{s_ms:.4f}", plain_ms=f"{p_ms:.4f}",
          bound_ms=f"{bound:.4f}", bound_by=by,
          bound_share=f"{bound / b_ms:.4f}",
          device_bound_share=f"{bound / b_dev:.4f}",
          dense_bound_ms=f"{dense:.4f}", card=repr(card))
    check(equal, "batched launch differs from single-stream launches")
    check(share == 0 and diff == 0,
          f"batched kernel vs plain: share {share}, |diff| {diff}")
    return {"max_abs_err": diff, "ms": b_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bound_share": bound / b_ms, "device_ms": b_dev,
            "dense_bound_ms": dense}


def multistream_phase(streams: list[bytes], dev, params,
                      card) -> tuple[int, int]:
    """9. S = 1, 2, 4 streams batched against the sequential loop ->
    (batched kernel launches of the S = 4 runs, per run)."""
    launches = per_run = 0
    for s in (1, 2, 4):
        datas = streams[:s]
        mst = MultiStreamTranscoder(params, dev)
        tc.LAUNCHES = tc.BATCHED_LAUNCHES = 0
        outs, walls = timed_runs(
            lambda: transcode_many_bytes(datas, dev, params, mst))
        runs = len(walls) + 1
        check(tc.LAUNCHES == tc.BATCHED_LAUNCHES == 4 * runs,
              f"S={s}: {tc.LAUNCHES} launches ({tc.BATCHED_LAUNCHES} "
              f"batched) in {runs} runs, want 4 batched per run")
        launches, per_run = tc.BATCHED_LAUNCHES, tc.BATCHED_LAUNCHES // runs
        seq, seq_walls = timed_runs(
            lambda: [transcode_bytes(d, dev, params) for d in datas])
        wall, seq_wall = statistics.median(walls), statistics.median(
            seq_walls)
        phase("multistream", streams=s, runs=len(walls),
              wall_s=repr(walls), median_s=f"{wall:.4f}",
              frames_per_s=f"{FRAMES * s / wall:.3f}",
              sequential_wall_s=repr(seq_walls),
              sequential_median_s=f"{seq_wall:.4f}",
              sequential_frames_per_s=f"{FRAMES * s / seq_wall:.3f}",
              launches_per_run=tc.BATCHED_LAUNCHES // runs,
              bytes_equal=outs == seq, card=repr(card))
        check(outs == seq, f"S={s}: batched output differs from the "
                           f"sequential port")
    return launches, per_run


def multistream_mc_intra_phase(data_mi: bytes, dev, params, card) -> None:
    """10. The MC + intra stream and a requantised copy, batched through
    the plain chains, against the sequential port."""
    datas = [data_mi, with_input_qps(data_mi, 18, 24, dev)]
    tc.LAUNCHES = 0
    outs, walls = timed_runs(lambda: transcode_many_bytes(datas, dev, params),
                             n=1)
    seq, seq_walls = timed_runs(
        lambda: [transcode_bytes(d, dev, params) for d in datas], n=1)
    phase("multistream_mc_intra", streams=2, wall_s=repr(walls),
          sequential_wall_s=repr(seq_walls), launches=tc.LAUNCHES,
          bytes_equal=outs == seq, card=repr(card))
    check(outs == seq, "MC + intra: batched output differs from sequential")
    check(tc.LAUNCHES == 0, f"MC + intra: {tc.LAUNCHES} kernel launches")


def full_and_small_phase(name: str, full: bytes, small: bytes, dev,
                         params, small_params, card, **fields) -> None:
    """11. ``full`` timed on the card; ``small`` on the card held against
    the CPU."""
    out, walls = timed_runs(lambda: transcode_bytes(full, dev, params))
    wall = statistics.median(walls)
    phase(name, runs=len(walls), wall_s=repr(walls), median_s=f"{wall:.4f}",
          frames_per_s=f"{FRAMES / wall:.3f}", in_bytes=len(full),
          out_bytes=len(out), card=repr(card), **fields)
    check_decodes(out, dev)
    got = transcode_bytes(small, dev, small_params)
    t0 = time.perf_counter()
    want = transcode_bytes(small, torch.device("cpu"), small_params)
    gpu_vs_cpu(f"{name}_vs_cpu", got, want, dev, size=SMALL,
               cpu_wall_s=f"{time.perf_counter() - t0:.3f}")


def abr_phase(data: bytes, target_mbps: float, dev, card) -> None:
    """11. ABR on the bench stream: the full QP search per run (a fresh
    Transcoder), timed; at the reduced size the chosen QPs and the output
    equal the CPU's."""
    params = TranscoderParameters(rate_mode="abr",
                                  targetBitrateMbps=target_mbps)
    transcoders = []

    def run_abr() -> bytes:
        transcoders.append(Transcoder(params, dev))
        return transcode_bytes(data, dev, params, transcoders[-1])

    out, walls = timed_runs(run_abr)
    wall = statistics.median(walls)
    phase("abr", runs=len(walls), wall_s=repr(walls), median_s=f"{wall:.4f}",
          frames_per_s=f"{FRAMES / wall:.3f}",
          target_mbps=f"{target_mbps:.4f}", out_bytes=len(out),
          qps=repr(transcoders[-1]._rc_cache), card=repr(card))
    small = make_stream(*SMALL)
    small_params = TranscoderParameters(
        rate_mode="abr", targetBitrateMbps=target_mbps * SMALL[1] * SMALL[2]
        / (WIDTH * HEIGHT))
    gpu, cpu = (Transcoder(small_params, dev),
                Transcoder(small_params, torch.device("cpu")))
    got = transcode_bytes(small, dev, small_params, gpu)
    want = transcode_bytes(small, torch.device("cpu"), small_params, cpu)
    gpu_vs_cpu("abr_vs_cpu", got, want, dev, size=SMALL,
               qps=repr(gpu._rc_cache))
    check(gpu._rc_cache == cpu._rc_cache,
          f"ABR QPs: GPU {gpu._rc_cache} CPU {cpu._rc_cache}")


def stream_app_phase(streams: list[bytes], dev, card) -> None:
    """12. The stream app's batched mode against its per-stream mode: 2
    streams x 2 GOFs, in a directory of the checkout's build tree."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    reader, writer = V3CReader(), V3CWriter()
    inputs = []
    for i, gofs in enumerate((streams[:2], streams[2:4])):
        units = []
        for d in gofs:
            units.extend(writer.encode(reader.decode(reader.read(d)[0])))
        inputs.append(str(work / f"in{i}.bin"))
        writer.write_file(units, inputs[-1])
    params = stream_app.StreamParams(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                     mode="reencode")
    plain = [str(work / f"plain{i}.bin") for i in range(2)]
    batched = [str(work / f"batched{i}.bin") for i in range(2)]
    t0 = time.perf_counter()
    for path, out in zip(inputs, plain):
        stream_app.transcode_stream(path, out, params, dev)
    plain_s = time.perf_counter() - t0
    tc.BATCHED_LAUNCHES = 0
    t0 = time.perf_counter()
    results = stream_app.transcode_streams_sharded(inputs, batched, params,
                                                   dev)
    batched_s = time.perf_counter() - t0
    equal = all(Path(a).read_bytes() == Path(b).read_bytes()
                for a, b in zip(plain, batched))
    failures = [r["failures"] for r in results]
    batched_failures = [r["batched_failures"] for r in results]
    phase("stream_app", streams=2, gofs=2, bytes_equal=equal,
          failures=failures, batched_failures=batched_failures,
          batched_launches=tc.BATCHED_LAUNCHES,
          per_stream_wall_s=f"{plain_s:.3f}",
          batched_wall_s=f"{batched_s:.3f}", card=repr(card))
    check(equal, "stream app: batched output differs from per-stream")
    check(failures == [0, 0] and batched_failures == [0, 0],
          f"stream app failures {failures}, batched {batched_failures}")
    check(tc.BATCHED_LAUNCHES == 8,
          f"stream app: {tc.BATCHED_LAUNCHES} batched launches, want 8")


def decode_clouds(data: bytes, device) -> tuple[list, Decoder, float]:
    """The first GOF of ``data`` through ``Decoder(device=device)`` ->
    (clouds, the decoder, wall seconds), the device synchronised."""
    reader = V3CReader()
    t0 = time.perf_counter()
    decoder = Decoder(device=device)
    clouds = decoder.decode(reader.decode(reader.read(data)[0]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return clouds, decoder, time.perf_counter() - t0


def clouds_equal(a: list, b: list) -> bool:
    """Equal arrays, in order, frame by frame."""
    return len(a) == len(b) and all(
        np.array_equal(getattr(x, k), getattr(y, k))
        for x, y in zip(a, b)
        for k in ("positions", "colors", "types", "partition"))


def decode_vs_cpu(name: str, data: bytes, dev, got=None, **fields) -> float:
    """Hold the card's decode of ``data`` against the CPU's -> the CPU's
    wall seconds.  Positions, types and partition equal exactly; colours
    within MAX_COLOR_SHARE of the points, and only at smoothing-eligible
    (boundary) points."""
    if got is None:
        got, _, _ = decode_clouds(data, dev)
    want, _, cpu_s = decode_clouds(data, torch.device("cpu"))
    check(len(got) == len(want), f"{name}: {len(got)} vs {len(want)} frames")
    points = differing = 0
    outside = False
    for fi, (a, b) in enumerate(zip(got, want)):
        for k in ("positions", "types", "partition"):
            check(np.array_equal(getattr(a, k), getattr(b, k)),
                  f"{name}: frame {fi} {k} differ between GPU and CPU")
        diff = (a.colors != b.colors).any(axis=1)
        points += len(diff)
        differing += int(diff.sum())
        outside |= bool((diff & (b.types != 1)).any())
    share = differing / max(points, 1)
    phase(name, points=points, geometry_equal=True,
          color_differing_points=differing, color_share=share,
          outside_eligible_points=outside, cpu_wall_s=f"{cpu_s:.3f}",
          **fields)
    check(points > 0, f"{name}: no points decoded")
    check(share <= MAX_COLOR_SHARE and not outside,
          f"{name}: GPU vs CPU colours: share {share}, outside the "
          f"smoothing-eligible points: {outside}")
    return cpu_s


def decode_phase(data: bytes, data_mi: bytes, dev, card) -> list:
    """14. The decode of the patch-carrying GOF on the card -> its clouds."""
    runs = []
    for i in range(4):      # one warm-up, then 3 timed runs
        clouds, decoder, wall = decode_clouds(data, dev)
        if i:
            runs.append((wall, clouds, decoder))
    walls = [r[0] for r in runs]
    wall = statistics.median(walls)
    clouds, decoder = runs[-1][1], runs[-1][2]
    equal = clouds_equal(runs[-2][1], clouds)
    counts = [ps.point_count for ps in clouds]
    sums = [ps.compute_checksum().hex() for ps in clouds]
    phase("decode", runs=len(walls), wall_s=repr(walls),
          median_s=f"{wall:.4f}", frames_per_s=f"{FRAMES / wall:.3f}",
          points_per_frame=repr(counts), run_to_run_equal=equal,
          stages_ms=json.dumps({k: round(v, 3)
                                for k, v in decoder.timer.stages.items()}),
          checksums=repr(sums), card=repr(card))
    check(len(clouds) == FRAMES and min(counts) > 50_000,
          f"decode: {len(clouds)} frames, points per frame {counts}")
    check(all(ps.colors is not None and ps.colors.shape == ps.positions.shape
              and ps.positions.min() >= 0 and ps.positions.max() < 1024
              for ps in clouds), "decode: clouds malformed")
    check(equal, "decode: two runs on the card give different clouds")
    decode_clouds(data_mi, dev)       # warm-up
    clouds_mi, _, wall_mi = decode_clouds(data_mi, dev)
    phase("decode_mc_intra", wall_s=f"{wall_mi:.4f}",
          frames_per_s=f"{FRAMES / wall_mi:.3f}",
          points=sum(ps.point_count for ps in clouds_mi), card=repr(card))
    # against the CPU: at the reduced size, and at full size if that is quick
    kw = dict(patches=True, smoothing=True)
    cpu_s = decode_vs_cpu("decode_vs_cpu",
                          make_stream(*SMALL, **kw), dev, size=SMALL)
    decode_vs_cpu("decode_mc_intra_vs_cpu",
                  make_stream(*SMALL, motion=True, intra=True, **kw), dev,
                  size=SMALL)
    scale = FRAMES * WIDTH * HEIGHT / (SMALL[0] * SMALL[1] * SMALL[2])
    if cpu_s * scale < CPU_FULL_LIMIT_S:
        decode_vs_cpu("decode_vs_cpu_full", data, dev, got=clouds,
                      size=(FRAMES, WIDTH, HEIGHT))
    else:
        phase("decode_vs_cpu_full", skipped=True,
              predicted_cpu_s=f"{cpu_s * scale:.1f}",
              limit_s=CPU_FULL_LIMIT_S)
    return clouds


def decode_map_pair_phase(dev, card) -> None:
    """15. The dual-map stream: against the CPU at the reduced size, and
    once at full size for its time."""
    kw = dict(patches=True, smoothing=True, map_pair=True)
    decode_vs_cpu("decode_map_pair_vs_cpu", make_stream(*SMALL, **kw), dev,
                  size=SMALL)
    t0 = time.perf_counter()
    full = make_stream(FRAMES, WIDTH, HEIGHT, device=dev, **kw)
    build_s = time.perf_counter() - t0
    decode_clouds(full, dev)          # warm-up
    clouds, decoder, wall = decode_clouds(full, dev)
    counts = [ps.point_count for ps in clouds]
    phase("decode_map_pair", wall_s=f"{wall:.4f}",
          frames_per_s=f"{FRAMES / wall:.3f}", points=sum(counts),
          stages_ms=json.dumps({k: round(v, 3)
                                for k, v in decoder.timer.stages.items()}),
          build_s=f"{build_s:.3f}", card=repr(card))
    check(len(clouds) == FRAMES and min(counts) > 100_000,
          f"decode_map_pair: points per frame {counts}")


def _position_keys(ps) -> np.ndarray:
    p = ps.positions.astype(np.int64)
    return (p[:, 0] << 40) | (p[:, 1] << 20) | p[:, 2]


def transcode_then_decode_phase(patch_data: bytes, plain_data: bytes,
                                transcoded: bytes, source: list, dev,
                                card) -> None:
    """16. The transcoded videos of the main path under the patch stream's
    atlas (the two streams carry the same videos), decoded: what the
    transcode moved, until the port has its own D1/Y metrics."""
    reader = V3CReader()
    context = reader.decode(reader.read(patch_data)[0])
    atlas = context.atlas(0)
    plain = reader.decode(reader.read(plain_data)[0]).atlas(0)
    out = reader.decode(reader.read(transcoded)[0]).atlas(0)
    for vt, vb in plain.video_bitstreams.items():
        check(atlas.get_video_bitstream(vt).data == vb.data,
              f"{vt.name}: the patch stream's video is not the main path's")
        atlas.set_video_bitstream(
            VideoBitstream(vt, out.get_video_bitstream(vt).data))
    clouds, _, wall = decode_clouds(write_context(context), dev)
    points = moved = 0
    for a, b in zip(clouds, source):
        new = ~np.isin(_position_keys(a), _position_keys(b))
        points += a.point_count
        moved += int(new.sum())
    check(len(clouds) == FRAMES and points > 0,
          "transcode_then_decode: nothing decoded")
    # the quality the transcode costs: the transcoded clouds against the
    # input stream's clouds (the GPU machine has no source cloud of this
    # content), normals of the input's clouds computed on the card
    t0 = time.perf_counter()
    per_frame, summary = compute_sequence_metrics(
        [source[i] for i in METRIC_FRAMES],
        [clouds[i] for i in METRIC_FRAMES], device=dev)
    metrics_s = time.perf_counter() - t0
    y, u, v = summary.color_psnr
    phase("transcode_then_decode", wall_s=f"{wall:.4f}", points=points,
          source_points=sum(ps.point_count for ps in source),
          points_at_new_positions=moved,
          share_at_new_positions=f"{moved / max(points, 1):.6f}",
          frames_measured=f"{len(per_frame)} of {FRAMES}",
          d1_psnr=f"{summary.d1_psnr:.4f}", d2_psnr=f"{summary.d2_psnr:.4f}",
          d1_hausdorff_psnr=f"{summary.d1_hausdorff_psnr:.4f}",
          y_psnr=f"{y:.4f}", u_psnr=f"{u:.4f}", v_psnr=f"{v:.4f}",
          d1_psnr_per_frame=[round(float(m.d1_psnr), 4) for m in per_frame],
          metrics_s=f"{metrics_s:.3f}",
          metrics_s_per_frame=f"{metrics_s / len(per_frame):.3f}",
          card=repr(card))
    check(all(np.isfinite(x) and 10.0 < x < 100.0
              for x in (summary.d1_psnr, summary.d2_psnr, y, u, v)),
          f"transcode_then_decode: metrics {summary}")


def _run_app(main, argv, work: Path) -> tuple[int, list[str]]:
    text = io.StringIO()
    old = os.getcwd()
    os.chdir(work)      # the apps write their timings files where they run
    try:
        with contextlib.redirect_stdout(text):
            rc = main(argv)
    finally:
        os.chdir(old)
    return rc, text.getvalue().splitlines()


def decode_app_phase(data: bytes, clouds: list, dev, card) -> None:
    """17. The decode app on the stream file: PLYs written, checksums
    equal to the library call's."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "decode"
    work.mkdir(parents=True, exist_ok=True)
    (work / "in.bin").write_bytes(data)
    t0 = time.perf_counter()
    rc, lines = _run_app(decode_app.main, [
        "--compressedStreamPath=in.bin",
        "--reconstructedDataPath=rec_%04d.ply", f"--device={dev.type}"], work)
    wall = time.perf_counter() - t0
    sums = [ln.split(": ")[1] for ln in lines
            if ln.startswith("checksum frame")]
    want = [ps.compute_checksum().hex() for ps in clouds]
    plys = sorted(work.glob("rec_*.ply"))
    phase("decode_app", rc=rc, wall_s=f"{wall:.3f}", plys=len(plys),
          ply_bytes=sum(p.stat().st_size for p in plys),
          checksums_equal=sums == want,
          checksums_md5=hashlib.md5("".join(sums).encode()).hexdigest(),
          card=repr(card))
    check(rc == 0 and len(plys) == FRAMES, f"decode app: rc {rc}, "
                                           f"{len(plys)} PLYs")
    check(sums == want, "decode app: checksums differ from the library's")
    for p in plys:
        p.unlink()


def _timed(fn, dev=None):
    t0 = time.perf_counter()
    out = fn()
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def normals_phase(dev, card) -> None:
    """18. The normals of a dense cloud of a real frame's size, on the card
    and on the CPU."""
    cpu = torch.device("cpu")
    cloud, make_s = _timed(
        lambda: testdata.make_dense_frame(0, n=NORMALS_POINTS))
    pts = cloud.positions.astype(np.float32)
    # the parts, one by one: host KNN, covariance + eigh on the card, tree
    idx, knn_s = _timed(lambda: nm.knn_indices(pts, 16))
    tp = torch.from_numpy(pts)
    ti = torch.from_numpy(idx).long()
    tp_g, ti_g = tp.to(dev), ti.to(dev)
    _timed(lambda: nm._pca_normals(tp_g[:1000], ti_g[:1000].clamp(max=999)),
           dev)                                                 # warm-up

    def cov(p, i):
        nbrs = p[i]
        return nm._cov(nbrs - (nm._sum_k(nbrs) / nbrs.shape[1])[:, None, :])

    cov_g, cov_s = _timed(lambda: cov(tp_g, ti_g), dev)
    _, eigh_s = _timed(lambda: nm._eigh(cov_g), dev)
    pca_g, pca_s = _timed(lambda: nm._pca_normals(tp_g, ti_g), dev)
    try:        # why ``nm._eigh`` calls cuSOLVER 16,384 matrices at a time
        torch.linalg.eigh(cov_g[:32767])
        one_call = "accepted"
    except RuntimeError as err:     # only cuSOLVER's refusal of the batch
        if "CUSOLVER_STATUS_INVALID_VALUE" not in str(err):
            raise
        one_call = "refused"
    cov_c, cov_cpu_s = _timed(lambda: cov(tp, ti))
    _, eigh_cpu_s = _timed(lambda: nm._eigh(cov_c))
    cov_equal = bool(torch.equal(cov_g.cpu(), cov_c))
    pca_host = pca_g.cpu().numpy()
    tree, tree_s = _timed(lambda: nm.orient_spanning_tree(pca_host, pts, idx))
    # the entry points, whole
    (got, _), card_s = _timed(lambda: nm.compute_normals(pts, device=dev))
    (want, _), cpu_s = _timed(lambda: nm.compute_normals(pts, device=cpu))
    m = testdata.normals_mismatch(got, want)
    # the entry point took the tree, not the sweeps it falls back to
    tree = tree / np.maximum(np.linalg.norm(tree, axis=1, keepdims=True),
                             1e-12)
    took_tree = bool(np.array_equal(got, tree.astype(np.float32)))
    gen_g, gen_s = _timed(lambda: nm.generate_normals(pts, device=dev))
    gen_c, gen_cpu_s = _timed(lambda: nm.generate_normals(pts, device=cpu))
    mg = testdata.normals_mismatch(gen_g["normals"], gen_c["normals"])
    phase("normals", points=len(pts), make_s=f"{make_s:.3f}",
          host_knn_s=f"{knn_s:.3f}", device_cov_s=f"{cov_s:.4f}",
          device_eigh_s=f"{eigh_s:.4f}", device_pca_s=f"{pca_s:.4f}",
          eigh_of_32767_in_one_call=one_call,
          cpu_cov_s=f"{cov_cpu_s:.3f}", cpu_eigh_s=f"{eigh_cpu_s:.3f}",
          host_tree_s=f"{tree_s:.3f}", covariances_equal=cov_equal,
          compute_normals_took_tree=took_tree,
          compute_normals_card_s=f"{card_s:.3f}",
          compute_normals_cpu_s=f"{cpu_s:.3f}",
          generate_normals_card_s=f"{gen_s:.3f}",
          generate_normals_cpu_s=f"{gen_cpu_s:.3f}",
          card_vs_cpu=json.dumps(m), generate_card_vs_cpu=json.dumps(mg),
          card=repr(card))
    check(len(pts) > 250_000, f"normals: only {len(pts)} points")
    check(cov_equal, "normals: covariances differ between card and CPU")
    check(took_tree, "normals: compute_normals is not the spanning tree's "
                     "orientation of its PCA normals")
    check(got.shape == pts.shape and np.isfinite(got).all()
          and np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4),
          "normals: not finite unit vectors")
    for name, mm in (("compute_normals", m), ("generate_normals", mg)):
        check(mm["share_beyond_1e-3"] <= MAX_NORMAL_SHARE,
              f"{name}: card vs CPU normals {mm}")


def encoder_stream_phase(dev, card) -> dict:
    """19. The committed encoder streams on the card -> per stream its
    source clouds, its record, its decode and its transcode's decode."""
    cpu = torch.device("cpu")
    params = TranscoderParameters(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                  mode="reencode")
    streams = {}
    for name in testdata.ENCODER_STREAMS:
        data, sources, record = testdata.load_encoder_stream(name)
        clouds, _, wall = decode_clouds(data, dev)
        clouds_cpu, _, cpu_s = decode_clouds(data, cpu)
        sums = [ps.compute_checksum().hex() for ps in clouds]
        tc.LAUNCHES = 0
        out, t_s = _timed(lambda: transcode_bytes(data, dev, params))
        launches = tc.LAUNCHES
        out_cpu = transcode_bytes(data, cpu, params)
        out_clouds, _, _ = decode_clouds(out, dev)
        phase("encoder_stream", stream=name, bytes=len(data),
              frames=len(clouds),
              points=[ps.point_count for ps in clouds],
              checksums_equal_reference=sums == record["checksums"],
              equal_to_cpu=clouds_equal(clouds, clouds_cpu),
              decode_s=f"{wall:.3f}", cpu_decode_s=f"{cpu_s:.3f}",
              transcode_s=f"{t_s:.3f}", transcoded_bytes=len(out),
              transcode_bytes_equal_cpu=out == out_cpu,
              kernel_launches=launches, card=repr(card))
        check(sums == record["checksums"],
              f"{name}: the card's decode does not have the reference "
              f"decoder's checksums")
        check(clouds_equal(clouds, clouds_cpu),
              f"{name}: card and CPU decodes differ")
        check(out == out_cpu and out != data,
              f"{name}: card and CPU transcodes differ")
        check(len(out_clouds) == len(clouds), f"{name}: transcode lost frames")
        streams[name] = (sources, record, clouds, out_clouds)
    return streams


def _exact_fields_equal(got, want) -> list[str]:
    """The names of the fields that pass through no normal and differ."""
    import dataclasses

    return [f.name for f in dataclasses.fields(got)
            if f.name not in D2_FIELDS
            and getattr(got, f.name) != getattr(want, f.name)]


def metrics_phase(streams: dict, dev, card) -> None:
    """20. The metrics of the encoder streams' decodes, normals on the
    card, against the committed reference values."""
    for name, (sources, record, clouds, out_clouds) in streams.items():
        (per_frame, summary), wall = _timed(
            lambda: compute_sequence_metrics(sources, clouds, device=dev))
        want = record["metrics_summary"]
        differing = _exact_fields_equal(summary, want)
        for got_f, want_f in zip(per_frame, record["metrics_per_frame"]):
            differing += _exact_fields_equal(got_f, want_f)
        d2 = {f: (abs(getattr(summary, f) - getattr(want, f))
                  if np.isfinite(getattr(want, f)) else
                  float(getattr(summary, f) != getattr(want, f)))
              for f in D2_FIELDS}
        d2_rel = {f: d2[f] / max(abs(getattr(want, f)), 1e-30)
                  for f in ("d2_mse", "d2_hausdorff")
                  if np.isfinite(getattr(want, f))}
        _, t_summary = compute_sequence_metrics(sources, out_clouds,
                                                device=dev)
        phase("metrics", stream=name, frames=len(per_frame),
              exact_fields_equal_reference=not differing,
              d1_psnr=f"{summary.d1_psnr:.4f}",
              d2_psnr=f"{summary.d2_psnr:.6f}",
              reference_d2_psnr=f"{want.d2_psnr:.6f}",
              d2_abs_deltas=json.dumps(d2),
              d2_rel_deltas=json.dumps(d2_rel),
              y_psnr=f"{summary.color_psnr[0]:.4f}",
              seconds=f"{wall:.3f}",
              s_per_frame=f"{wall / len(per_frame):.3f}",
              transcoded_d1_psnr=f"{t_summary.d1_psnr:.4f}",
              transcoded_d2_psnr=f"{t_summary.d2_psnr:.4f}",
              transcoded_y_psnr=f"{t_summary.color_psnr[0]:.4f}",
              card=repr(card))
        check(not differing, f"{name}: fields differ from the reference "
                             f"values: {differing}")
        check(d2["d2_psnr"] <= D2_BOUND_DB
              and d2["d2_hausdorff_psnr"] <= D2_BOUND_DB
              and all(v <= D2_BOUND_REL for v in d2_rel.values()),
              f"{name}: D2 against the reference values: {d2} {d2_rel}")


def metrics_app_phase(streams: dict, dev, card) -> None:
    """21. ``rabbit-decode --computeMetrics`` and ``rabbit-metrics`` on the
    first encoder stream: summary lines equal to the library call's."""
    name = testdata.ENCODER_STREAMS[0]
    sources, _, clouds, _ = streams[name]
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "metrics"
    work.mkdir(parents=True, exist_ok=True)
    GroupOfFrames(sources).write(str(work / "src_%04d.ply"), 0)
    stream = os.path.join(testdata.ENCODER_STREAM_DIR, name + ".bin")
    _, summary = compute_sequence_metrics(sources, clouds, device=dev)
    want = summary.print().splitlines()
    t0 = time.perf_counter()
    rc_d, out_d = _run_app(decode_app.main, [
        f"--compressedStreamPath={stream}", "--computeMetrics=1",
        "--uncompressedDataPath=src_%04d.ply",
        "--reconstructedDataPath=rec_%04d.ply", f"--device={dev.type}"],
        work)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_m, out_m = _run_app(metrics_app.main, [
        "--uncompressedDataPath=src_%04d.ply",
        "--reconstructedDataPath=rec_%04d.ply",
        f"--frameCount={len(sources)}", f"--device={dev.type}"], work)
    metrics_s = time.perf_counter() - t0
    got_d = [ln for ln in out_d if ln in want]
    got_m = out_m[-1 - len(want):-1]
    phase("metrics_app", stream=name, decode_rc=rc_d, metrics_rc=rc_m,
          decode_app_summary_equal=got_d == want,
          metrics_app_summary_equal=got_m == want,
          summary=repr(want), decode_app_s=f"{decode_s:.3f}",
          metrics_app_s=f"{metrics_s:.3f}", card=repr(card))
    check(rc_d == 0 and rc_m == 0, f"metrics apps: rc {rc_d}, {rc_m}")
    check(got_d == want, f"rabbit-decode --computeMetrics printed {out_d}")
    check(got_m == want, f"rabbit-metrics printed {out_m}")
    for p in work.glob("*.ply"):
        p.unlink()


def slice_phases(dev, card) -> None:
    """18.-21. The normals, the encoder streams, their metrics, the apps."""
    normals_phase(dev, card)
    streams = encoder_stream_phase(dev, card)
    metrics_phase(streams, dev, card)
    metrics_app_phase(streams, dev, card)


def native_sources_built() -> bool:
    """The native library answers for all three of its sources: the rANS
    coder, the grid KNN and the spanning-tree orientation."""
    if not native.available():
        return False
    try:
        pts = np.arange(30, dtype=np.int32).reshape(10, 3)
        idx, d2 = native.knn_grid(pts, pts, 4)
        normals = np.tile(np.float32([[0.0, 0.0, 1.0]]), (10, 1))
        comps = native.orient_normals_tree(
            normals, pts, idx, np.ones(idx.shape, np.uint8),
            np.zeros(3, np.float32))
        blob = native.compress_i16(np.arange(64, dtype=np.int16))
    except (RuntimeError, AttributeError):
        return False
    return bool(d2[0, 0] == 0 and comps >= 1 and blob)


def main() -> int:
    here = Path(__file__).resolve().parent
    pkg = Path(rabbit_transcoding_tpu_torch.__file__).resolve().parent
    if pkg.parent != here:
        raise SystemExit(f"chip_smoke.py must run from the root of a checkout "
                         f"(found the package at {pkg})")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    dev = torch.device("cuda")
    card = gpu_name_and_power()
    nvcc_version = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    phase("env", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=repr(nvcc_version),
          devices=torch.cuda.device_count(),
          native_rans=native.available(),
          native_knn_and_tree=native_sources_built())
    check(native.available(), "the native rANS library did not build")
    check(native_sources_built(),
          "the native library lacks the grid KNN or the tree orientation")

    # 2. build from the checkout's sources
    seconds = _build.build(force=True)
    ptxas = _build.ptxas_report(_build.BUILD_LOG)
    phase("build", seconds=f"{seconds:.3f}", kernels=len(ptxas),
          registers=[k["registers"] for k in ptxas.values()],
          spill_stores=[k["spill_stores"] for k in ptxas.values()],
          spill_loads=[k["spill_loads"] for k in ptxas.values()])
    check(ptxas and all(k["spill_stores"] == k["spill_loads"] == 0
                        for k in ptxas.values()),
          f"ptxas report {ptxas}: a kernel spills")

    # the main path's input, built on the card by the port's own encoder
    t0 = time.perf_counter()
    data = make_stream(FRAMES, WIDTH, HEIGHT, device=dev)
    phase("stream", frames=FRAMES, size=f"{WIDTH}x{HEIGHT}",
          bytes=len(data), seconds=f"{time.perf_counter() - t0:.3f}")

    # 3. kernel against the plain version on the card
    rng = np.random.default_rng(0)
    cases = []
    for gop in (1, 2, 4):
        c = rng.integers(-60, 60, size=(4, 3, 4, 16, 16)).astype(np.int16)
        cases.append((f"random_gop{gop}", torch.from_numpy(c).to(dev),
                      qstep(16), qstep(32), 1023.0, gop, gop))
    coeffs = stream_coeffs(data, dev)
    luma, chroma = coeffs[("GEOMETRY", 0)], coeffs[("ATTRIBUTE", 1)]
    check(tuple(luma.shape) == (32, 64, 64, 16, 16), f"luma {luma.shape}")
    check(tuple(chroma.shape) == (32, 32, 32, 16, 16),
          f"chroma {chroma.shape}")
    cases += [
        ("luma", luma, qstep(16), qstep(GEO_QP), 1023.0, 2, 2),
        ("chroma", chroma, qstep(22), qstep(ATTR_QP), 255.0, 2, 2),
        ("luma_gop2to1", luma, qstep(16), qstep(GEO_QP), 1023.0, 2, 1),
    ]
    max_abs_err = 0
    times = {}
    for name, c, qs_in, qs_out, maxval, gop_in, gop_out in cases:
        args = (c, qs_in, qs_out, maxval, gop_in, gop_out)
        got = tc.transcode_coeffs(*args)
        torch.cuda.synchronize()
        want = tc.transcode_coeffs_ref(*args)
        share, diff = compare(got, want)
        max_abs_err = max(max_abs_err, diff)
        k_ms, k_dev = kernel_times(lambda: tc.transcode_coeffs(*args))
        p_ms = median_ms(lambda: tc.transcode_coeffs_ref(*args))
        bound, by = tc.transcode_bound_ms(tuple(c.shape), gop_out)
        dense, _ = tc.transcode_bound_ms(tuple(c.shape), gop_out,
                                         dense=True)
        times[name] = (k_ms, k_dev, p_ms, bound, by, dense)
        phase("kernel", case=name, shape=tuple(c.shape), share=share,
              max_abs_diff=diff, kernel_ms=f"{k_ms:.4f}",
              device_ms=f"{k_dev:.4f}", plain_ms=f"{p_ms:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by,
              bound_share=f"{bound / k_ms:.4f}",
              device_bound_share=f"{bound / k_dev:.4f}",
              dense_bound_ms=f"{dense:.4f}", card=repr(card))
        check(share == 0 and diff == 0,
              f"{name}: kernel vs plain: share {share}, |diff| {diff}")

    # 4. the main path through the kernel
    params = TranscoderParameters(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                  mode="reencode")
    reader = V3CReader()
    units = reader.read(data)[0]

    def run(device, stream_units=units, mode_params=params) -> bytes:
        context = reader.decode(list(stream_units))
        Transcoder(mode_params, device).transcode(context)
        writer = V3CWriter()
        out = writer.write(writer.encode(context))
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    tc.LAUNCHES = 0
    walls = []
    runs = 4  # one warm-up, then 3 timed runs, one GOF each
    for i in range(runs):
        before = tc.LAUNCHES
        t0 = time.perf_counter()
        out = run(dev)
        wall = time.perf_counter() - t0
        check(tc.LAUNCHES - before == 4,
              f"run {i}: {tc.LAUNCHES - before} kernel launches, want 4")
        if i:
            walls.append(wall)
    launches = tc.LAUNCHES
    launches_per_gof = launches // runs
    main_out, main_out_bytes = out, len(out)
    wall = statistics.median(walls)
    phase("main_path", runs=len(walls), wall_s=repr(walls),
          median_s=f"{wall:.4f}", frames_per_s=f"{FRAMES / wall:.3f}",
          launches=launches, out_bytes=len(out), card=repr(card))

    check_decodes(out, dev)
    t0 = time.perf_counter()
    out_cpu = run(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    got, want = stream_coeffs(out, dev), stream_coeffs(out_cpu, dev)
    worst = (0.0, 0)
    for key in want:
        worst = max(worst, compare(got[key], want[key]))
    phase("vs_cpu", share=worst[0], max_abs_diff=worst[1],
          bytes_equal=out == out_cpu, cpu_wall_s=f"{cpu_s:.3f}")
    check(worst[0] <= MAX_SHARE and worst[1] <= MAX_DIFF,
          f"GPU vs CPU output coefficients: {worst}")

    # 5. the MC + intra stream, built on the card
    t0 = time.perf_counter()
    data_mi = make_stream(FRAMES, WIDTH, HEIGHT, device=dev, motion=True,
                          intra=True)
    phase("mc_intra_stream", frames=FRAMES, size=f"{WIDTH}x{HEIGHT}",
          bytes=len(data_mi), seconds=f"{time.perf_counter() - t0:.3f}")
    units_mi = reader.read(data_mi)[0]
    cpu = torch.device("cpu")
    requant = TranscoderParameters(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                   mode="requant")

    # 6. MC + intra reencode on the card: the plain chains, no kernel
    # 7. requant mode on the bench stream and on the MC + intra stream
    for name, stream_units, mode_params in (
            ("mc_intra_reencode", units_mi, params),
            ("bench_requant", units, requant),
            ("mc_intra_requant", units_mi, requant)):
        tc.LAUNCHES = 0
        out, walls = timed_runs(lambda: run(dev, stream_units, mode_params))
        runs_launches = tc.LAUNCHES
        wall = statistics.median(walls)
        phase(name, runs=len(walls), wall_s=repr(walls),
              median_s=f"{wall:.4f}", frames_per_s=f"{FRAMES / wall:.3f}",
              launches=runs_launches, out_bytes=len(out), card=repr(card))
        check(runs_launches == 0,
              f"{name}: {runs_launches} kernel launches, want 0")
        check_decodes(out, dev)
        t0 = time.perf_counter()
        out_cpu = run(cpu, stream_units, mode_params)
        gpu_vs_cpu(f"{name}_vs_cpu", out, out_cpu, dev,
                   cpu_wall_s=f"{time.perf_counter() - t0:.3f}")

    # 8.-10. the batched kernel and the multi-stream transcoder
    t0 = time.perf_counter()
    streams = [with_input_qps(data, q, q + 6, dev) for q in STREAM_QPS]
    phase("multistream_streams", input_qps=STREAM_QPS,
          bytes=[len(d) for d in streams],
          seconds=f"{time.perf_counter() - t0:.3f}")
    batched = batched_kernel_phase(streams, dev, card)
    batched["launches"], batched["launches_per_gof"] = multistream_phase(
        streams, dev, params, card)
    multistream_mc_intra_phase(data_mi, dev, params, card)

    # 11. lossless input with occupancy, a predicted map pair, ABR
    for name, kw in (("lossless_fill", {"lossless": True}),
                     ("map_pair", {"map_pair": True})):
        t0 = time.perf_counter()
        full = make_stream(FRAMES, WIDTH, HEIGHT, device=dev, **kw)
        build_s = time.perf_counter() - t0
        full_and_small_phase(name, full, make_stream(*SMALL, **kw), dev,
                             params, params, card,
                             build_s=f"{build_s:.3f}")
    abr_phase(data, main_out_bytes * 8 * 30.0 / FRAMES / 1e6, dev, card)

    # 12. the stream app's batched mode
    stream_app_phase(streams, dev, card)

    # 13. the decoder's streams, built on the card
    patch_streams = []
    for tools in ({}, {"motion": True, "intra": True}):
        t0 = time.perf_counter()
        patch_streams.append(make_stream(
            FRAMES, WIDTH, HEIGHT, device=dev, patches=True, smoothing=True,
            **tools))
        phase("decode_stream", frames=FRAMES, size=f"{WIDTH}x{HEIGHT}",
              tools=tools, bytes=len(patch_streams[-1]),
              seconds=f"{time.perf_counter() - t0:.3f}")
    # 14.-17. the decoder
    clouds = decode_phase(*patch_streams, dev, card)
    decode_map_pair_phase(dev, card)
    transcode_then_decode_phase(patch_streams[0], data, main_out, clouds,
                                dev, card)
    decode_app_phase(patch_streams[0], clouds, dev, card)
    # 18.-21. normals, the encoder's streams, the metrics, their apps
    slice_phases(dev, card)

    # no single PyTorch call computes the fused transcode (library_ms)
    k_ms, k_dev, p_ms, bound, by, dense = times["luma"]
    print(json.dumps({"kernels": [{
        "name": "transcode_gops", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "bound_share": bound / k_ms, "launches_per_gof": launches_per_gof,
        "device_ms": k_dev, "dense_bound_ms": dense,
    }, {
        "name": "transcode_gops_batched", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES, **batched,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
