#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: the live RBV transcode.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one result line each; any failure raises and the exit code is not 0:

1. environment: the card's name and power limit, torch and nvcc versions,
   and the port's native rANS library (built with g++; without it the
   entropy coder would fall back to zlib and change what is measured);
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
    ``transcode_stream`` on each, with no batched-round failure.

The kernel table as JSON and the card's name and power limit come before
the last line, ``{"ok": true, "device": {...}}``.  Imports only the port,
which imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import rabbit_transcoding_tpu_torch
from rabbit_transcoding_tpu_torch import native
from rabbit_transcoding_tpu_torch.ops import _build
from rabbit_transcoding_tpu_torch.ops import transcode as tc
from rabbit_transcoding_tpu_torch.apps import stream as stream_app
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
          native_rans=native.available())
    check(native.available(), "the native rANS library did not build")

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
    main_out_bytes = len(out)
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
