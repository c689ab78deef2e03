#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: the live RBV transcode.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one result line each; any failure raises and the exit code is not 0:

1. environment: the card's name and power limit, torch and nvcc versions;
2. build: nvcc compiles the port's CUDA sources (``csrc/*.cu``);
3. kernel check: the fused transcode kernel against its plain PyTorch version
   on the card, at the test shapes and at the main path's shapes (geometry
   luma (32, 64, 64, 16, 16), chroma (32, 32, 32, 16, 16)), with both times;
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
   ``device=cpu`` runs in the same way.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports only the port, which imports
nothing of JAX.
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
from rabbit_transcoding_tpu_torch.ops import _build
from rabbit_transcoding_tpu_torch.ops import transcode as tc
from rabbit_transcoding_tpu_torch.testdata import make_stream
from rabbit_transcoding_tpu_torch.transcoder import (
    ColorFormat, Transcoder, TranscoderParameters, V3CReader, V3CWriter,
    VideoType,
)
from rabbit_transcoding_tpu_torch.video import rbv

# share of differing coefficients and largest |difference| the kernel may
# show against the plain version (a float rounding-order flip at a .5
# boundary moves a coefficient by 1)
MAX_SHARE = 1e-4
MAX_DIFF = 1
# the same bounds for the GPU-against-CPU check of the MC + intra and
# requant paths (coefficients and intra mode-map entries); their motion
# vectors pass through or come from the stream and must be equal
FRAMES, WIDTH, HEIGHT = 32, 1024, 1024
GEO_QP, ATTR_QP = 32, 42
KERNEL_SOURCE = "rabbit_transcoding_tpu_torch/csrc/transcode_gops.cu"
REPLACES = "rabbit_transcoding_tpu/ops/pallas_transcode.py:86"


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


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_planes(data: bytes, device) -> dict:
    """{(video type, plane): the plane's sections} of the lossy RBV planes:
    int16 coefficients, intra mode maps and motion vectors (None when the
    stream has none)."""
    reader = V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    out = {}
    for vt in (VideoType.GEOMETRY, VideoType.ATTRIBUTE):
        payload = atlas.get_video_bitstream(vt).data
        flags, w, h, _, chroma, f, b, gop, _ = rbv._parse_header(payload)
        dims = rbv._plane_dims(w, h, ColorFormat(chroma))
        for k, ((ph, pw), blob) in enumerate(
                zip(dims, rbv._iter_blobs(payload, len(dims)))):
            out[(vt.name, k)] = rbv._Plane(blob, flags, f, ph, pw, b, gop,
                                           device)
    return out


def stream_coeffs(data: bytes, device) -> dict:
    """{(video type, plane): int16 coefficients} of the lossy RBV planes."""
    return {k: p.q for k, p in stream_planes(data, device).items()}


def gpu_vs_cpu(name: str, got: bytes, want: bytes, dev, **fields) -> None:
    """Hold the card's output stream against the CPU's: equal bytes, or
    else every coefficient and mode-map entry within MAX_SHARE / MAX_DIFF
    and equal motion vectors."""
    a, b = stream_planes(got, dev), stream_planes(want, dev)
    worst_q, worst_mode, mv_equal = (0.0, 0), (0.0, 0), True
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
    for vt in (VideoType.OCCUPANCY, VideoType.GEOMETRY, VideoType.ATTRIBUTE):
        video = rbv.decode(atlas.get_video_bitstream(vt).data, dev)
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
          devices=torch.cuda.device_count())

    # 2. build from the checkout's sources
    seconds = _build.build(force=True)
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", seconds=f"{seconds:.3f}", ptxas=repr("; ".join(ptxas)))

    # the main path's input, built on the card by the port's own encoder
    t0 = time.perf_counter()
    data = make_stream(FRAMES, WIDTH, HEIGHT, device=dev)
    phase("stream", frames=FRAMES, size=f"{WIDTH}x{HEIGHT}",
          bytes=len(data), seconds=f"{time.perf_counter() - t0:.3f}")

    # 3. kernel against the plain version on the card
    qs = lambda qp: float(np.float32(rbv.qstep_of(qp)))  # noqa: E731
    rng = np.random.default_rng(0)
    cases = []
    for gop in (1, 2, 4):
        c = rng.integers(-60, 60, size=(4, 3, 4, 16, 16)).astype(np.int16)
        cases.append((f"random_gop{gop}", torch.from_numpy(c).to(dev),
                      qs(16), qs(32), 1023.0, gop, gop))
    coeffs = stream_coeffs(data, dev)
    luma, chroma = coeffs[("GEOMETRY", 0)], coeffs[("ATTRIBUTE", 1)]
    check(tuple(luma.shape) == (32, 64, 64, 16, 16), f"luma {luma.shape}")
    check(tuple(chroma.shape) == (32, 32, 32, 16, 16),
          f"chroma {chroma.shape}")
    cases += [
        ("luma", luma, qs(16), qs(GEO_QP), 1023.0, 2, 2),
        ("chroma", chroma, qs(22), qs(ATTR_QP), 255.0, 2, 2),
        ("luma_gop2to1", luma, qs(16), qs(GEO_QP), 1023.0, 2, 1),
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
        k_ms = median_ms(lambda: tc.transcode_coeffs(*args))
        p_ms = median_ms(lambda: tc.transcode_coeffs_ref(*args))
        times[name] = (k_ms, p_ms)
        phase("kernel", case=name, shape=tuple(c.shape), share=share,
              max_abs_diff=diff, kernel_ms=f"{k_ms:.4f}",
              plain_ms=f"{p_ms:.4f}", card=repr(card))
        check(share <= MAX_SHARE and diff <= MAX_DIFF,
              f"{name}: share {share} > {MAX_SHARE} or |diff| {diff} > "
              f"{MAX_DIFF}")

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
    for i in range(4):  # one warm-up, then 3 timed runs
        before = tc.LAUNCHES
        t0 = time.perf_counter()
        out = run(dev)
        wall = time.perf_counter() - t0
        check(tc.LAUNCHES - before == 4,
              f"run {i}: {tc.LAUNCHES - before} kernel launches, want 4")
        if i:
            walls.append(wall)
    launches = tc.LAUNCHES
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

    k_ms, p_ms = times["luma"]
    print(json.dumps({"kernels": [{
        "name": "transcode_gops", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
