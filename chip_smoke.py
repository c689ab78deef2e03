#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: the live RBV transcode,
the V-PCC decode, the normals and quality metrics on streams that the
V-PCC encoder wrote, the port's V-PCC encoder, the foreign-codec route
(HEVC sub-streams) and the device mesh.

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
    seconds of each, of the host KNN, the device's covariance, the host's
    ``eigh`` (the host decomposes on every device, so that the card's
    normals are the CPU's) and spanning tree; covariances and oriented
    normals equal bit for bit between card and CPU;
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
    to the library call's;
22. ``encode_fixtures``: the port's encoder on the card, given each
    committed encoder stream's source clouds and parameters: bytes equal
    the same encode with ``device=cpu`` and the committed stream, and the
    port's decoder on the card gives the committed checksums;
23. ``encode_full``: two frames of ``make_dense_frame`` at an 8i frame's
    scale (``ENCODE_POINTS``: ~820,000 points a frame after the duplicates
    go, 10-bit geometry) with the encoder's defaults (a 1024-wide atlas,
    lossy RBV with MC + intra), encoded twice on the card: seconds per
    frame of both runs, the second run's stages and the card's busy share
    (a CUDA-only trace), bytes equal run to run; the stream decoded on the
    card, D1/D2/Y of its first frame against the source;
24. ``encode_then_transcode``: that stream through ``Transcoder`` in
    ``reencode`` mode at geometry QP 32 / attribute QP 42 on the card,
    frames/s, bytes equal to a ``device=cpu`` transcode;
25. ``encode_app``: ``apps/encode.py --device=cuda`` on the first committed
    stream's sources written as PLYs: bytes equal to the library's;
26. ``foreign_stream``: phase 13's patch stream at full width, 2 frames of
    the 32-frame GOF (the HEVC subsets code on the host), built on the card
    and re-coded as HEVC by the in-tree subsets: occupancy as IPCM, geometry
    and attribute as the all-intra subset at QP 16 / 22;
27. ``foreign_transcode``: that stream through ``Transcoder(device=cuda)``
    with no external binary (the route resolves the in-tree subsets), to
    geometry QP 32 / attribute QP 42 and twice the occupancy precision:
    seconds per frame, stages, bytes per sub-stream, each output decoding,
    PSNR against the input planes, the occupancy equal to a CPU max-pool;
    held byte for byte against ``device=cpu`` at 256x256;
28. ``foreign_decode``: the same atlas with stand-in HEVC sub-streams
    (``mock_hevc`` behind HM's command line), decoded by
    ``Decoder(device=cuda)`` through the stand-in decoder: frames/s, points
    per frame, equal run to run and to ``device=cpu`` (256x256; full size
    when the small run predicts under 30 s);
29. ``foreign_encode``: the first committed stream's sources encoded with
    HM_APP for every component through the stand-in, on the card and the
    CPU (equal bytes); the stream decoded on the card (the closed loop's
    checksums) and transcoded through the stand-in (card = CPU);
30. ``foreign_apps``: ``apps/parser.py`` on phase 26's stream prints its
    HEVC probe lines; ``apps/transcode.py --device=cuda`` on it, run in a
    process of its own beside phase 27, writes phase 27's bytes;
31.-35. the device mesh, each phase on (a) card 0 alone, (b) a virtual
    (4, 2) mesh that lists card 0 eight times, and (c) every visible card
    when there are two or more (else a line says why (c) did not run):
31. ``mesh_transcode``: ``MESH_STREAMS`` bench streams (phase 8's four,
    repeated; input QPs 16-22) and the MC + intra stream through
    ``MultiStreamTranscoder(mesh=...)``, so that the kernel's branch and
    the plain chains both run and the kernel's group of 9 splits unevenly:
    bytes equal to the sequential ``Transcoder`` on every mesh; in a
    recorded round every ``transcode_coeffs_batched`` launch held against
    its plain version and counted per device; aggregate frames/s, one
    warm-up and 3 timed rounds;
32. ``mesh_step``: the sharded all-intra step (``parallel/mesh.py``) on
    phase 8's four luma stacks: q2 and recon equal (a)'s, one kernel launch
    per shard, the MSE;
33. ``mesh_decode``: phase 13's patch stream through
    ``Decoder(DecoderParameters(shardingMesh=mesh))``: clouds equal (a)'s
    and phase 14's, arrays in order; decode frames/s;
34. ``mesh_metrics``: ``d1_psnr_sharded`` of frame 0 of the first
    committed encoder stream against its source cloud: equal to (a)'s and
    within ``MESH_D1_BOUND_DB`` of ``compute_metrics``' D1;
35. ``mesh_stream_app``: the stream app's batched mode over each mesh:
    bytes equal to phase 12's per-stream outputs, no batched-round failure.

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
from rabbit_transcoding_tpu_torch.apps import encode as encode_app
from rabbit_transcoding_tpu_torch.apps import metrics as metrics_app
from rabbit_transcoding_tpu_torch.apps import parser as parser_app
from rabbit_transcoding_tpu_torch.apps import stream as stream_app
from rabbit_transcoding_tpu_torch.apps import transcode as transcode_app
from rabbit_transcoding_tpu_torch.bitstream.video_bitstream import (
    VideoBitstream,
)
from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames
from rabbit_transcoding_tpu_torch.decoder.decoder import (
    Decoder, DecoderParameters,
)
from rabbit_transcoding_tpu_torch.encoder import normals as nm
from rabbit_transcoding_tpu_torch.encoder.encoder import Encoder
from rabbit_transcoding_tpu_torch.encoder.params import EncoderParameters
from rabbit_transcoding_tpu_torch.metrics.metrics import (
    MetricsParams, compute_sequence_metrics, d1_psnr_sharded,
)
from rabbit_transcoding_tpu_torch.ops.events import median_ms
from rabbit_transcoding_tpu_torch.parallel import multistream as ms_mod
from rabbit_transcoding_tpu_torch.parallel.mesh import (
    make_mesh, make_sharded_transcode_step,
)
from rabbit_transcoding_tpu_torch.testdata import (
    make_stream, stream_coeffs, stream_planes, with_input_qps,
)
from rabbit_transcoding_tpu_torch.transcoder import (
    MultiStreamTranscoder, Transcoder, TranscoderParameters, V3CReader,
    V3CWriter, VideoType,
)
from rabbit_transcoding_tpu_torch.video import hevc_intra, hevc_ipcm, rbv

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
# oriented unit normals, card against CPU: the share of normals further than
# 1e-3 rad apart may be at most this (both take the host's eigh
# and are equal; a flipped component of the spanning tree would show here)
MAX_NORMAL_SHARE = 1e-4
# D2 PSNRs with the normals computed on the card against the committed
# reference values (normals by the reference's eigh on the CPU), in dB
# (measured: at most 3.9e-7 dB)
D2_BOUND_DB = 1e-5
# the same of ``d2_mse`` and ``d2_hausdorff``, relative to the reference value
D2_BOUND_REL = 1e-6
D2_FIELDS = ("d2_mse", "d2_psnr", "d2_hausdorff", "d2_hausdorff_psnr")
# points asked of ``make_dense_frame`` per frame of the full-size encode:
# 819,974 in frame 0 after the duplicates go, the scale of an 8i VFB v2
# frame (longdress_vox10.cfg: ~800,000 points, 10-bit geometry)
ENCODE_POINTS = 1_400_000
ENCODE_FRAMES = 2
ENCODE_POINT_RANGE = (750_000, 850_000)


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
    """9. S = 1, 2, 4 streams batched on card 0 against the sequential loop
    -> (batched kernel launches of the S = 4 runs, per run)."""
    launches = per_run = 0
    for s in (1, 2, 4):
        datas = streams[:s]
        mst = MultiStreamTranscoder(
            params, mesh=make_mesh([torch.device("cuda", 0)]))
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


def stream_app_phase(streams: list[bytes], dev, card) -> tuple:
    """12. The stream app's batched mode against its per-stream mode: 2
    streams x 2 GOFs, in a directory of the checkout's build tree, on the
    mesh the app makes of ``dev`` -> (inputs, per-stream outputs, params,
    the directory)."""
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
    want = 2 * 4 * kernel_shards(MultiStreamTranscoder(device=dev).mesh, 2)
    check(tc.BATCHED_LAUNCHES == want,
          f"stream app: {tc.BATCHED_LAUNCHES} batched launches, want {want}")
    return inputs, plain, params, work


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
    # the parts, one by one: host KNN, covariance on the card, host eigh and
    # tree
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
          host_eigh_s=f"{eigh_s:.4f}", device_pca_s=f"{pca_s:.4f}",
          cpu_cov_s=f"{cov_cpu_s:.3f}", cpu_eigh_s=f"{eigh_cpu_s:.3f}",
          host_tree_s=f"{tree_s:.3f}", covariances_equal=cov_equal,
          compute_normals_took_tree=took_tree,
          compute_normals_card_s=f"{card_s:.3f}",
          compute_normals_cpu_s=f"{cpu_s:.3f}",
          generate_normals_card_s=f"{gen_s:.3f}",
          generate_normals_cpu_s=f"{gen_cpu_s:.3f}",
          card_vs_cpu=json.dumps(m), generate_card_vs_cpu=json.dumps(mg),
          normals_equal_cpu=bool(np.array_equal(got, want)),
          card=repr(card))
    check(len(pts) > 250_000, f"normals: only {len(pts)} points")
    check(cov_equal, "normals: covariances differ between card and CPU")
    check(np.array_equal(got, want), "normals: card and CPU normals differ")
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


def encode_bytes(sources, params: dict, device) -> tuple[bytes, Encoder,
                                                        list]:
    """The port's encoder on ``device`` -> (V3C bytes, the encoder, its
    closed-loop clouds)."""
    encoder = Encoder(EncoderParameters(**params), device)
    context, recon = encoder.encode(GroupOfFrames(sources))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return write_context(context), encoder, recon


def encode_fixtures_phase(dev, card) -> None:
    """22. The committed encoder streams re-encoded on the card from their
    committed sources and parameters."""
    cpu = torch.device("cpu")
    for name in testdata.ENCODER_STREAMS:
        data, sources, record = testdata.load_encoder_stream(name)
        params = record["encoder_parameters"]
        (got, _, _), card_s = _timed(lambda: encode_bytes(sources, params,
                                                          dev))
        (want, _, _), cpu_s = _timed(lambda: encode_bytes(sources, params,
                                                          cpu))
        clouds, _, _ = decode_clouds(got, dev)
        sums = [ps.compute_checksum().hex() for ps in clouds]
        phase("encode_fixtures", stream=name, bytes=len(got),
              equal_to_cpu=got == want, equal_to_committed=got == data,
              checksums_equal_reference=sums == record["checksums"],
              encode_s=f"{card_s:.3f}", cpu_encode_s=f"{cpu_s:.3f}",
              card=repr(card))
        check(got == want, f"{name}: card and CPU encodes differ")
        check(got == data, f"{name}: the card's encode differs from the "
                           f"committed stream")
        check(sums == record["checksums"],
              f"{name}: the decode of the card's encode does not have the "
              f"reference decoder's checksums")


def encode_full_phase(dev, card) -> bytes:
    """23. Two frames at an 8i frame's scale, encoded twice on the card ->
    the stream."""
    from torch.profiler import ProfilerActivity, profile

    from rabbit_transcoding_tpu_torch.ops.events import device_busy_us

    sources, make_s = _timed(lambda: [
        testdata.make_dense_frame(i, n=ENCODE_POINTS)
        for i in range(ENCODE_FRAMES)])
    counts = [ps.point_count for ps in sources]
    check(ENCODE_POINT_RANGE[0] <= counts[0] <= ENCODE_POINT_RANGE[1],
          f"encode_full: frame 0 has {counts[0]} points")
    params = dict(frameCount=ENCODE_FRAMES, groupOfFramesSize=ENCODE_FRAMES)
    tc.LAUNCHES = 0
    (first, _, _), first_s = _timed(lambda: encode_bytes(sources, params,
                                                         dev))
    # the card's kernels only: no host operator is recorded
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (data, encoder, recon), second_s = _timed(
            lambda: encode_bytes(sources, params, dev))
    launches = tc.LAUNCHES
    events = prof.key_averages()
    busy_s = device_busy_us(events) * 1e-6
    top = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    clouds, _, decode_s = decode_clouds(data, dev)
    (_, summary), metrics_s = _timed(lambda: compute_sequence_metrics(
        sources[:1], clouds[:1], device=dev))
    context = V3CReader().decode(V3CReader().read(data)[0])
    atlas = context.vps.atlas(0)
    phase("encode_full", frames=ENCODE_FRAMES, points=counts,
          make_s=f"{make_s:.3f}",
          atlas=f"{atlas.vps_frame_width}x{atlas.vps_frame_height}",
          first_s=f"{first_s:.3f}",
          first_s_per_frame=f"{first_s / ENCODE_FRAMES:.3f}",
          second_s=f"{second_s:.3f}",
          second_s_per_frame=f"{second_s / ENCODE_FRAMES:.3f}",
          stages_ms=json.dumps({k: round(v, 1) for k, v
                                in encoder.timer.stages.items()}),
          device_busy_s=f"{busy_s:.3f}",
          busy_share=f"{busy_s / second_s:.4f}",
          top_device_ms=json.dumps({e.key[:60]: round(
              e.self_device_time_total * 1e-3, 1) for e in top}),
          bytes=len(data), runs_equal=first == data,
          transcode_kernel_launches=launches,
          recon_points=[ps.point_count for ps in recon],
          decoded_points=[ps.point_count for ps in clouds],
          decode_s=f"{decode_s:.3f}",
          d1_psnr=f"{summary.d1_psnr:.4f}", d2_psnr=f"{summary.d2_psnr:.4f}",
          y_psnr=f"{summary.color_psnr[0]:.4f}",
          metrics_s=f"{metrics_s:.3f}", card=repr(card))
    check(first == data, "encode_full: two encodes on the card differ")
    check([ps.compute_checksum() for ps in clouds]
          == [ps.compute_checksum() for ps in recon],
          "encode_full: the decode differs from the encoder's closed loop")
    check(all(np.isfinite(x) and 10.0 < x < 100.0
              for x in (summary.d1_psnr, summary.d2_psnr,
                        summary.color_psnr[0])),
          f"encode_full: metrics {summary}")
    return data


def encode_then_transcode_phase(data: bytes, dev, card) -> None:
    """24. The full-size encoder stream through the MC + intra transcode."""
    cpu = torch.device("cpu")
    params = TranscoderParameters(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                  mode="reencode")
    tc.LAUNCHES = 0
    out, walls = timed_runs(lambda: transcode_bytes(data, dev, params))
    launches = tc.LAUNCHES
    wall = statistics.median(walls)
    out_cpu, cpu_s = _timed(lambda: transcode_bytes(data, cpu, params))
    phase("encode_then_transcode", frames=ENCODE_FRAMES, runs=len(walls),
          wall_s=repr(walls), median_s=f"{wall:.4f}",
          frames_per_s=f"{ENCODE_FRAMES / wall:.3f}", in_bytes=len(data),
          out_bytes=len(out), bytes_equal_cpu=out == out_cpu,
          cpu_s=f"{cpu_s:.3f}", kernel_launches=launches, card=repr(card))
    check(out == out_cpu, "encode_then_transcode: card and CPU differ")
    clouds, _, _ = decode_clouds(out, dev)
    check(len(clouds) == ENCODE_FRAMES
          and all(ps.point_count > 0 for ps in clouds),
          "encode_then_transcode: the output does not decode")


def encode_app_phase(dev, card) -> None:
    """25. The encode app on PLYs of the first committed stream's sources:
    bytes equal to the library's encode on the card."""
    name = testdata.ENCODER_STREAMS[0]
    _, sources, record = testdata.load_encoder_stream(name)
    params = record["encoder_parameters"]
    want, _, _ = encode_bytes(sources, params, dev)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "encode"
    work.mkdir(parents=True, exist_ok=True)
    GroupOfFrames(sources).write(str(work / "src_%04d.ply"), 0)
    t0 = time.perf_counter()
    rc, _ = _run_app(encode_app.main, [
        "--uncompressedDataPath=src_%04d.ply",
        "--compressedStreamPath=out.bin", f"--device={dev.type}"]
        + [f"--{k}={v}" for k, v in params.items()], work)
    wall = time.perf_counter() - t0
    got = (work / "out.bin").read_bytes() if rc == 0 else b""
    phase("encode_app", stream=name, rc=rc, wall_s=f"{wall:.3f}",
          bytes=len(got), bytes_equal_library=got == want, card=repr(card))
    check(rc == 0 and got == want, f"encode app: rc {rc}, {len(got)} bytes")
    for p in work.glob("*.ply"):
        p.unlink()


def _phase_seconds(name: str, t0: float) -> float:
    now = time.perf_counter()
    phase("phase_seconds", phase=name, seconds=f"{now - t0:.3f}")
    return now


def encoder_phases(dev, card) -> None:
    """22.-25. The port's encoder, with each phase's seconds."""
    t0 = time.perf_counter()
    encode_fixtures_phase(dev, card)
    t0 = _phase_seconds("encode_fixtures", t0)
    data = encode_full_phase(dev, card)
    t0 = _phase_seconds("encode_full", t0)
    encode_then_transcode_phase(data, dev, card)
    t0 = _phase_seconds("encode_then_transcode", t0)
    encode_app_phase(dev, card)
    _phase_seconds("encode_app", t0)


# the foreign route's stream: the patch stream's depth cut to 2 frames of a
# 32-frame GOF (the HEVC subsets code on the host, ~7 us a sample); its
# transcode's occupancy precision, twice the stream's
FOREIGN_FRAMES = 2
FOREIGN_PRECISION = 2 * testdata.OCC_PRECISION
FOREIGN_SMALL = (FOREIGN_FRAMES, 256, 256)
# a full-size CPU decode of the stand-in stream is run when the small one
# predicts less than this
FOREIGN_CPU_FULL_LIMIT_S = 30.0


def _foreign_params(**kw) -> TranscoderParameters:
    return TranscoderParameters(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                occupancyPrecision=FOREIGN_PRECISION, **kw)


def _videos(data: bytes) -> dict:
    """{video type name: payload} of the first GOF of a V3C stream."""
    reader = V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    return {vt.name: vb.data for vt, vb in atlas.video_bitstreams.items()}


def _psnr(a: np.ndarray, b: np.ndarray, bitdepth: int) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    peak = float((1 << bitdepth) - 1)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _subset_video(payload: bytes):
    """The in-tree subsets' decode of a payload (IPCM or all-intra)."""
    return (hevc_ipcm.decode(payload) if hevc_ipcm.is_ipcm_subset(payload)
            else hevc_intra.decode(payload))


def foreign_stream_phase(dev, card) -> tuple[bytes, bytes, dict]:
    """26. The patch stream at full width, 2 frames, built on the card;
    its videos decoded on the card and re-encoded by the in-tree HEVC
    subsets: occupancy as IPCM (lossless, 8-bit 4:0:0), geometry as the
    all-intra subset at QP 16 (10-bit 4:0:0), attribute at QP 22 (8-bit
    4:2:0) -> (RBV stream, foreign stream, {video: decoded input video})."""
    t0 = time.perf_counter()
    data = make_stream(FOREIGN_FRAMES, WIDTH, HEIGHT, device=dev,
                       patches=True, smoothing=True)
    rbv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    foreign = testdata.to_foreign(data, dev, workers=3)
    hevc_s = time.perf_counter() - t0
    payloads = _videos(foreign)
    t0 = time.perf_counter()
    planes = {name: _subset_video(p) for name, p in payloads.items()}
    decode_s = time.perf_counter() - t0
    subsets = {name: "ipcm" if hevc_ipcm.is_ipcm_subset(p) else
               "intra" if hevc_intra.is_intra_subset(p) else "none"
               for name, p in payloads.items()}
    phase("foreign_stream", frames=FOREIGN_FRAMES, size=f"{WIDTH}x{HEIGHT}",
          bytes=len(foreign), rbv_bytes=len(data),
          video_bytes={k: len(v) for k, v in payloads.items()},
          subsets=subsets, rbv_build_s=f"{rbv_s:.3f}",
          hevc_encode_s=f"{hevc_s:.3f}", hevc_decode_s=f"{decode_s:.3f}",
          card=repr(card))
    check(subsets == {"OCCUPANCY": "ipcm", "GEOMETRY": "intra",
                      "ATTRIBUTE": "intra"},
          f"foreign stream: subsets {subsets}")
    want = {"OCCUPANCY": (WIDTH // testdata.OCC_PRECISION, 8, "YUV400"),
            "GEOMETRY": (WIDTH, 10, "YUV400"),
            "ATTRIBUTE": (WIDTH, 8, "YUV420")}
    for name, video in planes.items():
        check((video.width, video.bitdepth, video.format.name)
              == want[name] and video.frame_count == FOREIGN_FRAMES,
              f"foreign stream: {name} is {video.width} wide, "
              f"{video.bitdepth}-bit {video.format.name}")
    return data, foreign, planes


def foreign_transcode_phase(foreign: bytes, planes: dict, dev,
                            card) -> bytes:
    """27. The foreign stream through ``Transcoder(device=cuda)`` with no
    external binary: the route resolves the in-tree subsets.  One timed
    run; geometry and attribute come out smaller, decode, and have their
    PSNR against the input planes printed; the occupancy equals a CPU
    max-pool of the input's.  Held byte for byte against ``device=cpu``
    at 256x256, 2 frames -> the output stream."""
    from rabbit_transcoding_tpu_torch.transcoder import foreign as route

    params = _foreign_params()
    reader = V3CReader()
    context = reader.decode(reader.read(foreign)[0])
    atlas = context.atlas(0)
    codecs = {vt.name: type(route.resolve(params, vt, context, atlas,
                                          vb.data)).__name__
              for vt, vb in atlas.video_bitstreams.items()}
    check(codecs == {"OCCUPANCY": "IpcmCodec", "GEOMETRY": "HevcIntraCodec",
                     "ATTRIBUTE": "HevcIntraCodec"},
          f"foreign transcode: resolved {codecs} (an external binary on "
          f"PATH or in RABBIT_*_APP_* would take the route)")
    tc.LAUNCHES = 0
    transcoder = Transcoder(params, dev)
    t0 = time.perf_counter()
    transcoder.transcode(context)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = write_context(context)
    before, after = _videos(foreign), _videos(out)
    psnr = {}
    for name in ("GEOMETRY", "ATTRIBUTE"):
        check(len(after[name]) < len(before[name]),
              f"foreign transcode: {name} did not shrink")
        got, want = hevc_intra.decode(after[name]), planes[name]
        check(got.frame_count == FOREIGN_FRAMES and got.width == WIDTH,
              f"foreign transcode: {name} decodes to {got.width} wide")
        psnr[name] = [round(float(_psnr(a, b, want.bitdepth)), 4)
                      for a, b in zip(got.planes, want.planes)]
        check(all(a.shape == b.shape for a, b in zip(got.planes,
                                                       want.planes)),
              f"foreign transcode: {name} planes change shape")
    occ_in = planes["OCCUPANCY"].planes[0]
    f = FOREIGN_PRECISION // testdata.OCC_PRECISION
    n, h, w = occ_in.shape
    pooled = occ_in.reshape(n, h // f, f, w // f, f).max(axis=(2, 4))
    occ_out = hevc_ipcm.decode(after["OCCUPANCY"]).planes[0]
    t0 = time.perf_counter()
    small = testdata.to_foreign(make_stream(*FOREIGN_SMALL, patches=True,
                                            smoothing=True))
    small_card = transcode_bytes(small, dev, params)
    small_cpu = transcode_bytes(small, torch.device("cpu"), params)
    small_s = time.perf_counter() - t0
    phase("foreign_transcode", wall_s=f"{wall:.4f}",
          seconds_per_frame=f"{wall / FOREIGN_FRAMES:.4f}",
          stages={k: round(v, 3) for k, v in transcoder.timer.stages.items()},
          bytes_in={k: len(v) for k, v in before.items()},
          bytes_out={k: len(v) for k, v in after.items()},
          psnr_vs_input_db=psnr, occupancy_equals_cpu_maxpool=bool(
              np.array_equal(occ_out, pooled)),
          small_bytes_equal_cpu=small_card == small_cpu,
          small_s=f"{small_s:.3f}", kernel_launches=tc.LAUNCHES,
          card=repr(card))
    check(np.array_equal(occ_out, pooled),
          "foreign transcode: occupancy differs from the CPU max-pool")
    check(all(x > 20.0 for v in psnr.values() for x in v),
          f"foreign transcode: PSNR {psnr}")
    check(small_card == small_cpu,
          "foreign transcode: card and CPU bytes differ at 256x256")
    return out


def foreign_decode_phase(rbv_data: bytes, work: Path, dev, card) -> tuple:
    """28. The same atlas with stand-in HEVC sub-streams (``mock_hevc``),
    decoded by ``Decoder(device=cuda)`` with the videoDecoder*Path
    parameters set to the stand-in wrappers: frames/s and points per
    frame; clouds equal a ``device=cpu`` decode at 256x256 and, when that
    predicts under ``FOREIGN_CPU_FULL_LIMIT_S``, at full size -> the
    wrappers (encoder, decoder)."""
    enc, dec = testdata.write_codec_wrappers(work)
    paths = {f"videoDecoder{c}Path": dec
             for c in ("Occupancy", "Geometry", "Attribute")}

    def decode(data, device):
        reader = V3CReader()
        t0 = time.perf_counter()
        clouds = Decoder(DecoderParameters(**paths), device).decode(
            reader.decode(reader.read(data)[0]))
        if device.type == "cuda":
            torch.cuda.synchronize()
        return clouds, time.perf_counter() - t0

    mock = testdata.to_foreign(rbv_data, dev, codec="mock")
    clouds, wall = decode(mock, dev)
    again, _ = decode(mock, dev)
    small = testdata.to_foreign(make_stream(*FOREIGN_SMALL, patches=True,
                                            smoothing=True), codec="mock")
    small_card, _ = decode(small, dev)
    small_cpu, small_s = decode(small, torch.device("cpu"))
    predicted = small_s * (WIDTH * HEIGHT) / (FOREIGN_SMALL[1]
                                              * FOREIGN_SMALL[2])
    full_equal = None
    if predicted < FOREIGN_CPU_FULL_LIMIT_S:
        full_cpu, _ = decode(mock, torch.device("cpu"))
        full_equal = clouds_equal(clouds, full_cpu)
    points = [ps.point_count for ps in clouds]
    phase("foreign_decode", frames=len(clouds), wall_s=f"{wall:.4f}",
          frames_per_s=f"{len(clouds) / wall:.3f}", points=points,
          bytes=len(mock), equal_run_to_run=clouds_equal(clouds, again),
          small_equal_cpu=clouds_equal(small_card, small_cpu),
          small_cpu_s=f"{small_s:.3f}", predicted_full_cpu_s=f"{predicted:.1f}",
          full_equal_cpu=full_equal, card=repr(card))
    check(len(clouds) == FOREIGN_FRAMES and min(points) > WIDTH * HEIGHT // 16,
          f"foreign decode: points {points}")
    check(clouds_equal(clouds, again), "foreign decode: runs differ")
    check(clouds_equal(small_card, small_cpu),
          "foreign decode: card and CPU clouds differ at 256x256")
    check(full_equal in (None, True),
          "foreign decode: card and CPU clouds differ at full size")
    return enc, dec


def foreign_encode_phase(enc: str, dec: str, dev, card) -> None:
    """29. The first committed encoder stream's sources encoded with
    ``videoEncoder{Occupancy,Geometry,Attribute}CodecId=HM_APP`` through the
    stand-in, on the card and on the CPU: equal bytes.  Its stream decoded
    through the stand-in decoder on the card (the closed loop's checksums),
    then through the ``ForeignCodec`` transcode with the stand-in, on the
    card and on the CPU: equal bytes."""
    comps = ("Occupancy", "Geometry", "Attribute")
    name = testdata.ENCODER_STREAMS[0]
    _, sources, record = testdata.load_encoder_stream(name)
    params = dict(record["encoder_parameters"])
    for c in comps:
        params[f"videoEncoder{c}CodecId"] = "HM_APP"
        params[f"videoEncoder{c}Path"] = enc
    (got, _, recon), card_s = _timed(lambda: encode_bytes(sources, params,
                                                          dev))
    (want, _, _), cpu_s = _timed(lambda: encode_bytes(
        sources, params, torch.device("cpu")))
    reader = V3CReader()
    clouds = Decoder(DecoderParameters(**{
        f"videoDecoder{c}Path": dec for c in comps}), dev).decode(
            reader.decode(reader.read(got)[0]))
    sums_equal = ([ps.compute_checksum() for ps in clouds]
                  == [ps.compute_checksum() for ps in recon])
    paths = {}
    for c in comps:
        paths[f"videoEncoder{c}Path"] = enc
        paths[f"videoDecoder{c}Path"] = dec
    tparams = TranscoderParameters(geometryQP=GEO_QP, attributeQP=ATTR_QP,
                                   **paths)
    (out, t_s) = _timed(lambda: transcode_bytes(got, dev, tparams))
    out_cpu = transcode_bytes(got, torch.device("cpu"), tparams)
    videos = _videos(got)
    phase("foreign_encode", stream=name, bytes=len(got),
          equal_to_cpu=got == want, annexb={
              k: v[:4] == b"\x00\x00\x00\x01" for k, v in videos.items()},
          decode_checksums_equal_closed_loop=sums_equal,
          transcode_bytes=len(out), transcode_equal_cpu=out == out_cpu,
          encode_s=f"{card_s:.3f}", cpu_encode_s=f"{cpu_s:.3f}",
          transcode_s=f"{t_s:.3f}", card=repr(card))
    check(got == want, "foreign encode: card and CPU bytes differ")
    check(all(v[:4] == b"\x00\x00\x00\x01" for v in videos.values()),
          "foreign encode: a sub-stream is not Annex-B")
    check(sums_equal, "foreign encode: the decode differs from the "
                      "closed loop")
    check(out == out_cpu and out != got,
          "foreign encode: the stand-in transcode differs from the CPU's")


def _transcode_app(work: Path, dev) -> subprocess.Popen:
    """``apps.transcode --device=cuda`` on ``work/foreign.bin`` in a
    process of its own, started before the library call so that the two
    host-bound transcodes run on two cores at once."""
    log = open(work / "transcode_app.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "rabbit_transcoding_tpu_torch.apps.transcode",
         "--compressedStreamPath=foreign.bin", "--outStreamPath=out.bin",
         f"--geometryQP={GEO_QP}", f"--attributeQP={ATTR_QP}",
         f"--occupancyPrecision={FOREIGN_PRECISION}", f"--device={dev.type}"],
        cwd=work, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)})


def foreign_apps_phase(app: subprocess.Popen, out: bytes, work: Path,
                       card) -> None:
    """30. ``apps.parser --bin`` on the foreign stream prints the HEVC probe
    lines; ``apps.transcode --device=cuda`` on it (started with phase 27)
    writes the library call's bytes (phase 27's output)."""
    rc_p, lines = _run_app(parser_app.main, ["--bin=foreign.bin"], work)
    hevc = [ln.strip() for ln in lines if " HEVC " in ln]
    t0 = time.perf_counter()
    rc_t = app.wait(timeout=600)
    waited = time.perf_counter() - t0
    got = (work / "out.bin").read_bytes() if rc_t == 0 else b""
    phase("foreign_apps", parser_rc=rc_p, hevc_lines=hevc, transcode_rc=rc_t,
          transcode_waited_s=f"{waited:.3f}", bytes_equal_library=got == out,
          card=repr(card))
    want = [f"HEVC {WIDTH // testdata.OCC_PRECISION}x"
            f"{HEIGHT // testdata.OCC_PRECISION} 8bit",
            f"HEVC {WIDTH}x{HEIGHT} 10bit", f"HEVC {WIDTH}x{HEIGHT} 8bit"]
    check(rc_p == 0 and all(any(w in ln for ln in hevc) for w in want),
          f"parser app: rc {rc_p}, lines {hevc}")
    check(rc_t == 0 and got == out,
          f"transcode app: rc {rc_t}, {len(got)} bytes, log "
          f"{(work / 'transcode_app.log').read_text()[-2000:]}")


def foreign_phases(dev, card) -> None:
    """26.-30. The foreign-codec route, with each phase's seconds."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "foreign"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rbv_data, foreign, planes = foreign_stream_phase(dev, card)
    t0 = _phase_seconds("foreign_stream", t0)
    (work / "foreign.bin").write_bytes(foreign)
    app = _transcode_app(work, dev)
    try:
        out = foreign_transcode_phase(foreign, planes, dev, card)
        t0 = _phase_seconds("foreign_transcode", t0)
        enc, dec = foreign_decode_phase(rbv_data, work, dev, card)
        t0 = _phase_seconds("foreign_decode", t0)
        foreign_encode_phase(enc, dec, dev, card)
        t0 = _phase_seconds("foreign_encode", t0)
        foreign_apps_phase(app, out, work, card)
        _phase_seconds("foreign_apps", t0)
    finally:
        if app.poll() is None:
            app.kill()
            app.wait()


# ---------------------------------------------------------------------------
# 31.-35. The device mesh
# ---------------------------------------------------------------------------
MESH_STREAMS = 9        # bench streams beside the MC + intra one
MESH_D1_BOUND_DB = 0.2  # d1_psnr_sharded against compute_metrics' D1


def meshes(dev0, card) -> list:
    """(name, mesh): (a) ``dev0`` (card 0) alone, (b) a virtual (4, 2) mesh
    on it, (c) every visible card when there are two or more."""
    out = [("one", make_mesh([dev0])),
           ("virtual_4x2", make_mesh([dev0] * 8, stream_axis=4))]
    n = torch.cuda.device_count()
    if n >= 2:
        out.append((f"every_card_{n}", make_mesh()))
    else:
        phase("mesh_every_card", skipped=True,
              reason=f"{n} visible card: a mesh over every card would be "
                     f"mesh (a) again", card=repr(card))
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def kernel_shards(mesh, streams: int) -> int:
    """Batched launches per plane for ``streams`` streams of the kernel's
    branch: one per shard of the flattened mesh that holds a stream."""
    return min(streams, mesh.size)


class LaunchRecorder:
    """Records every ``transcode_coeffs_batched`` call of the batched
    multi-stream path (inputs, output, device) while installed; the calls
    still go through the wrapper, which counts the launches."""

    def __init__(self):
        self.calls = []
        self._real = ms_mod.transcode_coeffs_batched

    def __enter__(self):
        def spy(q, qs_in, qs_out, maxval, gop_in, gop_out):
            out = self._real(q, qs_in, qs_out, maxval, gop_in, gop_out)
            self.calls.append((q.clone(), qs_in.clone(), qs_out.clone(),
                               maxval, gop_in, gop_out, out.clone()))
            return out

        ms_mod.transcode_coeffs_batched = spy
        return self

    def __exit__(self, *exc):
        ms_mod.transcode_coeffs_batched = self._real


def mesh_transcode_phase(datas: list[bytes], params, mesh_list, dev0,
                         card) -> dict:
    """31. ``MESH_STREAMS`` bench streams and the MC + intra stream through
    ``MultiStreamTranscoder(mesh=...)`` on each mesh: bytes equal to the
    sequential ``Transcoder`` on every mesh, each kernel launch of a
    recorded round equal to its plain version, the launches per device and
    round, and aggregate frames/s (median of 3 after a warm-up) ->
    {mesh name: batched launches per round}."""
    seq, seq_walls = timed_runs(
        lambda: [transcode_bytes(d, dev0, params) for d in datas], n=1)
    per_round = {}
    for name, mesh in mesh_list:
        mst = MultiStreamTranscoder(params, mesh=mesh)
        with LaunchRecorder() as rec:
            first = transcode_many_bytes(datas, dev0, params, mst)
        sync(dev0)
        worst = 0
        for q, qi, qo, maxval, gi, go, out in rec.calls:
            want = tc.transcode_coeffs_batched_ref(q, qi, qo, maxval, gi, go)
            worst = max(worst, compare(out, want)[1]
                        if out.numel() else 0)
        by_device: dict[int, int] = {}
        for call in rec.calls:
            by_device[call[0].device.index] = by_device.get(
                call[0].device.index, 0) + 1
        recorded = len(rec.calls)
        del rec     # the recorded tensors, before the timed rounds
        tc.BATCHED_LAUNCHES = 0
        outs, walls = timed_runs(
            lambda: transcode_many_bytes(datas, dev0, params, mst))
        runs = len(walls) + 1
        per_round[name] = tc.BATCHED_LAUNCHES // runs
        wall = statistics.median(walls)
        frames = FRAMES * len(datas)
        phase("mesh_transcode", mesh=name, shape=mesh.shape,
              streams=len(datas), runs=len(walls), wall_s=repr(walls),
              median_s=f"{wall:.4f}", frames_per_s=f"{frames / wall:.3f}",
              sequential_wall_s=repr(seq_walls),
              sequential_frames_per_s=f"{frames / seq_walls[0]:.3f}",
              launches_per_round=per_round[name],
              recorded_launches=recorded,
              launches_per_device=json.dumps(by_device),
              launch_max_abs_diff_vs_plain=worst,
              bytes_equal=first == seq and outs == seq,
              cards=mesh_card_count(mesh), card=repr(card))
        want_launches = 4 * kernel_shards(mesh, len(datas) - 1)
        check(first == seq and outs == seq,
              f"mesh_transcode {name}: bytes differ from the sequential port")
        check(recorded == want_launches
              and per_round[name] * runs == tc.BATCHED_LAUNCHES
              and per_round[name] == want_launches,
              f"mesh_transcode {name}: {recorded} recorded and "
              f"{tc.BATCHED_LAUNCHES} counted launches in {runs} rounds, "
              f"want {want_launches} per round")
        check(worst == 0, f"mesh_transcode {name}: a launch differs from "
                          f"its plain version by {worst}")
    return per_round


def mesh_card_count(mesh) -> int:
    return len({d.index for d in mesh.flat})


def mesh_step_phase(luma: torch.Tensor, mesh_list, dev0, card) -> None:
    """32. The sharded all-intra step at the bench luma shape (S = 4): q2
    and recon equal mesh (a)'s; the MSE and the step's time."""
    want = None
    for name, mesh in mesh_list:
        step = make_sharded_transcode_step(mesh)
        args = (luma, qstep(STREAM_QPS[0]), qstep(GEO_QP), 1023.0)
        before = tc.LAUNCHES
        got = step(*args)
        sync(dev0)
        launches = tc.LAUNCHES - before
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(*args)
            sync(dev0)
            walls.append(time.perf_counter() - t0)
        if want is None:
            want = got
        equal = (torch.equal(got[0], want[0])
                 and torch.equal(got[1], want[1]))
        phase("mesh_step", mesh=name, shape=tuple(luma.shape),
              launches=launches, mse=f"{float(got[2]):.6f}",
              mse_vs_a=float(got[2]) - float(want[2]), q2_recon_equal=equal,
              wall_s=repr(walls), cards=mesh_card_count(mesh),
              card=repr(card))
        check(equal, f"mesh_step {name}: q2 or recon differ from mesh (a)")
        check(launches == mesh.size,
              f"mesh_step {name}: {launches} launches, want {mesh.size}")
        check(abs(float(got[2]) - float(want[2]))
              <= 1e-6 * float(want[2]), f"mesh_step {name}: MSE differs")


def mesh_decode_phase(data: bytes, clouds: list | None, mesh_list, dev0,
                      card) -> None:
    """33. The decode cell's patch stream through
    ``Decoder(DecoderParameters(shardingMesh=mesh))``: clouds equal mesh
    (a)'s and the unsharded decode's, arrays in order; decode frames/s
    (median of 3 after a warm-up)."""
    reader = V3CReader()
    units = reader.read(data)[0]
    want = clouds
    for name, mesh in mesh_list:
        params = DecoderParameters(shardingMesh=mesh)
        walls = []
        for i in range(4):
            t0 = time.perf_counter()
            got = Decoder(params, device=dev0).decode(reader.decode(units))
            sync(dev0)
            if i:
                walls.append(time.perf_counter() - t0)
        if want is None:
            want = got
        wall = statistics.median(walls)
        equal = clouds_equal(got, want)
        phase("mesh_decode", mesh=name, shape=mesh.shape,
              runs=len(walls), wall_s=repr(walls), median_s=f"{wall:.4f}",
              frames_per_s=f"{FRAMES / wall:.3f}",
              points=sum(ps.point_count for ps in got),
              clouds_equal=equal, cards=mesh_card_count(mesh),
              card=repr(card))
        check(equal, f"mesh_decode {name}: clouds differ")


def mesh_metrics_phase(mesh_list, dev0, card) -> None:
    """34. ``d1_psnr_sharded`` of frame 0 of the first committed encoder
    stream, decoded on the card, against its source cloud: equal to mesh
    (a)'s and within ``MESH_D1_BOUND_DB`` of ``compute_metrics``' D1 (the
    committed reference value, which phase 20 holds the port to)."""
    data, sources, record = testdata.load_encoder_stream(
        testdata.ENCODER_STREAMS[0])
    reader = V3CReader()
    rec = Decoder(device=dev0).decode(
        reader.decode(reader.read(data)[0]))[0]
    plain = record["metrics_per_frame"][0].d1_psnr
    want = None
    for name, mesh in mesh_list:
        t0 = time.perf_counter()
        got = float(d1_psnr_sharded(sources[0], rec, mesh, MetricsParams()))
        wall = time.perf_counter() - t0
        want = got if want is None else want
        phase("mesh_metrics", mesh=name, stream=testdata.ENCODER_STREAMS[0],
              points=rec.point_count, d1_psnr_sharded=repr(got),
              compute_metrics_d1=repr(plain), delta_db=got - plain,
              seconds=f"{wall:.3f}", cards=mesh_card_count(mesh),
              card=repr(card))
        check(got == want, f"mesh_metrics {name}: D1 {got} != mesh (a)'s "
                           f"{want}")
        check(abs(got - plain) < MESH_D1_BOUND_DB,
              f"mesh_metrics {name}: D1 {got} vs {plain}")


def mesh_stream_app_phase(app_io, mesh_list, dev0, card) -> None:
    """35. ``rabbit-stream --sharded=1``'s batched mode over each mesh:
    bytes equal to the unsharded mode's (phase 12), no batched-round
    failure."""
    inputs, plain, params, work = app_io
    for name, mesh in mesh_list:
        outs = [str(work / f"mesh_{name}{i}.bin") for i in range(len(inputs))]
        t0 = time.perf_counter()
        results = stream_app.transcode_streams_sharded(inputs, outs, params,
                                                       mesh=mesh)
        wall = time.perf_counter() - t0
        equal = all(Path(a).read_bytes() == Path(b).read_bytes()
                    for a, b in zip(plain, outs))
        failures = [r["failures"] for r in results]
        batched_failures = [r["batched_failures"] for r in results]
        phase("mesh_stream_app", mesh=name, bytes_equal=equal,
              failures=failures, batched_failures=batched_failures,
              wall_s=f"{wall:.3f}", cards=mesh_card_count(mesh),
              card=repr(card))
        check(equal, f"mesh_stream_app {name}: bytes differ")
        check(not any(failures) and not any(batched_failures),
              f"mesh_stream_app {name}: failures {failures}, batched "
              f"{batched_failures}")


def mesh_phases(streams: list[bytes], data_mi: bytes, luma: torch.Tensor,
                patch_data: bytes, clouds: list | None, app_io, params,
                card, dev0=torch.device("cuda", 0)) -> dict:
    """31.-35. The device mesh around ``dev0`` (card 0), with each phase's
    seconds -> batched launches per round of the mesh transcode, by
    mesh."""
    mesh_list = meshes(dev0, card)
    t0 = time.perf_counter()
    datas = [streams[i % len(streams)] for i in range(MESH_STREAMS)]
    per_round = mesh_transcode_phase(datas + [data_mi], params, mesh_list,
                                     dev0, card)
    t0 = _phase_seconds("mesh_transcode", t0)
    mesh_step_phase(luma, mesh_list, dev0, card)
    t0 = _phase_seconds("mesh_step", t0)
    mesh_decode_phase(patch_data, clouds, mesh_list, dev0, card)
    t0 = _phase_seconds("mesh_decode", t0)
    mesh_metrics_phase(mesh_list, dev0, card)
    t0 = _phase_seconds("mesh_metrics", t0)
    mesh_stream_app_phase(app_io, mesh_list, dev0, card)
    _phase_seconds("mesh_stream_app", t0)
    return per_round


def luma_stack(streams: list[bytes], dev) -> torch.Tensor:
    """The geometry luma coefficients of the streams, stacked (S, F, ...)."""
    return torch.stack([stream_coeffs(d, dev)[("GEOMETRY", 0)]
                        for d in streams])


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
    app_io = stream_app_phase(streams, dev, card)

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
    # 22.-25. the encoder
    encoder_phases(dev, card)
    # 26.-30. the foreign-codec route
    foreign_phases(dev, card)
    # 31.-35. the device mesh
    batched["launches_per_round_mesh"] = mesh_phases(
        streams, data_mi, luma_stack(streams, dev), patch_streams[0], clouds,
        app_io, params, card)

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
