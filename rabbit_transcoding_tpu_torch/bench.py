"""Headline benchmark of the PyTorch port: live V-PCC transcode throughput
per card.

Port of the repo's ``bench.py``, with its cell, knobs and JSON record:
transcoding 1024x1024-atlas V-PCC streams (geometry 10-bit + attribute
YUV420 + occupancy) to a lower rate point, end to end (V3C demux, video
decode, re-encode at new QPs, remux), all host entropy work included.
Prints ONE JSON line last:
  {"metric": ..., "value": fps, "unit": "frames/sec/chip", "vs_baseline": x,
   ..., "device": "<card name>, <power limit>"}
``vs_baseline`` is against the 30 fps live-transcode target (BASELINE.md).

    python -m rabbit_transcoding_tpu_torch.bench [--device cuda|cpu]

Env knobs: BENCH_MODE=reencode|requant|auto, BENCH_FRAMES (32), BENCH_GOFS
(3), BENCH_STREAMS (1), BENCH_PIPELINE (3), BENCH_WINDOWS (7), BENCH_MULTI
(1: record the 4-stream aggregate).

Protocol, fixed before any measurement: one warm-up GOF, then
``BENCH_WINDOWS`` windows of ``BENCH_GOFS`` GOFs each at pipeline depth
``BENCH_PIPELINE`` (GOFs in flight on that many threads, sharing one
``Transcoder``, as ``apps/stream.py --pipelineDepth`` runs them).  The
headline is the median over ALL windows; the best window and the window
list ride along.  Every timed GOF's output must equal the warm-up GOF's
bytes, or the run fails.  The 4-stream aggregate is one warm-up round and
the fastest of 4 rounds of ``MultiStreamTranscoder.transcode_many``.  The
quality half is ``metrics/quality_probe.py`` in a process of its own on the
same device; a probe failure is logged and leaves its keys out.

Runs on the card unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

from .bitstream import V3CReader, V3CWriter
from .device import card_name_and_power, resolve
from .testdata import make_stream
from .transcoder import (
    MultiStreamTranscoder, Transcoder, TranscoderParameters,
)
from .utils.enums import VideoType
from .video import rbv

# the live-transcode target the headline is compared with (BASELINE.md)
TARGET_FPS = 30.0
D1_BAR_DB, Y_BAR_DB = 0.05, 0.1
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_params(mode: str = "reencode") -> TranscoderParameters:
    """The cell's operating point: geometry QP 32, attribute QP 42."""
    return TranscoderParameters(geometryQP=32, attributeQP=42, mode=mode,
                                computeHashSei=False)


def _cache_valid(blob: bytes, device) -> bool:
    """The cached stream still parses, probes and decodes (its occupancy)."""
    try:
        r = V3CReader()
        atlas = r.decode(r.read(blob)[0]).atlas(0)
        for vt in (VideoType.OCCUPANCY, VideoType.GEOMETRY,
                   VideoType.ATTRIBUTE):
            rbv.probe(atlas.get_video_bitstream(vt).data)
        rbv.decode(atlas.get_video_bitstream(VideoType.OCCUPANCY).data,
                   device)
        return True
    except Exception as e:  # any fault in the cached bytes: regenerate
        log(f"stream cache invalid ({e!r}); regenerating")
        return False


def input_stream(frames: int, device) -> bytes:
    """``testdata.make_stream(frames)`` (1024x1024), cached in the temp
    directory while it still decodes."""
    cache = os.path.join(tempfile.gettempdir(),
                         f"rabbit_torch_bench_stream_{frames}.bin")
    if os.path.exists(cache):
        with open(cache, "rb") as fh:
            blob = fh.read()
        if _cache_valid(blob, device):
            log(f"input stream from cache {cache}")
            return blob
    data = make_stream(frames, device=device)
    tmp = cache + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, cache)
    return data


def transcode_gof(units, transcoder: Transcoder) -> bytes:
    """One GOF (its V3C units) through ``transcoder`` -> V3C bytes."""
    context = V3CReader().decode(list(units))
    transcoder.transcode(context)
    w = V3CWriter()
    return w.write(w.encode(context))


def cell(data: bytes, device="cuda", mode: str = "reencode") -> bytes:
    """The bench cell: the first GOF of ``data`` through one ``Transcoder``
    at the cell's parameters on ``device`` -> V3C bytes."""
    return transcode_gof(V3CReader().read(data)[0],
                         Transcoder(bench_params(mode), device))


def _digest(out: bytes) -> tuple[int, str]:
    return len(out), hashlib.sha256(out).hexdigest()


def quality_probe(params: TranscoderParameters, device) -> dict:
    """The port's quality probe at the cell's QPs on ``device``, in a process
    of its own (its encode and decodes stay out of this process)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-m",
         "rabbit_transcoding_tpu_torch.metrics.quality_probe",
         str(params.geometryQP), str(params.attributeQP), str(device)],
        capture_output=True, text=True, timeout=1800, env=env, check=True,
    ).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a "
                         "GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    t_setup = time.perf_counter()

    mode = os.environ.get("BENCH_MODE", "reencode")
    frames = int(os.environ.get("BENCH_FRAMES", "32"))
    n_gofs = int(os.environ.get("BENCH_GOFS", "3"))
    n_streams = int(os.environ.get("BENCH_STREAMS", "1"))
    depth = int(os.environ.get("BENCH_PIPELINE", "3"))
    n_windows = int(os.environ.get("BENCH_WINDOWS", "7"))
    card = card_name_and_power() if device.type == "cuda" else "cpu"
    log(f"device: {device} ({card})  mode={mode} frames/gof={frames} "
        f"streams={n_streams}")

    data = input_stream(frames, device)
    log(f"input stream: {len(data)} bytes "
        f"({len(data) * 8 / frames / 30:.0f} kbit/s @30fps); "
        f"setup {time.perf_counter() - t_setup:.1f}s")

    # one timed host -> device push: it warms the link before the timed
    # windows and steers the int8 AC slab wire format (rbv._slab8_enabled)
    rate = rbv.measure_link_rate(32 << 20, device)
    log(f"link {rate:.0f} MB/s"
        + (" -> int8 AC slab uploads ON"
           if rate < rbv._SLAB8_LINK_THRESHOLD_MBPS else ""))

    params = bench_params(mode)
    units = V3CReader().read(data)[0]
    # ONE Transcoder per stream, exactly like the stream app: per-stream
    # state (the ABR QP cache) persists across that stream's GOFs
    transcoders = [Transcoder(params, device)
                   for _ in range(max(1, n_streams))]

    def one_gof(stream_idx: int = 0) -> bytes:
        return transcode_gof(units, transcoders[stream_idx])

    t0 = time.perf_counter()
    want = _digest(one_gof())
    warmup_s = time.perf_counter() - t0
    log(f"warmup gof: {warmup_s:.2f}s; out {want[0]} bytes")

    def check(outs) -> None:
        for out in outs:
            if _digest(out) != want:
                raise RuntimeError(
                    f"a timed GOF wrote {_digest(out)}, the warm-up GOF "
                    f"{want}: GOFs in flight disturbed each other")

    if n_streams <= 1:
        walls = []
        for _ in range(n_windows):
            t0 = time.perf_counter()
            if depth <= 1:
                outs = [one_gof() for _ in range(n_gofs)]
            else:
                with cf.ThreadPoolExecutor(max_workers=depth) as ex:
                    futs = [ex.submit(one_gof) for _ in range(n_gofs)]
                    outs = [fu.result() for fu in futs]
            walls.append(time.perf_counter() - t0)
            check(outs)
            log(f"window: {walls[-1]:.2f}s")
        wall = statistics.median(walls)
        wall_best = min(walls)
        total_frames = frames * n_gofs
    else:
        # concurrent streams, per-stream threads overlapping host entropy
        # with device compute
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=n_streams) as ex:
            for outs in ex.map(
                    lambda si: [one_gof(si) for _ in range(n_gofs)],
                    range(n_streams)):
                check(outs)
        wall = time.perf_counter() - t0
        wall_best = wall
        total_frames = frames * n_gofs * n_streams
    fps = total_frames / wall
    fps_best = total_frames / wall_best
    log(f"{total_frames} frames, median window {wall:.2f}s -> {fps:.2f} "
        f"fps/chip (best window {fps_best:.2f})")

    ms_fps = None
    if n_streams <= 1 and os.environ.get("BENCH_MULTI", "1") != "0":
        # the 4-stream aggregate through the batched multi-stream path:
        # one device call per plane for all 4 streams; host entropy
        # (decode/remux) 4-way threaded
        mst = MultiStreamTranscoder(params, device)

        def ms_window() -> float:
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=4) as ex:
                contexts = list(ex.map(
                    lambda _i: V3CReader().decode(list(units)), range(4)))
            mst.transcode_many(contexts)

            def wr(c) -> bytes:
                w = V3CWriter()
                return w.write(w.encode(c))

            with cf.ThreadPoolExecutor(max_workers=4) as ex:
                outs = list(ex.map(wr, contexts))
            wall = time.perf_counter() - t0
            check(outs)
            return wall

        ms_window()  # warm-up round
        ms_wall = min(ms_window() for _ in range(4))
        ms_fps = frames * 4 / ms_wall
        log(f"4-stream aggregate (batched device path): {ms_fps:.2f} "
            f"fps/chip")

    # quality half of the north star: D1 and Y deltas of the live modes
    # against the full decode -> re-encode baseline at the same QPs
    q = None
    try:
        q = quality_probe(params, device)
        log(f"quality: auto D1 delta={q['d1_delta_auto']:+.4f} dB (bar "
            f"<={D1_BAR_DB}), auto Y delta={q['y_delta_auto']:+.4f} dB (bar "
            f"<={Y_BAR_DB}); requant-path D1 delta={q['d1_delta']:+.4f}, Y "
            f"delta={q['y_delta']:+.4f} (live={q['d1_live']:.2f} vs "
            f"baseline={q['d1_baseline']:.2f})")
    except (OSError, subprocess.SubprocessError, ValueError, KeyError,
            IndexError) as e:  # the fps headline survives a probe failure
        log(f"quality probe failed: {e!r}")
        q = None

    suffix = f"_{n_streams}streams" if n_streams > 1 else ""
    record = {
        "metric": f"vpcc_transcode_fps_1024_{mode}{suffix}",
        # headline = median of all windows; the best and the list ride along
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / TARGET_FPS, 3),
        "fps_best_window": round(fps_best, 2),
    }
    if n_streams <= 1:
        record["windows_s"] = [round(w, 2) for w in walls]
        record["n_windows"] = len(walls)
    else:
        record["n_windows"] = 1
    if q is not None:
        # the shipping live mode is `auto`: its D1 and Y deltas are gated;
        # the requant path's ride along
        record["d1_delta_db"] = q["d1_delta_auto"]
        record["d1_bar_db"] = D1_BAR_DB
        record["d1_delta_requant_db"] = q["d1_delta"]
        record["y_delta_db"] = q["y_delta_auto"]
        record["y_bar_db"] = Y_BAR_DB
        record["y_delta_requant_db"] = q["y_delta"]
        record["quality_bars_met"] = bool(
            q["d1_delta_auto"] <= D1_BAR_DB and q["y_delta_auto"] <= Y_BAR_DB)
    if ms_fps is not None:
        record["aggregate_fps_4stream"] = round(float(ms_fps), 2)
    record["warmup_s"] = round(warmup_s, 1)
    record["device"] = card
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
