"""Reference-scale CTC rate-ladder runner on the PyTorch port.

Twin of the repo's ``scripts/ladder_big.py``: the encode-once /
transcode-r1..r5 protocol of ``ladder.py`` at vox10 scale (~300k-800k
points a frame, GOF 32), with two differences forced by the long runtime:

  * RESUMABLE: the high-quality encode is cached to --workdir, and every
    completed (rate, mode) cell is appended to the CSV immediately; a
    re-run skips cells already present, so the job survives restarts.
  * progress + per-cell timing go to stderr; the CSV is the artifact.

Every stage runs on ``--device`` (the card unless the caller asks for the
CPU; no card raises).  The default workdir is under the temp directory and
the default CSV is not the reference's, so neither run resumes the other's.

    python -m rabbit_transcoding_tpu_torch.scripts.ladder_big --scene dense \\
        --frames 32 --gof 32 --out results/ladder_dense32_torch.csv
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from ..bitstream import V3CWriter
from ..core.gof import GroupOfFrames
from ..device import resolve
from ..encoder.encoder import Encoder
from ..encoder.params import EncoderParameters
from ..testdata import SCENES
from .ladder import DELTA_HEADER, MODES, RATES, run_cell

HEADER = "scene;rate;mode;stream_bytes;bpp;d1_psnr;d2_psnr;y_psnr;cell_s"


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="dense")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--points", type=int, default=0,
                    help="0 = the scene's own default density")
    ap.add_argument("--gof", type=int, default=32)
    ap.add_argument("--out", default="results/ladder_dense32_torch.csv")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "rabbit_torch_ladder_big"))
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a "
                         "GPU) or cpu")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    device = resolve(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    t0 = time.time()
    kw = {"n": args.points} if args.points else {}
    sources = [SCENES[args.scene](i, **kw) for i in range(args.frames)]
    total_points = sum(s.point_count for s in sources)
    log(f"{args.scene}: {args.frames} frames, "
        f"{sources[0].point_count}..{sources[-1].point_count} pts/frame "
        f"({time.time() - t0:.0f}s)")

    tag = f"{args.scene}_{args.frames}f_{args.gof}g{args.points or 'def'}"
    hq_path = os.path.join(args.workdir, f"hq_{tag}.bin")
    if os.path.exists(hq_path):
        with open(hq_path, "rb") as f:
            hq = f.read()
        log(f"hq encode cached: {hq_path} ({len(hq)} bytes)")
    else:
        t1 = time.time()
        enc = Encoder(EncoderParameters(
            minimumImageWidth=1024, minimumImageHeight=256,
            geometryQP=8, attributeQP=12, occupancyPrecision=2,
            frameCount=args.frames, groupOfFramesSize=args.gof,
        ), device)
        context, _ = enc.encode(GroupOfFrames(sources))
        writer = V3CWriter()
        hq = writer.write(writer.encode(context))
        tmp = hq_path + ".part"
        with open(tmp, "wb") as f:
            f.write(hq)
        os.replace(tmp, hq_path)
        log(f"hq encode: {len(hq)} bytes in {time.time() - t1:.0f}s")

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                parts = line.strip().split(";")
                if len(parts) >= 3 and parts[1] in RATES:
                    done.add((parts[1], parts[2]))
        log(f"resume: {len(done)} cells already in {args.out}")
    else:
        with open(args.out, "w") as f:
            f.write(HEADER + "\n")

    for rate, qps in RATES.items():
        for mode in modes:
            if (rate, mode) in done:
                continue
            t1 = time.time()
            out, _, m = run_cell(hq, sources, qps, mode, device)
            cell_s = time.time() - t1
            row = (f"{args.scene};{rate};{mode};{len(out)};"
                   f"{8 * len(out) / total_points:.4f};{m.d1_psnr:.4f};"
                   f"{m.d2_psnr:.4f};{m.color_psnr[0]:.4f};{cell_s:.0f}")
            with open(args.out, "a") as f:
                f.write(row + "\n")
            log(f"  {rate}/{mode}: D1 {m.d1_psnr:.3f} dB, "
                f"{len(out)} B, {cell_s:.0f}s")

    # delta summary (reencode is the in-family anchor); bars: auto D1
    # delta <= 0.05 dB AND Y delta <= 0.1 dB
    rows = {}
    yrows = {}
    with open(args.out) as f:
        for line in f:
            parts = line.strip().split(";")
            if len(parts) >= 8 and parts[1] in RATES:
                rows[(parts[1], parts[2])] = float(parts[5])
                yrows[(parts[1], parts[2])] = float(parts[7])
    print(DELTA_HEADER)
    nan = float("nan")
    for rate in RATES:
        base = rows.get((rate, "reencode"))
        rq = rows.get((rate, "requant"))
        au = rows.get((rate, "auto"))
        if base is None:
            continue
        ybase = yrows[(rate, "reencode")]
        yrq = yrows.get((rate, "requant"))
        yau = yrows.get((rate, "auto"))
        print(f"{args.scene};{rate};{base:.4f};"
              f"{rq if rq is not None else nan:.4f};"
              f"{(base - rq) if rq is not None else nan:+.4f};"
              f"{au if au is not None else nan:.4f};"
              f"{(base - au) if au is not None else nan:+.4f};"
              f"{ybase:.4f};"
              f"{yrq if yrq is not None else nan:.4f};"
              f"{(ybase - yrq) if yrq is not None else nan:+.4f};"
              f"{yau if yau is not None else nan:.4f};"
              f"{(ybase - yau) if yau is not None else nan:+.4f}",
              flush=True)
    log(f"total {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
