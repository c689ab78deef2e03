"""Endurance-run drift analysis (the metrics leg of ``endurance.sh``) on the
PyTorch port.

Twin of the repo's ``scripts/endurance_metrics.py``.  Measures what "drift
over 300 frames" means for a PER-GOF transcoder (each GOF is transcoded
from a fresh context and hash-SEI verified, so cross-GOF state cannot
leak).  Samples the first (I) and deepest (last-P) frame of every GOF and
computes three D1 levels per sample:

 * ``hq``  — source vs the hq decode (``hqdec_%04d.ply``): the encoder
   baseline, which itself swings with content phase;
 * ``e2e`` — source vs the transcoded decode (reported, not asserted);
 * ``transcode-added`` — hq decode vs transcoded decode: the error the
   transcode ADDED, the pure transcoder-drift signal.

Asserts (transcoder properties only):
 * transcode-added D1 spread < 3 dB and slope >= -0.005 dB/frame;
 * per-frame (hq - e2e) < 4 dB.

Rows cache to ``drift_metrics.csv`` in the workdir, so a rerun (or a
resumed endurance pass) skips already-computed frames.  The metrics are
the port's host float64 ones; ``--device`` is where their normals are
computed (the card unless the caller asks for the CPU; no card raises).

    python -m rabbit_transcoding_tpu_torch.scripts.endurance_metrics \\
        [--workdir DIR] [--gof 32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys

import numpy as np

from ..core.pointset import PointSet
from ..device import resolve
from ..metrics.metrics import MetricsParams, compute_metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=".")
    ap.add_argument("--gof", type=int, default=32)
    ap.add_argument("--cache", default="drift_metrics.csv")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the normals: cuda (the default; "
                         "raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    os.chdir(args.workdir)

    params = MetricsParams(resolution=1023)
    n = len(glob.glob("dec_*.ply"))
    gof = args.gof

    cache: dict[int, tuple[float, float, float]] = {}
    if os.path.exists(args.cache):
        with open(args.cache) as f:
            for row in csv.reader(f):
                cache[int(row[0])] = (float(row[1]), float(row[2]),
                                      float(row[3]))

    def d1(a, b):
        return compute_metrics(a, b, params, device=device).d1_psnr

    rows: list[tuple[int, str, float, float, float]] = []
    for g in range(0, n, gof):
        for pname, off in (("head", 0), ("tail", gof - 1)):
            i = min(g + off, n - 1)
            if i in cache:
                e2e, d_hq, d_add = cache[i]
            else:
                src = PointSet.read_ply(f"cloud_{i:04d}.ply")
                dec = PointSet.read_ply(f"dec_{i:04d}.ply")
                hq = PointSet.read_ply(f"hqdec_{i:04d}.ply")
                e2e, d_hq, d_add = d1(src, dec), d1(src, hq), d1(hq, dec)
                with open(args.cache, "a") as f:
                    csv.writer(f).writerow([i, e2e, d_hq, d_add])
            rows.append((i, pname, e2e, d_hq, d_add))
            print(
                f"frame {i:4d} [{pname}]: D1 e2e {e2e:8.4f} dB, "
                f"hq {d_hq:8.4f} dB, transcode-added {d_add:8.4f} dB",
                flush=True,
            )

    ok = True
    for pname in ("head", "tail"):
        d1s = np.array([r[2] for r in rows if r[1] == pname])
        print(
            f"phase {pname} (e2e, reported): {len(d1s)} GOFs, "
            f"D1 mean {d1s.mean():.4f} dB, spread "
            f"{d1s.max() - d1s.min():.4f} dB"
        )
    gaps = np.array([r[3] - r[2] for r in rows])
    print(f"hq - e2e gap: mean {gaps.mean():.4f} dB, max {gaps.max():.4f} dB")
    if gaps.max() >= 4.0:
        print(f"FAIL: transcode costs {gaps.max():.2f} dB vs its input "
              f"somewhere")
        ok = False
    idx = np.array([r[0] for r in rows], float)
    add = np.array([r[4] for r in rows])
    slope = float(np.polyfit(idx, add, 1)[0])
    spread = float(add.max() - add.min())
    print(
        f"transcode-added D1: mean {add.mean():.4f} dB, spread "
        f"{spread:.4f} dB, slope {slope:+.6f} dB/frame"
    )
    if spread >= 3.0:
        print(f"FAIL: transcode-added D1 spread {spread:.2f} >= 3 dB")
        ok = False
    if slope < -0.005:
        print(f"FAIL: transcode-added D1 falls {slope:.4f} dB/frame")
        ok = False
    print("drift check PASS" if ok else "drift check FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
