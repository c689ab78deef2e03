"""Frames/s against device count for the sharded multi-stream transcode on
the PyTorch port.

Twin of the repo's ``scripts/scaling.py``: the same 8 payloads (128x128,
8 frames, 10-bit, QP 16-22, every other one motion-compensated, GOP 4)
through ``transcode_payloads(..., 32, mesh=...)`` at each device count, one
warm-up and the fastest of 3 timed rounds, and the same CSV columns.  A
``Mesh`` of the first ``n`` devices replaces the reference's fresh
subprocess per count.  When ``n`` exceeds the visible cards the mesh is
virtual (card 0 listed ``n`` times, as ``parallel/mesh.py`` allows; always
so for ``--device cpu``): a virtual mesh shares one device, so its wall
cannot improve with ``n``.  The CSV's caveat lines say which rows are real
cards and which are virtual.

    python -m rabbit_transcoding_tpu_torch.scripts.scaling \\
        [--counts 1,2,4,8] [--out results/scaling_torch.csv] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.image import Video
from ..device import resolve
from ..parallel.mesh import make_mesh
from ..parallel.multistream import transcode_payloads
from ..utils.enums import ColorFormat
from ..video import rbv

N_PAYLOADS, FRAMES = 8, 8


def payload(qp: int, mc: bool, device="cuda") -> bytes:
    """One input stream of the measurement (the reference's recipe)."""
    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.stack([
        (300 + 200 * np.sin((xx + yy) / 9.0 + i)).astype(np.uint16)
        for i in range(FRAMES)
    ])
    v = Video(w, h, 10, ColorFormat.YUV400, [frames])
    return rbv.encode(v, rbv.RbvParams(qp=qp, gop_size=4, motion=mc),
                      device)[0]


def payloads(device="cuda") -> list[bytes]:
    return [payload(16 + 2 * (i % 4), mc=(i % 2 == 1), device=device)
            for i in range(N_PAYLOADS)]


def mesh_devices(n: int, device) -> tuple[list[torch.device], bool]:
    """The first ``n`` cards, or ``device`` listed ``n`` times when there
    are fewer (or it is the CPU) -> (devices, virtual)."""
    dev = resolve(device)
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return [torch.device("cuda", i) for i in range(n)], False
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return [dev] * n, True


def measure(n: int, pays: list[bytes], device="cuda") -> dict:
    devices, virtual = mesh_devices(n, device)
    mesh = make_mesh(devices)
    total_frames = FRAMES * len(pays)
    transcode_payloads(pays, 32, mesh=mesh)  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        transcode_payloads(pays, 32, mesh=mesh)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    return {
        "devices": n,
        "mesh_shape": list(mesh.shape),
        "wall_s": round(wall, 3),
        "fps_total": round(total_frames / wall, 2),
        "per_device_frame_share": round(total_frames / n, 1),
        "virtual": virtual,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", default="1,2,4,8")
    ap.add_argument("--out", default="results/scaling_torch.csv")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a "
                         "GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    pays = payloads(device)
    rows = []
    for n in (int(c) for c in args.counts.split(",")):
        rec = measure(n, pays, device)
        rows.append(rec)
        print(json.dumps(rec))
    real = [r["devices"] for r in rows if not r["virtual"]]
    virtual = [r["devices"] for r in rows if r["virtual"]]
    with open(args.out, "w") as f:
        f.write(f"# device {device}; rows on distinct cards: devices in "
                f"{real}; virtual rows (one device listed n times, so wall\n"
                f"# cannot improve with n; the signal is the per-device work "
                f"share dropping 1/N): devices in {virtual}.\n")
        f.write("devices;mesh_shape;wall_s;fps_total;"
                "per_device_frame_share\n")
        for r in rows:
            f.write(f"{r['devices']};{'x'.join(map(str, r['mesh_shape']))};"
                    f"{r['wall_s']};{r['fps_total']};"
                    f"{r['per_device_frame_share']}\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
