"""RBV inter-coding RD study on the PyTorch port.

Twin of the repo's ``scripts/rbv_rd.py``: bytes + PSNR of the RBV codec over
realistic V-PCC atlas video (geometry + attribute planes produced by the
real encoder pipeline) and a translating texture, for GOP sizes 1/2/4/8
with motion compensation on/off across a QP ladder, with BD-rate against
the gop=2 no-MC anchor.  ``RBV_RD_DEBLOCK_AB=1``, ``RBV_RD_THRESHOLD_AB=1``
and ``RBV_RD_INTRA_AB=1`` run the deblocking, coefficient-threshold and
intra-prediction A/Bs instead.  Every encode runs on ``--device`` (the card
unless the caller asks for the CPU; no card raises).

    python -m rabbit_transcoding_tpu_torch.scripts.rbv_rd [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..device import resolve


def psnr(a: np.ndarray, b: np.ndarray, maxval: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(maxval**2 / mse)


def bd_rate(anchor: list[tuple[float, float]],
            test: list[tuple[float, float]]) -> float:
    """Bjontegaard delta-rate (%) between (bits, psnr) ladders: average
    horizontal gap of the log-rate-vs-PSNR curves over the common PSNR
    interval (cubic fit, the standard formulation)."""
    ra, pa = np.log10([r for r, _ in anchor]), [p for _, p in anchor]
    rt, pt = np.log10([r for r, _ in test]), [p for _, p in test]
    fa = np.polyfit(pa, ra, 3)
    ft = np.polyfit(pt, rt, 3)
    lo, hi = max(min(pa), min(pt)), min(max(pa), max(pt))
    ia = np.polyint(fa)
    it = np.polyint(ft)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float((10 ** (avg_t - avg_a) - 1) * 100)


def make_atlas_video(frames: int = 8, device="cuda"):
    """Realistic test content: the actual geometry + attribute videos the
    V-PCC encoder produces (patch layout + push-pull padding), recovered
    by decoding a near-lossless encode's video payloads."""
    from ..core.gof import GroupOfFrames
    from ..encoder.encoder import Encoder
    from ..encoder.params import EncoderParameters
    from ..testdata import make_frame
    from ..utils.enums import CodecId, VideoType
    from ..video import VideoDecoder

    sources = GroupOfFrames([make_frame(i, n=30000) for i in range(frames)])
    enc = Encoder(EncoderParameters(
        minimumImageWidth=512, minimumImageHeight=128,
        geometryQP=4, attributeQP=4, occupancyPrecision=2,
    ), device)
    context, _ = enc.encode(sources)
    atlas = context.atlas(0)
    dec = VideoDecoder.create(CodecId.RBV, device)
    geo = dec.decode(atlas.video_bitstreams[VideoType.GEOMETRY].data)
    attr = dec.decode(atlas.video_bitstreams[VideoType.ATTRIBUTE].data)
    return geo, attr


def moving_texture():
    """Genuinely translating texture (4 px/frame), 256x256x8, 10-bit: where
    motion compensation must win (it cannot win on position-stable atlas
    video, whose optimal MV is zero everywhere)."""
    from scipy.ndimage import gaussian_filter

    from ..core.image import Video
    from ..utils.enums import ColorFormat

    rng = np.random.default_rng(0)
    h = w = 256
    f = 8
    base = gaussian_filter(
        rng.normal(size=(h + f * 4, w + f * 4)), 4
    ) * 400 + 500
    return Video(w, h, 10, ColorFormat.YUV400, [np.stack([
        np.clip(base[4 * i:4 * i + h, 4 * i:4 * i + w], 0, 1023).astype(
            np.uint16
        )
        for i in range(f)
    ])])


def ladder(video, qps, gop: int, motion: bool, deblock: bool = True,
           device="cuda"):
    from ..video import rbv

    maxval = (1 << video.bitdepth) - 1
    points = []
    for qp in qps:
        payload, recon = rbv.encode(
            video, rbv.RbvParams(qp=qp, gop_size=gop, motion=motion,
                                 deblock=deblock), device
        )
        p = np.mean([
            psnr(a, b, maxval) for a, b in zip(video.planes, recon.planes)
        ])
        points.append((len(payload), float(p)))
    return points


def threshold_ab(contents, qps, device="cuda"):
    """Coefficient-threshold BD-rate A/B (RbvParams.coeff_threshold)."""
    from ..video import rbv

    print("\n=== coeff_threshold BD-rate (anchor: thr off) ===")
    for name, video in contents:
        maxval = (1 << video.bitdepth) - 1
        for thr in (8, 16, 32):
            pts = {0: [], thr: []}
            for t in pts:
                for qp in qps:
                    payload, recon = rbv.encode(video, rbv.RbvParams(
                        qp=qp, gop_size=2, coeff_threshold=t), device)
                    p = np.mean([psnr(a, b, maxval) for a, b in
                                 zip(video.planes, recon.planes)])
                    pts[t].append((len(payload), float(p)))
            bd = bd_rate(pts[0], pts[thr])
            dp = np.mean([a[1] - b[1] for a, b in zip(pts[thr], pts[0])])
            print(f"{name:14s} thr>={thr:2d} BD-rate {bd:+7.2f}%  "
                  f"avg dPSNR {dp:+.3f} dB")


def intra_ab(contents, qps, device="cuda"):
    """Intra-prediction BD-rate A/B (RbvParams.intra: mosaic DC/planar on
    I-frames)."""
    from ..video import rbv

    print("\n=== intra prediction BD-rate (anchor: intra OFF) ===")
    for name, video in contents:
        maxval = (1 << video.bitdepth) - 1
        for gop, motion in ((1, False), (2, False), (2, True), (4, True)):
            pts = {False: [], True: []}
            for use_intra in pts:
                for qp in qps:
                    payload, recon = rbv.encode(video, rbv.RbvParams(
                        qp=qp, gop_size=gop, motion=motion,
                        intra=use_intra), device)
                    p = np.mean([psnr(a, b, maxval) for a, b in
                                 zip(video.planes, recon.planes)])
                    pts[use_intra].append((len(payload), float(p)))
            bd = bd_rate(pts[False], pts[True])
            dp = np.mean([a[1] - b[1] for a, b in
                          zip(pts[True], pts[False])])
            label = f"gop{gop}{'+mc' if motion else ''}"
            print(f"{name:14s} {label:8s} BD-rate {bd:+7.2f}%  "
                  f"avg dPSNR {dp:+.3f} dB")


def deblock_ab(contents, qps, device="cuda"):
    """In-loop deblocking BD-rate A/B: same configs with the filter off
    (anchor) vs on."""
    print("\n=== in-loop deblocking BD-rate (anchor: deblock OFF) ===")
    for name, video in contents:
        for gop, motion in ((1, False), (4, False), (4, True)):
            off = ladder(video, qps, gop, motion, deblock=False,
                         device=device)
            on = ladder(video, qps, gop, motion, deblock=True, device=device)
            bd = bd_rate(off, on)
            label = f"gop{gop}{'+mc' if motion else ''}"
            avg_dpsnr = np.mean([a[1] - b[1] for a, b in zip(on, off)])
            print(f"{name:14s} {label:8s} BD-rate {bd:+7.2f}%  "
                  f"avg dPSNR {avg_dpsnr:+.3f} dB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; raises without a "
                         "GPU) or cpu")
    device = resolve(ap.parse_args(argv).device)
    qps = [16, 22, 28, 34]
    geo, attr = make_atlas_video(device=device)
    print(f"content: geometry {geo.width}x{geo.height}x{geo.frame_count} "
          f"{geo.bitdepth}bit; attribute {attr.width}x{attr.height} "
          f"{attr.bitdepth}bit", file=sys.stderr)

    contents = (("geometry", geo), ("attribute", attr),
                ("moving-texture", moving_texture()))
    if os.environ.get("RBV_RD_DEBLOCK_AB", "0") == "1":
        deblock_ab(contents, qps, device)
        return 0
    if os.environ.get("RBV_RD_THRESHOLD_AB", "0") == "1":
        threshold_ab(contents, qps, device)
        return 0
    if os.environ.get("RBV_RD_INTRA_AB", "0") == "1":
        intra_ab(contents, qps, device)
        return 0

    configs = [(g, m) for g in (1, 2, 4, 8) for m in (False, True)
               if not (g == 1 and m)]
    for name, video in contents:
        results = {}
        for gop, motion in configs:
            results[(gop, motion)] = ladder(video, qps, gop, motion,
                                            device=device)
        anchor = results[(2, False)]
        print(f"\n=== {name} ===")
        print(f"{'config':14s} " + " ".join(
            f"qp{q}: bytes/psnr" for q in qps
        ))
        for (gop, motion), pts in results.items():
            label = f"gop{gop}{'+mc' if motion else '    '}"
            row = " ".join(f"{r:7d}/{p:6.2f}" for r, p in pts)
            bd = bd_rate(anchor, pts) if (gop, motion) != (2, False) else 0.0
            print(f"{label:14s} {row}  BD-rate {bd:+6.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
