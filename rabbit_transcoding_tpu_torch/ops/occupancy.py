"""Occupancy-map scaling: the transcoder's max-pool downscale and the
nearest-neighbour upsample of ``rabbit_transcoding_tpu/ops/occupancy.py``,
as torch ops over (frames, H, W)."""

from __future__ import annotations

import torch


def downscale_maxpool(occ: torch.Tensor, factor: int) -> torch.Tensor:
    """(F, H, W) -> (F, H/f, W/f) max-pool.  Max (not mean) keeps any
    occupied pixel.  H and W must be multiples of ``factor``."""
    f, h, w = occ.shape
    x = occ.reshape(f, h // factor, factor, w // factor, factor)
    return x.amax(dim=(2, 4))


def upsample_nearest(occ: torch.Tensor, factor: int) -> torch.Tensor:
    """(F, h, w) -> (F, h*f, w*f) nearest-neighbour upsample."""
    return occ.repeat_interleave(factor, dim=1).repeat_interleave(factor,
                                                                  dim=2)



_OM_KERNEL = ((12, 28, 12), (28, 96, 28), (12, 28, 12))


def prefilter_lossy_om(planes: torch.Tensor) -> torch.Tensor:
    """3x3 smoothing prefilter over the lossy occupancy video (kernel
    {12,28,12; 28,96,28; 12,28,12}, >> 8, edge clamp), int32 inside ->
    uint8."""
    h, w = planes.shape[1], planes.shape[2]
    x = planes.to(torch.int32)
    # edge replication by index, exact for integers
    ys = torch.arange(-1, h + 1, device=planes.device).clamp(0, h - 1)
    xs = torch.arange(-1, w + 1, device=planes.device).clamp(0, w - 1)
    x = x[:, ys][:, :, xs]
    out = torch.zeros(planes.shape, dtype=torch.int32, device=planes.device)
    for dy in range(3):
        for dx in range(3):
            out = out + _OM_KERNEL[dy][dx] * x[:, dy:dy + h, dx:dx + w]
    return (out >> 8).to(torch.uint8)


def binarize(occ: torch.Tensor, threshold: int = 0) -> torch.Tensor:
    """Occupancy video plane -> binary uint8 map (the lossy-occupancy
    threshold, oi_lossy_occupancy_compression_threshold)."""
    return (occ > threshold).to(torch.uint8)


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``x`` moved by (dy, dx) over its last two axes, the vacated band set
    to ``fill`` (the reference rolls and masks the wrap band)."""
    out = torch.full_like(x, fill)
    h, w = x.shape[-2:]
    ys, yd = ((slice(0, h - dy), slice(dy, h)) if dy >= 0
              else (slice(-dy, h), slice(0, h + dy)))
    xs, xd = ((slice(0, w - dx), slice(dx, w)) if dx >= 0
              else (slice(-dx, w), slice(0, w + dx)))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def pbf_refine(
    occ: torch.Tensor,        # (F, H, W) bool/uint8 (precision-upsampled)
    geo: torch.Tensor,        # (F, H, W) decoded near-layer geometry
    owner: torch.Tensor,      # (F, H, W) int32 pixel patch ownership (0 = none)
    threshold: float,         # depth deviation beyond which a rim pixel drops
    passes: int = 2,
    radius: int = 1,
) -> torch.Tensor:
    """Patch-border filtering (occupancy synthesis SEI): each pass drops
    BOUNDARY pixels whose depth deviates more than ``threshold`` from the
    windowed mean of SAME-PATCH interior pixels.  -> (F, H, W) bool.

    The window sums add integers times 0/1 in float32 and are exact; the
    division and the compare are the reference's."""
    o = occ.to(torch.bool)
    g = geo.to(torch.float32)
    owner = owner.to(torch.int32)
    thr = torch.tensor(threshold, dtype=torch.float32, device=occ.device)
    one = torch.tensor(1.0, dtype=torch.float32, device=occ.device)
    offsets = [
        (dy, dx)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
        if (dy, dx) != (0, 0)
    ]
    for _ in range(passes):
        # interior = occupied with all 4 neighbours occupied AND of the same
        # patch (a seam between two tightly packed patches is a border)
        interior = o
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            interior = interior & _shift(o, dy, dx, False) & (
                _shift(owner, dy, dx, -1) == owner)
        boundary = o & ~interior
        num = torch.zeros_like(g)
        den = torch.zeros_like(g)
        for dy, dx in offsets:
            sup = (_shift(interior, dy, dx, False)
                   & (_shift(owner, dy, dx, 0) == owner)).to(torch.float32)
            num = num + sup * _shift(g, dy, dx, 0.0)
            den = den + sup
        ref = num / torch.maximum(den, one)
        bad = boundary & (den > 0) & (torch.abs(g - ref) > thr)
        o = o & ~bad
    return o
