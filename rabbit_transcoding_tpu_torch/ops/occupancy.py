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

