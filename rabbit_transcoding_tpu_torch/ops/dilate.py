"""Push-pull background fill of geometry and attribute planes.

Port of ``push_pull_fill`` (with ``_down2`` and ``_up2``) and ``pad_pow2``
of ``rabbit_transcoding_tpu/ops/dilate.py``: unoccupied atlas pixels are
filled from a masked mipmap pyramid, so that they compress well and do not
bleed across patch edges.  The transcoder fills a lossless input this way
before its first quantisation.

Numerics.  From the second pyramid level on the values are means, so the
order in which a 2x2 masked sum adds its four terms decides the bits.  XLA's
CPU code adds them in row-major order, ``((x00 + x01) + x10) + x11``;
``_down2`` spells that order out, so that the same bits come out on any
device.
"""

from __future__ import annotations

import numpy as np
import torch


def _sum2x2(x: torch.Tensor) -> torch.Tensor:
    """(F, H, W) -> (F, H/2, W/2): each 2x2 cell summed in row-major
    order."""
    return ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2]) + x[:, 1::2, 0::2]
            + x[:, 1::2, 1::2])


def _down2(val: torch.Tensor, wgt: torch.Tensor):
    """Masked 2x2 reduction -> (sum of val * wgt, sum of wgt), halved."""
    return _sum2x2(val * wgt), _sum2x2(wgt)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def push_pull_fill(img: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Fill the unoccupied pixels of (F, H, W) ``img`` from a masked mipmap
    pyramid -> float32 (F, H, W); occupied pixels (``occ > 0``) keep their
    values.  H and W must be powers of two (``pad_pow2`` first)."""
    _, h, w = img.shape
    val = img.to(torch.float32)
    wgt = (occ > 0).to(torch.float32)

    # push: the masked pyramid down to 1 x 1 along the shorter side
    levels = []
    v, m = val, wgt
    size = min(h, w)
    while size > 1:
        levels.append((v, m))
        v, m = _down2(v, m)
        v = torch.where(m > 0, v / torch.clamp(m, min=1.0), 0.0)
        m = (m > 0).to(torch.float32)
        size //= 2
    levels.append((v, m))

    # pull: fill the holes of each level from the next coarser one
    fill_v, fill_m = levels[-1]
    fill = torch.where(fill_m > 0, fill_v, 0.0)
    for v, m in reversed(levels[:-1]):
        fill = torch.where(m > 0, v, _up2(fill))
    return torch.where(wgt > 0, val, fill)


def pad_pow2(x: np.ndarray, occ: np.ndarray):
    """Zero-pad the trailing dims of (F, H, W) host arrays up to powers of
    two (for ``push_pull_fill``) -> (padded x, padded occ, (H, W))."""
    f, h, w = x.shape
    h2 = 1 << (h - 1).bit_length()
    w2 = 1 << (w - 1).bit_length()
    if h2 == h and w2 == w:
        return x, occ, (h, w)
    xp = np.zeros((f, h2, w2), x.dtype)
    op = np.zeros((f, h2, w2), occ.dtype)
    xp[:, :h, :w] = x
    op[:, :h, :w] = occ
    return xp, op, (h, w)
