"""Single-map pixel interleaving (asps_pixel_deinterleaving_flag), as torch
ops.

Port of ``rabbit_transcoding_tpu/ops/interleave.py``: both depth maps ride
ONE video, checkerboarded by pixel parity: (x + y) even carries map 0, odd
carries map 1.  The missing map value at a pixel is interpolated from its
horizontal neighbours, which by construction carry exactly the needed map.
All integer.
"""

from __future__ import annotations

import torch


def _parity0(h: int, w: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return ((yy + xx) % 2) == 0


def interleave_maps(m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """(F, H, W) x2 -> (F, H, W): even-parity pixels from map 0, odd from
    map 1."""
    par0 = _parity0(m0.shape[1], m0.shape[2], m0.device)
    return torch.where(par0[None], m0, m1)


def deinterleave_maps(
    plane: torch.Tensor,
    occ: torch.Tensor | None = None,
    thickness: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, H, W) interleaved -> (map0, map1), of ``plane``'s dtype.

    The missing map at (x, y) interpolates from the (x-1, y) and (x+1, y)
    samples: opposite parity, i.e. exactly the needed map.  With ``occ``
    only occupied neighbours contribute; with ``thickness`` (geometry
    planes) the result clamps to the coded sample +/- surfaceThickness.
    Encoder closed loop and decoder MUST pass the same arguments."""
    f, h, w = plane.shape
    p = plane.to(torch.int32)
    left = torch.roll(p, 1, dims=2)
    right = torch.roll(p, -1, dims=2)
    xx = torch.arange(w, device=plane.device)
    # the rolled-in column at either edge is masked
    has_l = (xx > 0)[None, None, :].expand(p.shape)
    has_r = (xx < w - 1)[None, None, :].expand(p.shape)
    if occ is not None:
        # only OCCUPIED neighbours contribute (an unoccupied neighbour
        # holds background fill, not the missing map's depth)
        ob = occ.to(torch.bool)
        has_l = has_l & torch.roll(ob, 1, dims=2)
        has_r = has_r & torch.roll(ob, -1, dims=2)
    cnt = has_l.to(torch.int32) + has_r.to(torch.int32)
    s = torch.where(has_l, left, 0) + torch.where(has_r, right, 0)
    # no usable neighbour: duplicate the own-parity sample (a same-position
    # point; remove-duplicates folds it)
    interp = torch.where(
        cnt > 0,
        torch.div(s, cnt.clamp(min=1), rounding_mode="floor"), p)
    if thickness is not None:
        # the missing map stays within surfaceThickness of the coded one
        interp = torch.minimum(torch.maximum(interp, p - thickness),
                               p + thickness)
    par0 = _parity0(h, w, plane.device)[None]
    m0 = torch.where(par0, p, interp)
    m1 = torch.where(par0, interp, p)
    return m0.to(plane.dtype), m1.to(plane.dtype)
