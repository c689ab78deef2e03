"""Background fill (dilation, push-pull, harmonic) of geometry and
attribute planes.

Port of ``rabbit_transcoding_tpu/ops/dilate.py``: unoccupied atlas pixels
are filled with values that compress well and do not bleed across patch
edges.  ``push_pull_fill`` fills from a masked mipmap pyramid (the
transcoder fills a lossless input this way before its first quantisation);
the encoder also runs ``dilate`` (mean of the occupied 4-neighbours, pass by
pass), ``harmonic_fill`` (Jacobi sweeps from the push-pull start),
``background_fill`` (its dispatch by ``attributeBGFill``) and
``group_dilation`` (host numpy, the shared background of a map pair).

Numerics.  From the second pyramid level on the values are means, so the
order in which a 2x2 masked sum adds its four terms decides the bits.  XLA's
CPU code adds them in row-major order, ``((x00 + x01) + x10) + x11``;
``_down2`` spells that order out, so that the same bits come out on any
device.  ``dilate`` and ``harmonic_fill`` add the four neighbours in the
reference's order too, ``((up + down) + left) + right``.
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


def _four_neighbours(x: torch.Tensor, mode: str) -> torch.Tensor:
    """((up + down) + left) + right of every pixel of (F, H, W) ``x``, the
    border padded with zeros (``mode="constant"``) or the edge value
    (``"replicate"``)."""
    p = torch.nn.functional.pad(x[:, None], (1, 1, 1, 1), mode=mode)[:, 0]
    return ((p[:, :-2, 1:-1] + p[:, 2:, 1:-1]) + p[:, 1:-1, :-2]
            + p[:, 1:-1, 2:])


def dilate(img: torch.Tensor, occ: torch.Tensor,
           iterations: int = 2) -> torch.Tensor:
    """Iterative dilation (PCCEncoder::dilate analog): each pass fills the
    empty pixels of (F, H, W) ``img`` that have occupied 4-neighbours with
    their mean -> float32 (F, H, W)."""
    v = img.to(torch.float32)
    m = (occ > 0).to(torch.float32)
    for _ in range(iterations):
        s = _four_neighbours(v * m, "constant")
        c = _four_neighbours(m, "constant")
        newly = (m == 0) & (c > 0)
        v = torch.where(newly, s / torch.clamp(c, min=1.0), v)
        m = torch.maximum(m, newly.to(torch.float32))
    return v


def harmonic_fill(img: torch.Tensor, occ: torch.Tensor,
                  iterations: int = 24) -> torch.Tensor:
    """dilateHarmonicBackgroundFill analog: the Laplace equation over the
    unoccupied pixels with the occupied ones as the boundary, from the
    push-pull fill relaxed by Jacobi sweeps -> float32 (F, H, W)."""
    mask = occ > 0
    val = img.to(torch.float32)
    v = push_pull_fill(img, occ)
    for _ in range(iterations):
        v = torch.where(mask, val, 0.25 * _four_neighbours(v, "replicate"))
    return v


def background_fill(planes: np.ndarray, occ: np.ndarray, mode: int,
                    device: torch.device | str = "cuda") -> np.ndarray:
    """attributeBGFill / geometry fill dispatch: 0 = iterative dilate, 1 =
    push-pull (default), 2 = harmonic background fill, >= 3 = no padding.
    ``planes`` / ``occ``: (F, H, W) host arrays; the fill runs on
    ``device`` -> float32 (F, H, W) on the host."""
    if mode >= 3:
        return planes.astype("float32")
    ppad, opad, (oh, ow) = pad_pow2(planes.astype("float32"), occ)
    jp = torch.from_numpy(np.ascontiguousarray(ppad)).to(device)
    jo = torch.from_numpy(np.ascontiguousarray(opad)).to(device)
    if mode == 0:
        out = dilate(jp, jo, iterations=8)
    elif mode == 2:
        out = harmonic_fill(jp, jo)
    else:
        out = push_pull_fill(jp, jo)
    return out.cpu().numpy()[:, :oh, :ow]


def group_dilation(filled, occ, n_maps: int):
    """Group dilation: with interleaved dual-map video, both maps'
    background pixels take the rounded average of the pair, so the D1/T1
    frame predicts its background from D0/T0 for free.  filled:
    (F*n_maps, H, W[,C]) float; occ: (F, H, W) of the shared occupancy.
    In place; returns filled."""
    if n_maps != 2:
        return filled
    if not getattr(filled.flags, "writeable", True):
        filled = filled.copy()
    bg = occ == 0
    d0 = np.round(filled[0::2])
    d1 = np.round(filled[1::2])
    avg = np.floor((d0 + d1 + 1.0) / 2.0)
    if filled.ndim == 4:
        bg = bg[..., None] & np.ones(filled.shape[-1], bool)
    filled[0::2] = np.where(bg, avg, filled[0::2])
    filled[1::2] = np.where(bg, avg, filled[1::2])
    return filled


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
