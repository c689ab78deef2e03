"""Colour conversion, the decoder's half: BT.709 YUV -> RGB, 420 -> 444.

Port of ``rabbit_transcoding_tpu/ops/color.py`` (``yuv709_to_rgb``,
``upsample_chroma``, ``yuv420_to_rgb8``, ``yuv16_to_rgb8``) as torch ops over
(frames, H, W) planes, float32 throughout.  BT.709 matrix coefficients per
Rec. ITU-R BT.709-6 (Kr = 0.2126, Kb = 0.0722).

The bytes equal the reference's on the CPU because each float step rounds
where the reference's compiled code rounds:

* the normalisation ``x / 255`` and the chroma up-filter run op by op in the
  reference (a true division; every product and every sum rounded);
* ``yuv709_to_rgb`` is one compiled program there: ``r = fma(c_r, v, y)``,
  ``b = fma(c_b, u, y)``, ``g = fma(-Kb, b, fma(-Kr, r, y)) * (1 / Kg)``:
  the multiply-adds round once and the division by Kg is a product with
  the float32 reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from .rbv_tools import fma, scalar

_KR, _KB = 0.2126, 0.0722
_KG = 1.0 - _KR - _KB


def _f32(x: float) -> float:
    return float(np.float32(x))


_C_R = _f32(2.0 * (1.0 - _KR))
_C_B = _f32(2.0 * (1.0 - _KB))
_INV_KG = _f32(1.0 / _f32(_KG))


def yuv709_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """[0,1] Y and [0,1] U/V (full range, 0.5 = neutral) -> r, g, b."""
    u = u - 0.5
    v = v - 0.5
    r = fma(v, _C_R, y)
    b = fma(u, _C_B, y)
    g = fma(b, -_f32(_KB), fma(r, -_f32(_KR), y)) * _INV_KG
    return r, g, b


# 420->444 bank (g_filter420to444): even output samples are co-sited copies;
# odd samples use the halfway (phase-1/2) kernel of each entry.
_UP_FILTERS: dict[int | str, list[float] | None] = {
    0: [-16, 144, 144, -16],                              # UF_F0
    3: [6, -34, 156, 156, -34, 6],                        # UF_LS3
    4: [-3, 15, -43, 159, 159, -43, 15, -3],              # UF_LS4
    5: [21, -52, 159, 159, -52, 21],                      # UF_TM
    "nearest": None,                                      # sample repeat
}


def _conv_up_1d(p: torch.Tensor, kern: list[float] | None,
                axis: int) -> torch.Tensor:
    """Upsample-by-2 along ``axis``: even outputs copy the co-sited sample;
    odd outputs interpolate with the halfway kernel (edge replication).
    Each product and each sum rounds on its own, in tap order."""
    n = p.shape[axis]
    if kern is None:  # nearest
        return p.repeat_interleave(2, dim=axis)
    w = np.asarray(kern, np.float32)
    w /= w.sum()
    off = len(w) // 2 - 1  # halfway kernel is even-length by construction
    idx = torch.arange(-off, n + len(w) - 1 - off, device=p.device).clamp(
        0, n - 1)
    padded = p.index_select(axis, idx)
    odd = None
    for k, wk in enumerate(w):
        term = float(wk) * padded.narrow(axis, k, n)
        odd = term if odd is None else odd + term
    return torch.stack([p, odd], dim=axis + 1).reshape(
        *p.shape[:axis], 2 * n, *p.shape[axis + 1:])


def upsample_chroma(p: torch.Tensor, filt: int | str = 0) -> torch.Tensor:
    """(F, H/2, W/2) float chroma -> (F, H, W) with the selected filter."""
    kern = _UP_FILTERS[filt]
    return _conv_up_1d(_conv_up_1d(p, kern, axis=1), kern, axis=2)


def _to_rgb8(r, g, b) -> torch.Tensor:
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)


def yuv420_to_rgb8(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   up_filter: int | str = 0) -> torch.Tensor:
    """uint8 planes -> (F, H, W, 3) uint8 RGB.  up_filter selects the
    420->444 bank entry (default UF_F0, the choice the encoder's closed loop
    makes too)."""
    d = scalar(255.0, y.device)
    yf = y.to(torch.float32) / d
    uf = upsample_chroma(u.to(torch.float32) / d, up_filter)[
        :, : y.shape[1], : y.shape[2]]
    vf = upsample_chroma(v.to(torch.float32) / d, up_filter)[
        :, : y.shape[1], : y.shape[2]]
    return _to_rgb8(*yuv709_to_rgb(yf, uf, vf))


def yuv16_to_rgb8(yuv: torch.Tensor) -> torch.Tensor:
    """(N, 3) 16-bit YUV (full range; an integer tensor holding 0..65535) ->
    (N, 3) uint8 RGB."""
    x = yuv.to(torch.float32) / scalar(65535.0, yuv.device)
    return _to_rgb8(*yuv709_to_rgb(x[..., 0], x[..., 1], x[..., 2]))
