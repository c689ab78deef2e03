"""Colour conversion: BT.709 RGB <-> YUV, 444 <-> 420.

Port of ``rabbit_transcoding_tpu/ops/color.py`` as torch ops over
(frames, H, W) planes, float32 throughout: the decoder's half
(``yuv709_to_rgb``, ``upsample_chroma``, ``yuv420_to_rgb8``,
``yuv16_to_rgb8``) and the encoder's (``rgb_to_yuv709``,
``downsample_chroma``, ``rgb8_to_yuv420``, ``rgb8_to_yuv420_patch_aware``).
BT.709 matrix coefficients per Rec. ITU-R BT.709-6 (Kr = 0.2126,
Kb = 0.0722).

The bytes equal the reference's on the CPU because each float step rounds
where the reference's compiled code rounds:

* the normalisation ``x / 255`` and the chroma up-filter run op by op in the
  reference (a true division; every product and every sum rounded);
* ``yuv709_to_rgb`` is one compiled program there: ``r = fma(c_r, v, y)``,
  ``b = fma(c_b, u, y)``, ``g = fma(-Kb, b, fma(-Kr, r, y)) * (1 / Kg)``:
  the multiply-adds round once and the division by Kg is a product with
  the float32 reciprocal;
* ``rgb_to_yuv709`` is one compiled program there too:
  ``y = fma(Kb, b, fma(Kr, r, Kg * g))``, and the chroma's
  ``0.5 * (b - y) / (1 - Kb) + 0.5`` is folded to ``fma(b - y, c_u, 0.5)``
  with ``c_u = f32(0.5 / (1 - Kb))`` (``v`` likewise with Kr);
* the normalisation, the chroma down-filter, the patch-aware masking and
  the conversion to 8 bits run op by op.
"""

from __future__ import annotations

import numpy as np
import torch

from .rbv_tools import fma, scalar

_KR, _KB = 0.2126, 0.0722
_KG = 1.0 - _KR - _KB


def _f32(x: float) -> float:
    return float(np.float32(x))


_C_U = _f32(np.float32(0.5) / np.float32(1.0 - _KB))
_C_V = _f32(np.float32(0.5) / np.float32(1.0 - _KR))
_C_R = _f32(2.0 * (1.0 - _KR))
_C_B = _f32(2.0 * (1.0 - _KB))
_INV_KG = _f32(1.0 / _f32(_KG))


def rgb_to_yuv709(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Normalised [0,1] RGB -> [0,1] Y, [-0.5,0.5]+0.5 U/V (full range)."""
    y = fma(b, _f32(_KB), fma(r, _f32(_KR), g * _f32(_KG)))
    u = fma(b - y, _C_U, 0.5)
    v = fma(r - y, _C_V, 0.5)
    return y, u, v


def yuv709_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """[0,1] Y and [0,1] U/V (full range, 0.5 = neutral) -> r, g, b."""
    u = u - 0.5
    v = v - 0.5
    r = fma(v, _C_R, y)
    b = fma(u, _C_B, y)
    g = fma(b, -_f32(_KB), fma(r, -_f32(_KR), y)) * _INV_KG
    return r, g, b


# 444->420 bank (g_filter444to420): per entry the horizontal kernel
# centred at the even column and the vertical kernel centred between the two
# rows.  Coefficients normalised to sum 1.
_DOWN_FILTERS: dict[int | str, tuple[list[float], list[float]]] = {
    0: ([64, 384, 64], [256, 256]),                       # DF_F0
    1: ([128, 256, 128], [256, 256]),                     # DF_F1
    2: ([21, 0, -52, 0, 159, 256, 159, 0, -52, 0, 21],    # DF_TM5
        [5, 11, -21, -37, 70, 228, 228, 70, -37, -21, 11, 5]),
    3: ([8, 0, -64, 128, 368, 128, -64, 0, 8],            # DF_FV
        [8, 0, -24, 48, 224, 224, 48, -24, 0, 8]),
    "box": ([256, 256], [256, 256]),                      # mean of 2x2
}
# 420->444 bank (g_filter420to444): even output samples are co-sited copies;
# odd samples use the halfway (phase-1/2) kernel of each entry.
_UP_FILTERS: dict[int | str, list[float] | None] = {
    0: [-16, 144, 144, -16],                              # UF_F0
    3: [6, -34, 156, 156, -34, 6],                        # UF_LS3
    4: [-3, 15, -43, 159, 159, -43, 15, -3],              # UF_LS4
    5: [21, -52, 159, 159, -52, 21],                      # UF_TM
    "nearest": None,                                      # sample repeat
}


def _down_taps(kern: list[float]) -> tuple[np.ndarray, int]:
    """The normalised float32 taps of a decimating kernel and its offset:
    odd kernels centre at the even sample, even kernels between the pair."""
    w = np.asarray(kern, np.float32)
    w /= w.sum()
    off = (len(w) - 1) // 2 if len(w) % 2 else len(w) // 2 - 1
    return w, off


def _edge_pad(p: torch.Tensor, axis: int, before: int,
              after: int) -> torch.Tensor:
    n = p.shape[axis]
    idx = torch.arange(-before, n + after, device=p.device).clamp(0, n - 1)
    return p.index_select(axis, idx)


def _every_other(p: torch.Tensor, axis: int, start: int,
                 n: int) -> torch.Tensor:
    """Samples start, start + 2, ... below start + n along ``axis``."""
    sl = [slice(None)] * p.dim()
    sl[axis] = slice(start, start + n, 2)
    return p[tuple(sl)]


def _conv_down_1d(p: torch.Tensor, kern: list[float],
                  axis: int) -> torch.Tensor:
    """Decimate by 2 along ``axis``: out[i] = sum_k w[k] * in[2i + k - off]
    with edge replication; each product and each sum rounds on its own, in
    tap order."""
    w, off = _down_taps(kern)
    n = p.shape[axis]
    padded = _edge_pad(p, axis, off, len(w) - 1 - off)
    out = None
    for k, wk in enumerate(w):
        term = float(wk) * _every_other(padded, axis, k, n)
        out = term if out is None else out + term
    return out


def downsample_chroma(p: torch.Tensor, filt: int | str = 1) -> torch.Tensor:
    """(F, H, W) float chroma -> (F, H/2, W/2) with the selected filter."""
    kh, kv = _DOWN_FILTERS[filt]
    return _conv_down_1d(_conv_down_1d(p, kh, axis=2), kv, axis=1)


def _to_u8(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(p * 255.0), 0, 255).to(torch.uint8)


def _normalised_yuv(rgb: torch.Tensor):
    x = rgb.to(torch.float32) / scalar(255.0, rgb.device)
    return rgb_to_yuv709(x[..., 0], x[..., 1], x[..., 2])


def rgb8_to_yuv420(rgb: torch.Tensor, down_filter: int | str = 1):
    """(F, H, W, 3) uint8 -> (y (F, H, W), u (F, H/2, W/2), v) uint8 planes.
    ``down_filter`` selects the 444->420 bank entry (default DF_F1)."""
    y, u, v = _normalised_yuv(rgb)
    return (_to_u8(y), _to_u8(downsample_chroma(u, down_filter)),
            _to_u8(downsample_chroma(v, down_filter)))


def _masked_down_1d(p: torch.Tensor, pid: torch.Tensor, kern: list[float],
                    axis: int):
    """``_conv_down_1d`` where a tap on a pixel of another patch than the
    centre sample's takes the centre sample -> (plane, centre owners)."""
    w, off = _down_taps(kern)
    n = p.shape[axis]
    pp = _edge_pad(p, axis, off, len(w) - 1 - off)
    pidp = _edge_pad(pid, axis, off, len(w) - 1 - off)
    center = _every_other(pp, axis, off, n)
    pid_c = _every_other(pidp, axis, off, n)
    out = None
    for k, wk in enumerate(w):
        val = torch.where(_every_other(pidp, axis, k, n) == pid_c,
                          _every_other(pp, axis, k, n), center)
        term = float(wk) * val
        out = term if out is None else out + term
    return out, pid_c


def rgb8_to_yuv420_patch_aware(rgb: torch.Tensor, patch_id: torch.Tensor,
                               down_filter: int | str = 1):
    """Per-patch chroma subsampling (the patchColorSubsampling path): the
    444->420 taps do not mix content of different patches; a tap whose
    pixel belongs to another patch takes the centre sample instead
    (patch-boundary edge replication, one pass over the whole video).
    ``patch_id``: (F, H, W) int32 per-pixel owner (background may be -1)."""
    y, u, v = _normalised_yuv(rgb)
    kh, kv = _DOWN_FILTERS[down_filter]

    def masked_down(p):
        ph, pid_h = _masked_down_1d(p, patch_id, kh, axis=2)
        return _masked_down_1d(ph, pid_h, kv, axis=1)[0]

    return _to_u8(y), _to_u8(masked_down(u)), _to_u8(masked_down(v))


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
    return _to_u8(torch.stack([r, g, b], dim=-1))


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
