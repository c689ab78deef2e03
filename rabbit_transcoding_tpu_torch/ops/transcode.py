"""Fused RBV GOP transcode: dequantise -> IDCT -> I/P chain -> DCT -> requantise.

Port of the TPU kernel ``rabbit_transcoding_tpu/ops/pallas_transcode.py``
(``transcode_gops_pallas`` / ``transcode_coeffs_pallas``) and of the XLA path
it shadows, ``rbv._transcode_impl_fused`` with ``_decode_impl`` and
``_encode_impl`` in their non-intra, no-deblock, no-threshold form.

* ``decode_chain`` / ``encode_chain``: the plain PyTorch chains, batched over
  GOPs like the reference's ``vmap`` (the codec's encode and decode use them).
* ``transcode_coeffs_ref``: the plain version of the fused transcode.
* ``transcode_coeffs``: the wrapper.  A CUDA tensor launches the hand-written
  Hopper kernel (``csrc/transcode_gops.cu``); a CPU tensor takes the plain
  version.  ``LAUNCHES`` counts kernel launches.

Layout in and out: frame-major int16 ``(F, nby, nbx, B, B)``.  Numerics:
fp32, round half to even, a true division ``|c| / qstep``.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .dct import dct2d, dct_tensor, idct2d

# deadzone quantisation offsets: round-half for intra, a wider deadzone for
# inter residuals (rbv._DZ_INTRA / _DZ_INTER)
DZ_INTRA = 0.5
DZ_INTER = 1.0 / 3.0

# kernel launches made by transcode_coeffs (read and reset by callers that
# must show the main path went through the kernel)
LAUNCHES = 0
_launch_lock = threading.Lock()


def _scalar(x: float, device) -> torch.Tensor:
    # a 0-d tensor ON the device: a CPU scalar divisor would let CUDA's
    # true-divide multiply by its reciprocal instead
    return torch.tensor(x, dtype=torch.float32, device=device)


def _quantize(c: torch.Tensor, qstep: torch.Tensor, dz: torch.Tensor):
    """sign(c) * floor(|c| / qstep + dz), clipped to +/-32767 (float)."""
    return torch.clamp(
        torch.sign(c) * torch.floor(torch.abs(c) / qstep + dz), -32767, 32767
    )


def _pad_frames(x: torch.Tensor, gop: int) -> torch.Tensor:
    """Repeat the last frame up to a whole number of GOPs."""
    pad = (-x.shape[0]) % gop
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x


def decode_chain(coeffs: torch.Tensor, qstep: float, maxval: float,
                 gop: int) -> torch.Tensor:
    """int coeffs (F, nby, nbx, B, B) -> pixel blocks float32, same shape:
    each GOP's I frame decodes alone, each P frame adds to the previous
    recon; recon = clip(round(.), 0, maxval)."""
    f = coeffs.shape[0]
    dev = coeffs.device
    qs = _scalar(qstep, dev)
    g = _pad_frames(coeffs, gop).to(torch.float32)
    g = g.reshape(-1, gop, *g.shape[1:])
    recs = []
    prev = None
    for k in range(gop):
        res = idct2d(g[:, k] * qs)
        pix = res if prev is None else prev + res
        prev = torch.clamp(torch.round(pix), 0.0, maxval)
        recs.append(prev)
    return torch.stack(recs, 1).reshape(-1, *g.shape[2:])[:f]


def encode_chain(blocks: torch.Tensor, qstep: float, maxval: float,
                 gop: int, recon: bool = True):
    """Pixel blocks (F, nby, nbx, B, B) -> (coeffs int16, recon float32 or
    None).  I frames code the pixels, P frames the residual against the
    previous closed-loop recon.  With recon=False only the recons that a
    later P frame predicts from are computed."""
    f = blocks.shape[0]
    dev = blocks.device
    qs = _scalar(qstep, dev)
    dz_intra, dz_inter = _scalar(DZ_INTRA, dev), _scalar(DZ_INTER, dev)
    g = _pad_frames(blocks.to(torch.float32), gop)
    g = g.reshape(-1, gop, *g.shape[1:])
    qs_out, recs = [], []
    prev = None
    for k in range(gop):
        frame = g[:, k]
        res = frame if prev is None else frame - prev
        q = _quantize(dct2d(res), qs, dz_intra if prev is None else dz_inter)
        qs_out.append(q.to(torch.int16))
        if recon or k + 1 < gop:
            r = idct2d(q * qs)
            pix = r if prev is None else prev + r
            prev = torch.clamp(torch.round(pix), 0.0, maxval)
            recs.append(prev)
    q = torch.stack(qs_out, 1).reshape(-1, *g.shape[2:])[:f]
    if not recon:
        return q, None
    return q, torch.stack(recs, 1).reshape(-1, *g.shape[2:])[:f]


def transcode_coeffs_ref(coeffs: torch.Tensor, qs_in: float, qs_out: float,
                         maxval: float, gop_in: int,
                         gop_out: int) -> torch.Tensor:
    """Plain PyTorch fused transcode: int16 (F, nby, nbx, B, B) coefficients
    of a stream at (qs_in, gop_in) -> int16 coefficients of the same shape
    at (qs_out, gop_out).  Both chains are causal, so a ragged last GOP
    gives the frames the reference computes after padding."""
    pixels = decode_chain(coeffs, qs_in, maxval, gop_in)
    return encode_chain(pixels, qs_out, maxval, gop_out, recon=False)[0]


def transcode_coeffs(coeffs: torch.Tensor, qs_in: float, qs_out: float,
                     maxval: float, gop_in: int,
                     gop_out: int) -> torch.Tensor:
    """The fused transcode of ``transcode_coeffs_ref`` on any device: the
    Hopper kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if coeffs.device.type == "cpu":
        return transcode_coeffs_ref(coeffs, qs_in, qs_out, maxval, gop_in,
                                    gop_out)
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    if coeffs.dtype != torch.int16:
        raise TypeError(f"coefficients must be int16, got {coeffs.dtype}")
    if coeffs.dim() != 5 or coeffs.shape[-2:] != (16, 16):
        raise ValueError(
            f"expected (F, nby, nbx, 16, 16) coefficients, got "
            f"{tuple(coeffs.shape)}"
        )
    if not coeffs.is_contiguous():
        raise ValueError("coefficients must be contiguous")
    if gop_in < 1 or gop_out < 1:
        raise ValueError(f"GOP sizes must be >= 1, got {gop_in}, {gop_out}")
    f, nby, nbx = coeffs.shape[:3]
    out = torch.empty_like(coeffs)
    if out.numel() == 0:
        return out
    lib = _build.library()
    d = dct_tensor(16, coeffs.device)
    index = coeffs.device.index
    if index is None:
        index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    err = lib.rbv_transcode_gops(
        coeffs.data_ptr(), out.data_ptr(), d.data_ptr(), f, nby * nbx,
        gop_in, gop_out, qs_in, qs_out, maxval, DZ_INTRA, DZ_INTER, index,
        stream,
    )
    if err:
        raise RuntimeError(
            f"transcode_gops launch failed: CUDA error {err} "
            f"({lib.rbv_cuda_error_string(err).decode()})"
        )
    global LAUNCHES
    with _launch_lock:
        LAUNCHES += 1
    return out
