"""RBV I/P chains and the fused GOP transcode: dequantise -> IDCT -> I/P
chain -> DCT -> requantise.

Port of the TPU kernel ``rabbit_transcoding_tpu/ops/pallas_transcode.py``
(``transcode_gops_pallas`` / ``transcode_coeffs_pallas``) and of the XLA
programs of ``rabbit_transcoding_tpu/video/rbv.py`` around it:
``_encode_impl`` / ``_decode_impl`` with their intra, deblocking and
threshold options, the motion-compensated ``_encode_impl_mc_core``,
``_decode_impl_mc`` and ``_reencode_with_mv``, and the fused transcodes.

* ``decode_chain`` / ``encode_chain``: the plain PyTorch chains, batched over
  GOPs like the reference's ``vmap``, with the tools of ``rbv_tools``.
* ``transcode_coeffs_ref``: the plain version of the fused transcode.
* ``transcode_coeffs``: the wrapper of the branch without MC, intra,
  deblocking or threshold.  A CUDA tensor launches the hand-written Hopper
  kernel (``csrc/transcode_gops.cu``); a CPU tensor takes the plain version.
  ``LAUNCHES`` counts kernel launches.

Layout in and out: frame-major ``(F, nby, nbx, B, B)`` (int16 coefficients,
float32 pixel blocks).  Numerics: fp32, round half to even, a true division
``|c| / qstep``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _build
from . import rbv_tools as tools
from .dct import blockify, dct2d, dct_tensor, deblockify, idct2d
from .rbv_tools import DZ_INTER, DZ_INTRA, quantize, scalar

# kernel launches made by transcode_coeffs (read and reset by callers that
# must show the main path went through the kernel)
LAUNCHES = 0
_launch_lock = threading.Lock()


def _pad_frames(x: torch.Tensor, gop: int) -> torch.Tensor:
    """Repeat the last frame up to a whole number of GOPs."""
    pad = (-x.shape[0]) % gop
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x


def _by_gop(x: torch.Tensor | None, gop: int):
    """(F, ...) -> (n_gops, gop, ...), the last frame repeated to fill."""
    if x is None:
        return None
    x = _pad_frames(x, gop)
    return x.reshape(-1, gop, *x.shape[1:])


def _finish(pix: torch.Tensor, qstep: float, maxval: float,
            deblock: bool) -> torch.Tensor:
    """Pixel blocks -> the closed-loop recon: rounded, clipped, and with
    deblocking filtered across the block boundaries of each frame."""
    rec = tools.reconstruct(pix, maxval)
    if deblock:
        b = rec.shape[-1]
        rec = blockify(tools.deblock(deblockify(rec), qstep, maxval, b), b)
    return rec


def _vmapped(gop: int, motion: bool) -> bool:
    """Whether the reference runs the chain under its per-GOP ``vmap``: all
    but the plain and intra programs at GOP 1 do (the intra numerics follow
    the program, ``rbv_tools.intra_code_frame``)."""
    return gop > 1 or motion


def _predict(prev: torch.Tensor, mv: torch.Tensor | None) -> torch.Tensor:
    """The P-frame prediction in block layout: the previous recon, moved by
    the per-block motion vectors when there are any."""
    if mv is None:
        return prev
    b = prev.shape[-1]
    return blockify(tools.mc_predict(deblockify(prev), mv, b), b)


def decode_chain(coeffs: torch.Tensor, qstep: float, maxval: float,
                 gop: int, deblock: bool = False,
                 imode: torch.Tensor | None = None,
                 mv: torch.Tensor | None = None) -> torch.Tensor:
    """int coeffs (F, nby, nbx, B, B) -> pixel blocks float32, same shape:
    each GOP's I frame decodes alone (with ``imode`` (n_gops, nby, nbx)
    through the intra mosaic), each P frame adds to the previous recon,
    moved by ``mv`` (F, nby, nbx) when given; recon = clip(round(.), 0,
    maxval), then deblocked when ``deblock``."""
    f = coeffs.shape[0]
    b = coeffs.shape[-1]
    qs = scalar(qstep, coeffs.device)
    g = _by_gop(coeffs, gop).to(torch.float32)
    gmv = _by_gop(mv, gop)
    recs = []
    prev = None
    for k in range(gop):
        if k == 0 and imode is not None:
            rec = tools.intra_rebuild(g[:, 0], imode, qstep, maxval, b,
                                      deblock, _vmapped(gop, mv is not None))
            prev = blockify(rec, b)
        else:
            res = idct2d(g[:, k] * qs)
            if k:
                res = _predict(prev, None if gmv is None else gmv[:, k]) + res
            prev = _finish(res, qstep, maxval, deblock)
        recs.append(prev)
    return torch.stack(recs, 1).reshape(-1, *g.shape[2:])[:f]


def encode_chain(blocks: torch.Tensor, qstep: float, maxval: float,
                 gop: int, recon: bool = True, deblock: bool = False,
                 thr_k: int = 0, intra: bool = False,
                 mv: torch.Tensor | None = None, search: bool = False,
                 weights: torch.Tensor | None = None) -> dict:
    """Pixel blocks (F, nby, nbx, B, B) -> {"q": int16 coefficients, "rec":
    float32 recon blocks or None, "mode": uint8 (n_gops, nby, nbx) intra
    mode maps or None, "mv": int32 (F, nby, nbx) motion vectors or None}.

    I frames code the pixels (``intra``: through the mosaic predictors), P
    frames the residual against the previous closed-loop recon: as it is,
    moved by the given ``mv``, or moved by a block motion search
    (``search``; ``weights`` (F, H, W) mask its distortion per pixel).  With
    recon=False only the recons that a later P frame predicts from are
    computed."""
    f = blocks.shape[0]
    b = blocks.shape[-1]
    dev = blocks.device
    qs = scalar(qstep, dev)
    dz_intra, dz_inter = scalar(DZ_INTRA, dev), scalar(DZ_INTER, dev)
    lam = float(np.float32(qstep) * np.float32(tools.MC_LAMBDA_SCALE))
    g = _by_gop(blocks.to(torch.float32), gop)
    gmv = _by_gop(mv, gop)
    gw = _by_gop(None if weights is None else weights.to(torch.float32), gop)
    q_out, recs, mvs = [], [], []
    mode = None
    prev = None
    for k in range(gop):
        frame = g[:, k]
        if search and k == 0:
            mvs.append(torch.zeros(frame.shape[:-2], dtype=torch.int32,
                                   device=dev))
        if k == 0 and intra:
            q, mode, rec = tools.intra_code_frame(
                deblockify(frame), qstep, maxval, b, deblock, thr_k,
                _vmapped(gop, search or mv is not None))
            q_out.append(q)
            prev = blockify(rec, b)
            recs.append(prev)
            continue
        pred, dz = None, dz_intra
        if k and search:
            mv_k, pred = tools.mc_search(
                deblockify(frame), deblockify(prev), b, lam,
                None if gw is None else gw[:, k])
            mvs.append(mv_k)
            pred, dz = blockify(pred, b), dz_inter
        elif k:
            pred = _predict(prev, None if gmv is None else gmv[:, k])
            dz = dz_inter
        res = frame if pred is None else frame - pred
        q = quantize(dct2d(res), qs, dz)
        if thr_k:
            q = tools.threshold_coeffs(q, b, thr_k)
        q_out.append(q.to(torch.int16))
        if recon or k + 1 < gop:
            r = idct2d(q * qs)
            prev = _finish(r if pred is None else pred + r, qstep, maxval,
                           deblock)
            recs.append(prev)
    shape = (-1,) + tuple(g.shape[2:])
    return {
        "q": torch.stack(q_out, 1).reshape(shape)[:f],
        "rec": torch.stack(recs, 1).reshape(shape)[:f] if recon else None,
        "mode": mode,
        "mv": (torch.stack(mvs, 1).reshape(-1, *g.shape[2:4])[:f]
               if search else None),
    }


def transcode_coeffs_ref(coeffs: torch.Tensor, qs_in: float, qs_out: float,
                         maxval: float, gop_in: int, gop_out: int,
                         deblock: bool = False,
                         thr_k: int = 0) -> torch.Tensor:
    """Plain PyTorch fused transcode: int16 (F, nby, nbx, B, B) coefficients
    of a stream at (qs_in, gop_in) -> int16 coefficients of the same shape
    at (qs_out, gop_out), deblocking in both loops and thresholding the
    re-encode when asked.  Both chains are causal, so a ragged last GOP
    gives the frames the reference computes after padding."""
    pixels = decode_chain(coeffs, qs_in, maxval, gop_in, deblock)
    return encode_chain(pixels, qs_out, maxval, gop_out, recon=False,
                        deblock=deblock, thr_k=thr_k)["q"]


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
