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
* ``transcode_coeffs_batched`` / ``transcode_coeffs_batched_ref``: the same
  for S streams of one shape with per-stream steps, one kernel launch for
  all of them (the batched multi-stream path).
  ``LAUNCHES`` counts kernel launches, ``BATCHED_LAUNCHES`` the batched ones.
* ``transcode_mc_intra`` / ``transcode_mc_intra_ref``: the chains'
  transcode of a stream with motion compensation and intra prediction (no
  deblocking, no threshold): for a CUDA tensor the hand-written Hopper
  kernel ``csrc/transcode_mc_intra.cu``, gop + 1 launches for every GOP of
  the call (``MC_INTRA_LAUNCHES``); its twin ``decode_chain`` +
  ``encode_chain``.

Layout in and out: frame-major ``(F, nby, nbx, B, B)`` (int16 coefficients,
float32 pixel blocks).  Numerics: fp32, round half to even, a true division
``|c| / qstep``.
"""

from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from ..device import to_device
from ..utils import timing
from . import _build
from . import rbv_tools as tools
from .dct import (blockify, dct2d, dct_matrix, dct_tensor, deblockify,
                  idct2d)
from .rbv_tools import DZ_INTER, DZ_INTRA, qstep_for, quantize, scalar

# kernel launches made by transcode_coeffs and transcode_coeffs_batched, and
# those of the latter alone (read and reset by callers that must show the
# main path went through the kernel)
LAUNCHES = 0
BATCHED_LAUNCHES = 0
# kernel launches made by transcode_mc_intra (gop + 1 a call)
MC_INTRA_LAUNCHES = 0
_launch_lock = threading.Lock()


def note_kernel(name: str) -> None:
    """Name the hand-written kernel that ran (``"gops"``, ``"mc_intra"``) on
    the enclosing ``submit`` span, where one is recorded: a plane's device
    work that carries no name ran as plain PyTorch."""
    sp = timing.current()
    if sp is not None and sp.name == "submit":
        sp.note("kernel", name)


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


def _step_of_frame(qstep, gop: int):
    """The quantiser steps of the chains' frames: a float for every frame,
    or a per-frame (F,) tensor -> a function of k giving the steps of frame
    k of every GOP (a float, or an (n_gops,) tensor)."""
    if not isinstance(qstep, torch.Tensor):
        return lambda k: qstep
    steps = _by_gop(qstep, gop)
    return lambda k: steps[:, k]


def _finish(pix: torch.Tensor, qstep, maxval: float,
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


def decode_chain(coeffs: torch.Tensor, qstep, maxval: float,
                 gop: int, deblock: bool = False,
                 imode: torch.Tensor | None = None,
                 mv: torch.Tensor | None = None) -> torch.Tensor:
    """int coeffs (F, nby, nbx, B, B) -> pixel blocks float32, same shape:
    each GOP's I frame decodes alone (with ``imode`` (n_gops, nby, nbx)
    through the intra mosaic), each P frame adds to the previous recon,
    moved by ``mv`` (F, nby, nbx) when given; recon = clip(round(.), 0,
    maxval), then deblocked when ``deblock``.  ``qstep`` is a float or a
    per-frame (F,) float32 tensor (streams of different QPs stacked on the
    frame axis, each padded to whole GOPs)."""
    f = coeffs.shape[0]
    b = coeffs.shape[-1]
    step = _step_of_frame(qstep, gop)
    g = _by_gop(coeffs, gop).to(torch.float32)
    gmv = _by_gop(mv, gop)
    recs = []
    prev = None
    for k in range(gop):
        if k == 0 and imode is not None:
            rec = tools.intra_rebuild(g[:, 0], imode, step(0), maxval, b,
                                      deblock, _vmapped(gop, mv is not None))
            prev = blockify(rec, b)
        else:
            res = idct2d(g[:, k] * qstep_for(step(k), g[:, k]))
            if k:
                res = _predict(prev, None if gmv is None else gmv[:, k]) + res
            prev = _finish(res, step(k), maxval, deblock)
        recs.append(prev)
    return torch.stack(recs, 1).reshape(-1, *g.shape[2:])[:f]


def encode_chain(blocks: torch.Tensor, qstep, maxval: float,
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
    (``search``; ``weights`` (F, H, W) mask its distortion per pixel).
    ``qstep`` is a float or, without ``search``, a per-frame (F,) tensor as
    in ``decode_chain``.  With
    recon=False only the recons that a later P frame predicts from are
    computed."""
    f = blocks.shape[0]
    b = blocks.shape[-1]
    dev = blocks.device
    step = _step_of_frame(qstep, gop)
    dz_intra, dz_inter = scalar(DZ_INTRA, dev), scalar(DZ_INTER, dev)
    if search and isinstance(qstep, torch.Tensor):
        raise TypeError("the motion search takes one float quantiser step")
    lam = (float(np.float32(qstep) * np.float32(tools.MC_LAMBDA_SCALE))
           if search else 0.0)
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
                deblockify(frame), step(0), maxval, b, deblock, thr_k,
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
        qs = qstep_for(step(k), res)
        q = quantize(dct2d(res), qs, dz)
        if thr_k:
            q = tools.threshold_coeffs(q, b, thr_k)
        q_out.append(q.to(torch.int16))
        if recon or k + 1 < gop:
            r = idct2d(q * qs)
            prev = _finish(r if pred is None else pred + r, step(k), maxval,
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


def stack_frames(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(S, F, ...) -> (S * frames, ...): each stream's last frame repeated up
    to ``frames``, the streams one after the other on the frame axis."""
    pad = frames - x.shape[1]
    if pad:
        x = torch.cat([x, x[:, -1:].expand(-1, pad, *x.shape[2:])], 1)
    return x.reshape(-1, *x.shape[2:])


def transcode_coeffs_batched_ref(coeffs: torch.Tensor, qs_in: torch.Tensor,
                                 qs_out: torch.Tensor, maxval: float,
                                 gop_in: int, gop_out: int) -> torch.Tensor:
    """Plain PyTorch fused transcode of S streams of one shape: int16
    (S, F, nby, nbx, B, B) coefficients with per-stream steps ``qs_in`` and
    ``qs_out`` (float32 (S,)) -> int16 of the same shape.  The streams are
    padded to whole GOPs of both sizes and stacked on the frame axis of one
    ``transcode_coeffs_ref`` call with per-frame steps."""
    s, f = coeffs.shape[:2]
    fp = f + (-f) % math.lcm(gop_in, gop_out)
    flat = stack_frames(coeffs, fp)
    out = transcode_coeffs_ref(flat, qs_in.repeat_interleave(fp),
                               qs_out.repeat_interleave(fp), maxval, gop_in,
                               gop_out)
    return out.reshape(s, fp, *coeffs.shape[2:])[:, :f]


# published peaks of one H100 SXM at its 700 W limit: fp32 outside the
# tensor cores, and device memory
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def row_flops() -> tuple[int, int]:
    """FLOPs of one 16-value row of a 16-term product as the kernel and the
    plain version compute it bit for bit: (a product with D^T, as in the
    IDCT; a product with D, as in the DCT).

    Every output is (s0 + s1) + (s2 + s3), s_r a chain of 4 FMAs over the
    inputs k = r (mod 4), the first one a product.  Two outputs' chains over
    the same inputs whose coefficient prefixes are equal, or equal but for
    their sign, give equal or opposite values bit for bit (rounding to
    nearest is symmetric), so the function needs each distinct prefix once:
    1 FLOP for a first product, 2 for each later FMA; and 1 FLOP for each
    distinct pair sum and total."""
    d = dct_matrix(16)

    def canon(seq) -> tuple:
        s = tuple(float(c) for c in seq)
        return min(s, tuple(-c for c in s))

    def count(coef) -> int:
        prods, sums = set(), set()
        for x in range(16):
            chains = [[coef(x, k) for k in range(r, 16, 4)]
                      for r in range(4)]
            for r, chain in enumerate(chains):
                prods.update((r, canon(chain[:j])) for j in range(1, 5))
            sums.update({("01", canon(chains[0] + chains[1])),
                         ("23", canon(chains[2] + chains[3])),
                         ("all", canon(sum(chains, [])))})
        firsts = sum(1 for _, p in prods if len(p) == 1)
        return 2 * len(prods) - firsts + len(sums)

    return count(lambda x, k: d[k, x]), count(lambda x, k: d[x, k])


def transcode_bound_ms(shape: tuple, gop_out: int,
                       dense: bool = False) -> tuple[float, str]:
    """The least time an H100 could take for the fused transcode of int16
    coefficients of ``shape`` ((S,) F, nby, nbx, 16, 16) -> (ms, "operations"
    or "bytes").  Operations: the FLOPs of the transforms this input needs
    (one IDCT and one DCT per frame, one closed-loop IDCT per frame that a
    later frame of its output GOP predicts from; two products of 16 rows
    each), each row counted by ``row_flops``, or with ``dense`` as 256 FMAs
    of 2 FLOP (16^3 per product, equal partial products not shared, the
    sums of the partial sums not counted); bytes: each coefficient read once
    and written once."""
    f, nby, nbx = shape[-5:-2]
    blocks = math.prod(shape[:-5]) * nby * nbx
    recons = sum(1 for i in range(f - 1) if (i + 1) % gop_out)
    idct_row, dct_row = (512, 512) if dense else row_flops()
    flops = blocks * 2 * 16 * ((f + recons) * idct_row + f * dct_row)
    byte_ms = 2 * 2 * math.prod(shape) / H100_BYTES_PER_S * 1e3
    flop_ms = flops / H100_FP32_FLOPS * 1e3
    return (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms,
                                                               "bytes")


def _check_kernel_input(coeffs: torch.Tensor, lead: tuple[str, ...],
                        gop_in: int, gop_out: int) -> None:
    """Raise unless ``coeffs`` is what the kernel takes: int16
    (*lead, nby, nbx, 16, 16), contiguous, 16-byte aligned (the kernel moves
    rows in 16-byte accesses), on a CUDA device."""
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    if coeffs.dtype != torch.int16:
        raise TypeError(f"coefficients must be int16, got {coeffs.dtype}")
    if coeffs.dim() != len(lead) + 4 or coeffs.shape[-2:] != (16, 16):
        raise ValueError(
            f"expected ({', '.join(lead)}, nby, nbx, 16, 16) coefficients, "
            f"got {tuple(coeffs.shape)}"
        )
    if not coeffs.is_contiguous():
        raise ValueError("coefficients must be contiguous")
    if coeffs.data_ptr() % 16:
        raise ValueError("coefficients must start at a 16-byte aligned "
                         "address")
    if gop_in < 1 or gop_out < 1:
        raise ValueError(f"GOP sizes must be >= 1, got {gop_in}, {gop_out}")


def launch(coeffs: torch.Tensor, out: torch.Tensor, qs_in, qs_out,
           maxval: float, gop_in: int, gop_out: int, lib=None) -> None:
    """Launch the kernel of ``lib`` (default: the package's build) on checked
    ``coeffs`` -> ``out`` on the current CUDA stream and count the launch:
    the single-stream entry point for (F, nby, nbx, 16, 16) input at float
    steps, the stream axis for (S, F, ...) input at per-stream step
    tensors."""
    lib = lib or _build.library()
    if coeffs.dim() == 5:
        f, nby, nbx = coeffs.shape[:3]
        entry = "rbv_transcode_gops"
        args = (f, nby * nbx, gop_in, gop_out, qs_in, qs_out)
    else:
        s, f, nby, nbx = coeffs.shape[:4]
        entry = "rbv_transcode_gops_batched"
        args = (s, f, nby * nbx, gop_in, gop_out, qs_in.data_ptr(),
                qs_out.data_ptr())
    index = coeffs.device.index
    if index is None:
        index = torch.cuda.current_device()
    err = getattr(lib, entry)(
        coeffs.data_ptr(), out.data_ptr(),
        dct_tensor(16, coeffs.device).data_ptr(), *args, maxval, DZ_INTRA,
        DZ_INTER, index, torch.cuda.current_stream(index).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"transcode_gops launch failed: CUDA error {err} "
            f"({lib.rbv_cuda_error_string(err).decode()})"
        )
    global LAUNCHES, BATCHED_LAUNCHES
    with _launch_lock:
        LAUNCHES += 1
        BATCHED_LAUNCHES += entry.endswith("_batched")
    note_kernel("gops")


def transcode_coeffs(coeffs: torch.Tensor, qs_in: float, qs_out: float,
                     maxval: float, gop_in: int,
                     gop_out: int) -> torch.Tensor:
    """The fused transcode of ``transcode_coeffs_ref`` on any device: the
    Hopper kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if coeffs.device.type == "cpu":
        return transcode_coeffs_ref(coeffs, qs_in, qs_out, maxval, gop_in,
                                    gop_out)
    _check_kernel_input(coeffs, ("F",), gop_in, gop_out)
    out = torch.empty_like(coeffs)
    if out.numel():
        launch(coeffs, out, qs_in, qs_out, maxval, gop_in, gop_out)
    return out


def transcode_coeffs_batched(coeffs: torch.Tensor, qs_in: torch.Tensor,
                             qs_out: torch.Tensor, maxval: float,
                             gop_in: int, gop_out: int) -> torch.Tensor:
    """The fused transcode of ``transcode_coeffs_batched_ref`` on any
    device: one launch of the Hopper kernel over all S streams for a CUDA
    tensor (``qs_in``/``qs_out`` float32 (S,) on the same device), the
    plain version for a CPU tensor."""
    if coeffs.device.type == "cpu":
        return transcode_coeffs_batched_ref(coeffs, qs_in, qs_out, maxval,
                                            gop_in, gop_out)
    _check_kernel_input(coeffs, ("S", "F"), gop_in, gop_out)
    s = coeffs.shape[0]
    for qs in (qs_in, qs_out):
        if (qs.dtype != torch.float32 or tuple(qs.shape) != (s,)
                or qs.device != coeffs.device or not qs.is_contiguous()):
            raise ValueError(
                f"per-stream steps must be float32 ({s},) on "
                f"{coeffs.device}, got {qs.dtype} {tuple(qs.shape)} on "
                f"{qs.device}")
    out = torch.empty_like(coeffs)
    if out.numel():
        launch(coeffs, out, qs_in, qs_out, maxval, gop_in, gop_out)
    return out


# --- the MC + intra chains in one kernel -------------------------------------
def mc_intra_applies(device: torch.device, block: int, motion: bool,
                     intra: bool, deblock: bool, thr_k: int, gop: int,
                     gop_out: int) -> bool:
    """Whether ``transcode_chains`` takes ``transcode_mc_intra``: a CUDA
    tensor, a stream with motion compensation and intra prediction, 16 x 16
    blocks, no deblocking, no coefficient threshold, the output GOP the
    input's (flags of the stream's header).  Everything else runs the plain
    chains."""
    return (device.type == "cuda" and motion and intra and not deblock
            and not thr_k and block == 16 and gop_out == gop)


@functools.lru_cache(maxsize=None)
def _taps_table(n_in: int, n_out: int) -> np.ndarray:
    """``rbv_tools._linear_taps(n_in, n_out)`` as the kernel reads it: int32
    (n_out, 4) rows of i0, i1 and the float32 bits of w0, w1 (shared, do
    not write to it)."""
    i0, i1, w0, w1 = tools._linear_taps(n_in, n_out)
    table = np.empty((n_out, 4), np.int32)
    table[:, 0], table[:, 1] = i0, i1
    table[:, 2], table[:, 3] = w0.view(np.int32), w1.view(np.int32)
    table.flags.writeable = False
    return table


def mc_intra_plan(nby: int, nbx: int) -> tuple:
    """The host side of the kernel's planar mosaic for (nby, nbx) blocks of
    16: (taps over H, taps over W, h_first, fused), as
    ``rbv_tools.mosaic_planar`` resizes under the per-GOP ``vmap`` (the
    chains with motion vectors always run under it)."""
    h_first, fused = tools.planar_order(nby, nbx, vmapped=True)
    return (_taps_table(nby, nby * 16), _taps_table(nbx, nbx * 16), h_first,
            fused)


@functools.lru_cache(maxsize=None)
def _device_taps(n_in: int, n_out: int, device: torch.device
                 ) -> torch.Tensor:
    """``_taps_table`` on ``device``, uploaded once per process."""
    return to_device(_taps_table(n_in, n_out).copy(), device)


def _step_arg(qs, frames: int, device) -> tuple:
    """A quantiser step as the kernel takes it: (pointer to a float32
    (frames,) tensor on ``device`` or None, the float for every frame)."""
    if not isinstance(qs, torch.Tensor):
        return None, float(qs)
    if (qs.dtype != torch.float32 or tuple(qs.shape) != (frames,)
            or qs.device != device or not qs.is_contiguous()):
        raise ValueError(
            f"per-frame steps must be float32 ({frames},) on {device}, got "
            f"{qs.dtype} {tuple(qs.shape)} on {qs.device}")
    return qs.data_ptr(), 0.0


def transcode_mc_intra_ref(q: torch.Tensor, mv: torch.Tensor,
                           imode: torch.Tensor, qs_in, qs_out,
                           maxval: float, gop: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin: ``decode_chain`` + ``encode_chain`` of a
    stream with motion vectors and intra mode maps, as
    ``video/rbv.py:transcode_chains`` runs them without deblocking or a
    threshold -> (int16 coefficients, uint8 mode maps)."""
    pixels = decode_chain(q, qs_in, maxval, gop, False, imode, mv)
    coded = encode_chain(pixels, qs_out, maxval, gop, recon=False,
                         intra=True, mv=mv)
    return coded["q"], coded["mode"]


def transcode_mc_intra(q: torch.Tensor, mv: torch.Tensor,
                       imode: torch.Tensor, qs_in, qs_out, maxval: float,
                       gop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``transcode_mc_intra_ref`` on any device: for a CUDA tensor the
    Hopper kernel, equal to it bit for bit; for a CPU tensor the plain
    twin.  int16 coefficients (F, nby, nbx, 16, 16), ``mv`` (F, nby, nbx)
    indices into ``rbv_tools.MC_OFFSETS``, ``imode`` (ceil(F / gop), nby,
    nbx) (non-zero: planar) -> (int16 coefficients of q's shape, uint8 mode
    maps of imode's shape).  The steps are floats, or per-frame (F,)
    float32 tensors on the device (streams stacked on the frame axis, each
    padded to whole GOPs).  On the card: gop + 1 launches on the current
    stream, no host synchronisation; the resize taps are uploaded once per
    shape and device."""
    if q.device.type == "cpu":
        return transcode_mc_intra_ref(q, mv, imode, qs_in, qs_out, maxval,
                                      gop)
    _check_kernel_input(q, ("F",), gop, gop)
    f, nby, nbx = q.shape[:3]
    n_gops = -(-f // gop)
    dev = q.device
    if tuple(mv.shape) != (f, nby, nbx) or mv.device != dev:
        raise ValueError(f"motion vectors must be ({f}, {nby}, {nbx}) on "
                         f"{dev}, got {tuple(mv.shape)} on {mv.device}")
    if tuple(imode.shape) != (n_gops, nby, nbx) or imode.device != dev:
        raise ValueError(f"mode maps must be ({n_gops}, {nby}, {nbx}) on "
                         f"{dev}, got {tuple(imode.shape)} on "
                         f"{imode.device}")
    mv = mv.to(torch.int32).contiguous()
    imode = imode.to(torch.uint8).contiguous()
    qs_in_f, qs_in = _step_arg(qs_in, f, dev)
    qs_out_f, qs_out = _step_arg(qs_out, f, dev)
    out = torch.empty_like(q)
    mode = torch.empty((n_gops, nby, nbx), dtype=torch.uint8, device=dev)
    if not q.numel():
        return out, mode
    _, _, h_first, fused = mc_intra_plan(nby, nbx)
    taps_h = _device_taps(nby, nby * 16, dev)
    taps_w = _device_taps(nbx, nbx * 16, dev)
    dcq = torch.empty((n_gops, nby, nbx), dtype=torch.float32, device=dev)
    # the decoded and closed-loop planes between launches, 16-bit samples
    planes = torch.empty((2 if gop <= 2 else 4, n_gops, nby * 16, nbx * 16),
                         dtype=torch.int16, device=dev)
    lib = _build.library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.rbv_transcode_mc_intra(
        q.data_ptr(), out.data_ptr(), mode.data_ptr(), mv.data_ptr(),
        imode.data_ptr(), dcq.data_ptr(), planes.data_ptr(),
        taps_h.data_ptr(), taps_w.data_ptr(), f, nby, nbx, gop,
        int(h_first), int(fused), qs_in_f, qs_out_f, qs_in, qs_out, maxval,
        DZ_INTRA, DZ_INTER, index,
        torch.cuda.current_stream(index).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"transcode_mc_intra launch failed: CUDA error {err} "
            f"({lib.rbv_cuda_error_string(err).decode()})")
    global MC_INTRA_LAUNCHES
    with _launch_lock:
        MC_INTRA_LAUNCHES += gop + 1
    note_kernel("mc_intra")
    return out, mode
