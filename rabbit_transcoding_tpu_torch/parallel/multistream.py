"""Batched multi-stream transcode: N RBV payloads, one device call per plane
for each group of streams of one shape.

Port of ``rabbit_transcoding_tpu/parallel/multistream.py`` without the
device mesh (one GPU): the streams of a group are stacked on a leading
stream axis on the device, and their per-stream QPs ride as float32
quantiser-step tensors.

* No MC, intra, deblocking or threshold: one launch of the Hopper kernel
  over the whole group (``ops.transcode.transcode_coeffs_batched``).
* Every other branch (MC, intra, deblocking, threshold, requant with or
  without drift compensation): the plain chains once per group, the streams
  stacked on the frame axis that the chains already batch over, each padded
  to whole GOPs, with per-frame step tensors.  The intra numerics depend on
  whether the reference ``vmap``s the single-stream program over GOPs; the
  chains decide that from the GOP and the MC flag alone, so a stacked call
  computes what S single-stream calls compute.

Output: byte-identical payloads to the sequential ``video.rbv``
``transcode_payload`` / ``requantize`` on each stream.  Entropy coding stays
on host threads; only the coefficient slabs cross to the device.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import struct

import torch

from ..device import resolve
from ..ops import rbv_tools as tools
from ..ops.transcode import stack_frames, transcode_coeffs_batched
from ..utils.enums import ColorFormat
from ..video import rbv
from ..video.rbv import (
    _HEADER,
    _LOSSLESS,
    _MAGIC,
    _MC,
    _DEBLOCK,
    _INTRA,
    _Plane,
    _encode_coeff_blob,
    _encode_intra_section,
    _encode_mv_section,
    _f32,
    _iter_blobs,
    _parse_header,
    _plane_dims,
    qstep_of,
    transcode_chains,
)


def _group_signature(header: tuple) -> tuple:
    """Streams batch together when everything but the QP matches: the QP
    rides as a per-stream quantiser step."""
    flags, width, height, bitdepth, chroma, f, block, gop, _qp = header
    return (flags, width, height, bitdepth, chroma, f, block, gop)


def _pool(n: int) -> cf.ThreadPoolExecutor:
    return cf.ThreadPoolExecutor(max_workers=max(1, min(8, n)))


def transcode_payloads(
    payloads: list[bytes],
    new_qp: int | list[int],
    device: torch.device | str = "cuda",
    new_gop: int | None = None,
    zlib_level: int = 6,
    mode: str = "reencode",
    coeff_threshold: int = 0,
) -> list[bytes]:
    """Transcode N RBV payloads, one batched device call per plane and
    group of streams of one shape (everything but the QP equal).  Lossless
    payloads defer to the sequential functions; a no-op requantisation
    passes through.  ``mode="requant"`` requantises in the DCT domain
    instead of the fused decode -> re-encode; ``coeff_threshold`` thresholds
    every re-encode.  ``device`` is the card unless the caller asks for
    the CPU; no card raises."""
    device = resolve(device)
    n = len(payloads)
    qps = [new_qp] * n if isinstance(new_qp, int) else list(new_qp)
    if len(qps) != n:
        raise ValueError("per-stream QP list length mismatch")
    headers = [_parse_header(p) for p in payloads]
    out: list[bytes | None] = [None] * n
    groups: dict[tuple, list[int]] = {}
    for i, h in enumerate(headers):
        if h[0] & _LOSSLESS:
            # lossless: the sequential functions re-encode to the target QP
            out[i] = (
                rbv.requantize(payloads[i], qps[i], zlib_level, device)
                if mode == "requant"
                else rbv.transcode_payload(payloads[i], qps[i], new_gop,
                                           zlib_level, coeff_threshold,
                                           device))
            continue
        if mode == "requant" and qps[i] == h[8]:
            out[i] = payloads[i]  # no-op requant: pass through
            continue
        groups.setdefault(_group_signature(h), []).append(i)

    for sig, idxs in groups.items():
        group_out = _transcode_group(
            sig, [payloads[i] for i in idxs], [headers[i][8] for i in idxs],
            [qps[i] for i in idxs], device, new_gop, zlib_level, mode,
            coeff_threshold)
        for i, payload in zip(idxs, group_out):
            out[i] = payload
    return out  # type: ignore[return-value]


def _transcode_group(sig: tuple, payloads: list[bytes], qps_in: list[int],
                     qps_out: list[int], device: torch.device,
                     new_gop: int | None, zlib_level: int, mode: str,
                     thr_k: int) -> list[bytes]:
    """One group of streams of one shape -> their transcoded payloads."""
    flags, width, height, bitdepth, chroma, f, block, gop = sig
    use_mc, use_db = bool(flags & _MC), bool(flags & _DEBLOCK)
    use_intra = bool(flags & _INTRA)
    gop_out = gop if (use_mc or mode == "requant") else (new_gop or gop)
    # frame padding that makes whole GOPs of both sizes: each stream's GOPs
    # then line up on the stacked frame axis
    fp = f + (-f) % math.lcm(gop, gop_out)
    dims = _plane_dims(width, height, ColorFormat(chroma))
    maxval = float((1 << bitdepth) - 1)
    s = len(payloads)
    qs_in = torch.tensor([_f32(qstep_of(q)) for q in qps_in],
                         dtype=torch.float32, device=device)
    qs_out = torch.tensor([_f32(qstep_of(q)) for q in qps_out],
                          dtype=torch.float32, device=device)
    blob_lists = [list(_iter_blobs(p, len(dims))) for p in payloads]
    n_i_out = (f + (-f) % gop_out) // gop_out

    def one_plane(pi: int) -> list[bytes]:
        h, w = dims[pi]
        # host entropy decode; only the frequency slabs cross to the device
        with _pool(s) as ex:
            planes = list(ex.map(
                lambda si: _Plane(blob_lists[si][pi], flags, f, h, w, block,
                                  gop, device), range(s)))
        q = torch.stack([pl.q for pl in planes])  # (S, F, nby, nbx, B, B)
        mode2 = None
        if mode == "requant":
            flat = stack_frames(q, fp)
            steps_in = qs_in.repeat_interleave(fp)
            steps_out = qs_out.repeat_interleave(fp)
            if not use_mc and gop > 1:
                # drift-compensated, as rbv.requantize for zero-MV P chains
                q2 = tools.requant_compensated(flat, steps_in, steps_out, gop)
            else:
                q2 = tools.requant(flat, steps_in, steps_out)
            q2 = q2.reshape(s, fp, *q.shape[2:])
        elif not use_mc and not use_intra and not use_db and not thr_k:
            # the kernel's branch: one launch for the whole group
            q2 = transcode_coeffs_batched(q, qs_in, qs_out, maxval, gop,
                                          gop_out)
        else:
            mv = imode = None
            if use_mc:
                mv = stack_frames(
                    torch.stack([pl.tensor("mv") for pl in planes]), fp)
            if use_intra:
                imode = stack_frames(
                    torch.stack([pl.tensor("mode") for pl in planes]),
                    fp // gop)
            q2, mode2 = transcode_chains(
                stack_frames(q, fp), mv, imode,
                qs_in.repeat_interleave(fp), qs_out.repeat_interleave(fp),
                maxval, gop, gop_out, use_db, use_intra, thr_k)
            q2 = q2.reshape(s, fp, *q.shape[2:])
            if mode2 is not None:
                mode2 = mode2.reshape(s, fp // gop_out, *mode2.shape[1:])

        def host_encode(si: int) -> bytes:
            pl = planes[si]
            side = b"" if pl.mv is None else _encode_mv_section(pl.mv,
                                                                zlib_level)
            if mode2 is not None:
                side += _encode_intra_section(
                    mode2[si, :n_i_out].cpu().numpy(), zlib_level)
            else:
                side += pl.raw_mode  # requant: the mode maps pass through
            return side + _encode_coeff_blob(q2[si, :f], zlib_level)

        with _pool(s) as ex:
            return list(ex.map(host_encode, range(s)))

    # one thread per plane, as the single-stream transcode: host entropy
    # overlaps across planes while the device runs the calls in order
    with cf.ThreadPoolExecutor(max_workers=len(dims)) as ex:
        per_plane = list(ex.map(one_plane, range(len(dims))))
    out = []
    for si, qp in enumerate(qps_out):
        buf = bytearray(_HEADER.pack(
            _MAGIC, 2, flags, width, height, bitdepth, chroma, f, block,
            gop_out, qp, 0))
        for blobs in per_plane:
            buf.extend(struct.pack("<I", len(blobs[si])))
            buf.extend(blobs[si])
        out.append(bytes(buf))
    return out
