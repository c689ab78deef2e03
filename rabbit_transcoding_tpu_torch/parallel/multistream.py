"""Batched multi-stream transcode over a device mesh: N RBV payloads, one
device call per plane for each group of streams of one shape and each shard.

Port of ``rabbit_transcoding_tpu/parallel/multistream.py``: the streams of
a group are stacked on a leading stream axis, their per-stream QPs ride as
float32 quantiser-step tensors, and the mesh (``parallel/mesh.py``) places
the shards, one Python process for every device.

The streams of a group split over the whole flattened mesh, in runs whose
sizes differ by at most one; no branch splits block rows over "space".
The MC search window, intra's neighbours and deblocking reach across block
rows, and a row split of the other branches moves the same bytes for no
gain measured on the card (``PERF.md`` section 6).  The reference splits
rows over "space" where they divide evenly and pads the stream axis with
zero streams; here a shard with no stream launches nothing.  On each
shard:

* No MC, intra, deblocking or threshold (the kernel's branch): one launch
  of the Hopper kernel per plane (``ops.transcode.
  transcode_coeffs_batched``).
* Requant, with or without drift compensation: the DCT-domain requant ops.
* Every other branch (MC, intra, deblocking, threshold): the plain chains
  once, the shard's streams stacked on the frame axis that the chains
  already batch over, each padded to whole GOPs, with per-frame step
  tensors.  The intra numerics depend on whether the reference ``vmap``s
  the single-stream program over GOPs; the chains decide that from the GOP
  and the MC flag alone, so a stacked call computes what S single-stream
  calls compute.

Each stream is entropy-decoded onto its shard's device, and every shard
launches before any result is downloaded.

Output: byte-identical payloads to the sequential ``video.rbv``
``transcode_payload`` / ``requantize`` on each stream, for every mesh.
Entropy coding stays on host threads; only the coefficient slabs cross to
the devices.
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
from .mesh import Mesh, mesh_of, shard_bounds


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
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
    new_gop: int | None = None,
    zlib_level: int = 6,
    mode: str = "reencode",
    coeff_threshold: int = 0,
) -> list[bytes]:
    """Transcode N RBV payloads, one batched device call per plane, group
    of streams of one shape (everything but the QP equal) and shard of
    ``mesh``.  Lossless payloads defer to the sequential functions on the
    mesh's first device; a no-op requantisation passes through.
    ``mode="requant"`` requantises in the DCT domain instead of the fused
    decode -> re-encode; ``coeff_threshold`` thresholds every re-encode.
    The placement is ``mesh``, or else ``device`` (default ``cuda``), which
    gives one (``parallel.mesh.mesh_of``: every visible card for ``cuda``
    with no index, else that one device); giving both raises, and so does a
    CUDA device where there is no card."""
    if mesh is not None and device is not None:
        raise ValueError("give a device or a mesh, not both")
    if mesh is None:
        device = resolve(device or "cuda")
    n = len(payloads)
    qps = [new_qp] * n if isinstance(new_qp, int) else list(new_qp)
    if len(qps) != n:
        raise ValueError("per-stream QP list length mismatch")
    if not n:
        return []
    mesh = mesh if mesh is not None else mesh_of(device)
    headers = [_parse_header(p) for p in payloads]
    out: list[bytes | None] = [None] * n
    groups: dict[tuple, list[int]] = {}
    for i, h in enumerate(headers):
        if h[0] & _LOSSLESS:
            # lossless: the sequential functions re-encode to the target QP
            out[i] = (
                rbv.requantize(payloads[i], qps[i], zlib_level, mesh.first)
                if mode == "requant"
                else rbv.transcode_payload(payloads[i], qps[i], new_gop,
                                           zlib_level, coeff_threshold,
                                           mesh.first))
            continue
        if mode == "requant" and qps[i] == h[8]:
            out[i] = payloads[i]  # no-op requant: pass through
            continue
        groups.setdefault(_group_signature(h), []).append(i)

    for sig, idxs in groups.items():
        group_out = _transcode_group(
            sig, [payloads[i] for i in idxs], [headers[i][8] for i in idxs],
            [qps[i] for i in idxs], mesh, new_gop, zlib_level, mode,
            coeff_threshold)
        for i, payload in zip(idxs, group_out):
            out[i] = payload
    return out  # type: ignore[return-value]


def _transcode_group(sig: tuple, payloads: list[bytes], qps_in: list[int],
                     qps_out: list[int], mesh: Mesh, new_gop: int | None,
                     zlib_level: int, mode: str,
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
    # the shards: runs of streams over the flattened mesh, empty ones left
    # out, each with its per-stream steps uploaded before any launch (an
    # upload from host memory waits for its device)
    shards = []
    home = [None] * s
    for dev, (a, b) in zip(mesh.flat, shard_bounds(s, mesh.size)):
        if a == b:
            continue
        steps = [torch.tensor([_f32(qstep_of(q)) for q in qps[a:b]],
                              dtype=torch.float32, device=dev)
                 for qps in (qps_in, qps_out)]
        shards.append((range(a, b), *steps))
        home[a:b] = [dev] * (b - a)

    def run_shard(planes, streams, qs_in, qs_out):
        """The streams of one shard, stacked (S', F, nby, nbx, B, B) on its
        device -> (q2 of that shape, intra modes or None)."""
        q = torch.stack([planes[si].q for si in streams])
        if mode == "requant":
            flat = stack_frames(q, fp)
            steps_in = qs_in.repeat_interleave(fp)
            steps_out = qs_out.repeat_interleave(fp)
            if not use_mc and gop > 1:
                # drift-compensated, as rbv.requantize for zero-MV P chains
                q2 = tools.requant_compensated(flat, steps_in, steps_out, gop)
            else:
                q2 = tools.requant(flat, steps_in, steps_out)
            return q2.reshape(q.shape[0], fp, *q.shape[2:]), None
        if not use_mc and not use_intra and not use_db and not thr_k:
            # the kernel's branch: one launch for the shard
            return transcode_coeffs_batched(q, qs_in, qs_out, maxval, gop,
                                            gop_out), None
        mv = imode = None
        if use_mc:
            mv = stack_frames(
                torch.stack([planes[si].tensor("mv") for si in streams]), fp)
        if use_intra:
            imode = stack_frames(
                torch.stack([planes[si].tensor("mode") for si in streams]),
                fp // gop)
        q2, mode2 = transcode_chains(
            stack_frames(q, fp), mv, imode, qs_in.repeat_interleave(fp),
            qs_out.repeat_interleave(fp), maxval, gop, gop_out, use_db,
            use_intra, thr_k)
        q2 = q2.reshape(q.shape[0], fp, *q.shape[2:])
        if mode2 is not None:
            mode2 = mode2.reshape(q.shape[0], fp // gop_out,
                                  *mode2.shape[1:])
        return q2, mode2

    blob_lists = [list(_iter_blobs(p, len(dims))) for p in payloads]
    n_i_out = (f + (-f) % gop_out) // gop_out

    def one_plane(pi: int) -> list[bytes]:
        h, w = dims[pi]
        # host entropy decode onto each stream's shard; only the frequency
        # slabs cross to the devices
        with _pool(s) as ex:
            planes = list(ex.map(
                lambda si: _Plane(blob_lists[si][pi], flags, f, h, w, block,
                                  gop, home[si]), range(s)))
        q2s: list = [None] * s
        mode2s: list = [None] * s
        # every shard launches before anything is downloaded
        for streams, qs_in, qs_out in shards:
            q2, mode2 = run_shard(planes, streams, qs_in, qs_out)
            for k, si in enumerate(streams):
                q2s[si] = q2[k]
                mode2s[si] = None if mode2 is None else mode2[k]

        def host_encode(si: int) -> bytes:
            pl = planes[si]
            side = b"" if pl.mv is None else _encode_mv_section(pl.mv,
                                                                zlib_level)
            if mode2s[si] is not None:
                side += _encode_intra_section(
                    mode2s[si][:n_i_out].cpu().numpy(), zlib_level)
            else:
                side += pl.raw_mode  # requant: the mode maps pass through
            return side + _encode_coeff_blob(q2s[si][:f], zlib_level)

        with _pool(s) as ex:
            return list(ex.map(host_encode, range(s)))

    # one thread per plane, as the single-stream transcode: host entropy
    # overlaps across planes while the devices run the calls in order
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
