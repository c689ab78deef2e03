"""Device meshes: one process, a 2-D grid of torch devices.

Port of ``rabbit_transcoding_tpu/parallel/mesh.py``.  JAX places one program
over many devices; here one Python process holds a ("stream", "space") grid
of ``torch.device``s and puts each shard's tensors on its device:

* axis "stream": data parallelism over concurrent streams;
* axis "space": parallelism over block rows, for the work in which every
  block row is independent.

Launches go to each device's current stream, so the devices overlap without
a sync between shards; cross-device reductions move the small partials to
the mesh's first device and add them in shard order.  ``torch.distributed``
is not used: it would need one process per card.

A mesh may list one device more than once: N shards on one device (a
virtual mesh, the counterpart of JAX's virtual CPU devices).  Shards on one
device never share an output buffer.  A mesh that names a CUDA device
raises where there is none (``device.resolve``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..ops.dct import deblockify, idct2d
from ..ops.transcode import transcode_coeffs


def _device(d) -> torch.device:
    """``d`` resolved, a CUDA device with its index filled in."""
    dev = resolve(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 2-D grid of devices with the axes ("stream", "space"), as a JAX
    mesh: ``devices`` is a numpy object array of ``torch.device``."""

    axis_names = ("stream", "space")

    def __init__(self, devices):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid of devices, "
                             f"got shape {grid.shape}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = _device(d)

    @property
    def shape(self) -> tuple[int, int]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list[torch.device]:
        """Every shard's device, row by row."""
        return list(self.devices.flat)

    @property
    def first(self) -> torch.device:
        """The device that reductions and gathers land on."""
        return self.devices[0, 0]


def make_mesh(devices=None, stream_axis: int | None = None) -> Mesh:
    """Factor the device list into a ("stream", "space") mesh, the most
    balanced 2-D factorisation first; a prime count becomes (n, 1).
    ``devices=None`` means every visible card (raises without one).  The
    list may repeat a device."""
    if devices is None:
        resolve("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if stream_axis is None:
        stream_axis = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                stream_axis = n // f
                break
    if n == 0 or n % stream_axis:
        raise ValueError(f"{n} devices do not form {stream_axis} mesh rows")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(stream_axis, n // stream_axis))


def mesh_of(device: torch.device | str = "cuda") -> Mesh:
    """The mesh of an entry point given a device: every visible card for
    ``cuda`` with no index, as the reference's ``make_mesh()`` default;
    else a mesh of that one device."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh()
    return make_mesh([dev])


def shard_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """[start, stop) of ``n`` items cut into ``parts`` runs whose sizes
    differ by at most one, the longer first (``np.array_split``); runs past
    the items are empty."""
    base, extra = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def scatter(x: torch.Tensor, devices: list[torch.device],
            dim: int = 0) -> list[torch.Tensor | None]:
    """``x`` cut along ``dim`` into one contiguous chunk per device (sizes as
    ``shard_bounds``), each chunk its own copy on its device; ``None`` for a
    device that gets no item."""
    out = []
    for dev, (a, b) in zip(devices, shard_bounds(x.shape[dim],
                                                 len(devices))):
        if a == b:
            out.append(None)
            continue
        chunk = x.narrow(dim, a, b - a)
        # a chunk that stays on x's device is copied all the same: shards
        # on one device never share memory with each other or with x
        out.append(chunk.to(dev, copy=True).contiguous())
    return out


def gather(chunks: list[torch.Tensor | None], device: torch.device,
           dim: int = 0) -> torch.Tensor:
    """The non-empty chunks moved to ``device`` and joined along ``dim``, in
    shard order."""
    return torch.cat([c.to(device) for c in chunks if c is not None], dim)


def _checked_int16(coeffs: torch.Tensor) -> torch.Tensor:
    if coeffs.numel() and (int(coeffs.min()) < -32768
                           or int(coeffs.max()) > 32767):
        raise ValueError("coefficients do not fit int16, the kernel's input "
                         "type")
    return coeffs.to(torch.int16)


def _step(q: torch.Tensor, qstep_in: float, qstep_out: float,
          maxval: float):
    """``transcode_compute_step`` of int16 coefficients, on their device,
    with no host sync."""
    s, f, nby, nbx, b, _ = q.shape
    q2 = transcode_coeffs(q.reshape(s * f, nby, nbx, b, b), qstep_in,
                          qstep_out, maxval, 1, 1).reshape(q.shape)

    def pixels_of(c, step):
        pix = deblockify(idct2d(c.to(torch.float32) * step))
        return torch.clamp(torch.round(pix), 0.0, maxval)

    pixels = pixels_of(q, qstep_in)
    recon = pixels_of(q2, qstep_out)
    return q2, recon, ((recon - pixels) ** 2).sum(dtype=torch.float64)


def transcode_compute_step(coeffs: torch.Tensor, qstep_in: float,
                           qstep_out: float, maxval: float):
    """All-intra transcode of integer coefficients (S, F, nby, nbx, 16, 16)
    on their device -> (q2 int16 of the same shape, recon float32
    (S, F, H, W), mse a float32 0-d tensor: the mean squared error of the
    recon against the input's pixels, summed in float64).

    q2 comes from the fused transcode (``ops.transcode.transcode_coeffs``:
    the Hopper kernel on a card, its plain version on the CPU) at GOP 1 -> 1:
    dequantise, IDCT, round and clip the pixels to [0, maxval], DCT,
    deadzone-quantise at the intra deadzone.  The kernel clips q2 to
    +/-32767; the reference's step does not, so the two differ only where a
    coefficient would leave that range.  The recon and the pixels it is
    compared with are torch ops with ``ops/dct.py``.  Coefficients that do
    not fit int16 raise ``ValueError``."""
    q2, recon, sse = _step(_checked_int16(coeffs), qstep_in, qstep_out,
                           maxval)
    return q2, recon, (sse / max(recon.numel(), 1)).to(torch.float32)


def make_sharded_transcode_step(mesh: Mesh, block: int = 16):
    """``transcode_compute_step`` over ``mesh``: streams split over
    "stream", block rows over "space" (sizes may differ by one), each shard
    on its device.  Returns ``step(coeffs, qstep_in, qstep_out, maxval) ->
    (q2, recon, mse)``: q2 and recon gathered on the coefficients' device,
    mse the mean squared error over every shard as a float32 0-d tensor
    there (the shards' float64 sums added on the mesh's first device in
    shard order)."""

    def step(coeffs: torch.Tensor, qstep_in: float, qstep_out: float,
             maxval: float):
        if coeffs.shape[-1] != block:
            raise ValueError(f"expected {block}x{block} blocks, got "
                             f"{tuple(coeffs.shape[-2:])}")
        q = _checked_int16(coeffs)
        # launch every shard before anything comes back
        rows = []
        for row_devs, (a, b) in zip(mesh.devices,
                                    shard_bounds(q.shape[0], mesh.shape[0])):
            if a < b:
                rows.append([_step(c, qstep_in, qstep_out, maxval)
                             for c in scatter(q[a:b], list(row_devs), 2)
                             if c is not None])
        dev = coeffs.device
        q2 = gather([gather([p[0] for p in r], dev, 2) for r in rows], dev)
        recon = gather([gather([p[1] for p in r], dev, 2) for r in rows],
                       dev)
        sse = torch.zeros((), dtype=torch.float64, device=mesh.first)
        for p in (p for r in rows for p in r):
            sse = sse + p[2].to(mesh.first)
        mse = sse / max(recon.numel(), 1)
        return q2, recon, mse.to(torch.float32).to(dev)

    return step
