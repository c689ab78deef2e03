"""The plain reference: its reader of V3C, RBV and the three entropy back
ends against the program's on tiny streams, its chains against the
program's transcode, and its independence from the program."""

import ast
import os

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.reference import chains, check, stream

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["gop2-depth3", "mcintra-depth1"])
def tiny_stream(request):
    from benchmark import cells

    cell = cells.load(request.param)
    cell.config["atlas"].update(width=128, height=128, frames=4)
    return cell, gen.stream(cell.config, 2**31 + 7, CPU)


def test_reference_imports_nothing_of_the_program_or_jax():
    for name in sorted(os.listdir(os.path.join(HERE, "reference"))):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(HERE, "reference", name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("numpy", "torch", "struct",
                                           "zlib", "dataclasses",
                                           "functools", "contextlib",
                                           "contextvars", "__future__"), m


def test_plain_decode_equals_the_programs(tiny_stream):
    from rabbit_transcoding_tpu_torch.bitstream import V3CReader
    from rabbit_transcoding_tpu_torch.video import rbv

    _, data = tiny_stream
    reader = V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    gof = check.parse(data)
    for vt, vb in atlas.video_bitstreams.items():
        unit = {0: stream.OVD, 1: stream.GVD, 5: stream.AVD}[vt.value]
        video = gof.videos[unit]
        want = rbv.decode(vb.data, CPU)
        for k, pl in enumerate(video.planes):
            got = (pl.samples if pl.samples is not None else
                   check.samples(video.header, pl, CPU).to(
                       torch.int32).numpy())
            np.testing.assert_array_equal(got, want.planes[k].astype(
                got.dtype))


@pytest.mark.parametrize("backend", ["R", "B"])
def test_rans_back_ends_read_back(backend):
    from rabbit_transcoding_tpu_torch import native

    rng = np.random.default_rng(3)
    f, kmax, nby, nbx = 3, 20, 4, 5
    slab = (rng.geometric(0.4, (f, kmax, nby, nbx))
            * (rng.random((f, kmax, nby, nbx)) < 0.3)
            * rng.choice([-1, 1], (f, kmax, nby, nbx))).astype(np.int16)
    slab[1, 3, 2, 2] = -32767
    coded = slab.copy()
    dc = coded[:, 0].reshape(f, -1).astype(np.int32)
    coded[:, 0] = np.diff(dc, axis=1, prepend=0).astype(np.int16).reshape(
        f, nby, nbx)
    head = b"\x03" + kmax.to_bytes(2, "little")
    if backend == "R":
        blob = head + b"R" + native.compress_i16(coded)
    else:
        starts = [0, 1, 4, 16]
        segs = stream._band_segments(f, kmax, nby * nbx, starts)
        blob = (head + b"B" + bytes([len(starts)])
                + b"".join(s.to_bytes(2, "little") for s in starts)
                + native.compress_i16_bands(coded, segs, len(starts)))
    np.testing.assert_array_equal(stream._slab(blob, f, nby, nbx), slab)


def test_zigzag_walks_the_anti_diagonals():
    zz = stream.zigzag(4)
    assert zz[:6].tolist() == [0, 1, 4, 8, 5, 2]
    assert sorted(zz.tolist()) == list(range(16))


def test_reference_transcode_equals_the_programs(tiny_stream):
    from benchmark import transcode

    cell, data = tiny_stream
    from rabbit_transcoding_tpu_torch.transcoder import Transcoder

    ctx = transcode.read_v3c(data)
    Transcoder(transcode.params(cell.config), CPU).transcode(ctx)
    out = transcode.write_v3c(ctx)
    want = check.expected(data, {stream.GVD: 32, stream.AVD: 42}, 2, CPU)
    numbers = check.compare(want, check.parse(out), CPU)
    assert all(v == 0 for v in numbers.values()), numbers


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10 - 2**-23,
                      -3.0], dtype=torch.float32)
    got = chains._tf32(x).tolist()
    assert got == [1.0, 1.0 + 2**-9, 1.0 + 2**-10, -3.0]
