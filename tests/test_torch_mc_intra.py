"""The host side of the MC + intra kernel (``ops/transcode.py:
transcode_mc_intra``, ``csrc/transcode_mc_intra.cu``), on the CPU: the
plan of the planar mosaic that the wrapper hands the kernel, which streams
take the kernel and which the plain chains, and the ``kernel`` count on the
``submit`` spans with the benchmark's reader of it.  The kernel itself
runs only on a card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rabbit_transcoding_tpu_torch.ops import rbv_tools as tools
from rabbit_transcoding_tpu_torch.ops import transcode as tc
from rabbit_transcoding_tpu_torch.testdata import make_stream
from rabbit_transcoding_tpu_torch.transcoder import (
    Transcoder, TranscoderParameters, V3CReader, V3CWriter)
from rabbit_transcoding_tpu_torch.utils import timing
from rabbit_transcoding_tpu_torch.video import rbv


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_recorder():
    timing.RECORDER.clear()
    yield
    timing.RECORDER.clear()


def _kernel_planar(mu: torch.Tensor, plan) -> torch.Tensor:
    """The kernel's planar row (``planar_row``) for every row of every
    block, from the packed plan: each output takes its two taps per axis as
    mosaic indices within one block of its own, the first product an FMA
    chain, the second one that chain or two rounded products."""
    taps_h, taps_w, h_first, fused = plan
    nby, nbx = mu.shape

    def unpack(table):
        t = np.asarray(table)
        return (torch.from_numpy(t[:, 0].astype(np.int64)),
                torch.from_numpy(t[:, 1].astype(np.int64)),
                torch.from_numpy(t[:, 2].view(np.float32).copy()),
                torch.from_numpy(t[:, 3].view(np.float32).copy()))

    hi0, hi1, hw0, hw1 = unpack(taps_h)
    wi0, wi1, ww0, ww1 = unpack(taps_w)
    # every tap lies in the 3 x 3 mosaic around its block
    for i0, i1, n in ((hi0, hi1, nby), (wi0, wi1, nbx)):
        own = torch.arange(n * 16) // 16
        assert ((i0 - own).abs() <= 1).all() and ((i1 - own).abs() <= 1).all()

    def second(lo_src, hi_src, w0, w1):
        lo = lo_src * w0
        return (tools.fma(hi_src, w1, lo) if fused
                else lo + hi_src * w1)

    if h_first:
        col = tools.fma(mu[hi1], hw1[:, None], mu[hi0] * hw0[:, None])
        return second(col[:, wi0], col[:, wi1], ww0, ww1)
    row = tools.fma(mu[:, wi1], ww1, mu[:, wi0] * ww0)
    return second(row[hi0], row[hi1], hw0[:, None], hw1[:, None])


@pytest.mark.parametrize("nby,nbx", [(64, 64), (32, 32), (9, 5), (5, 9),
                                     (1, 1), (3, 7)])
def test_mc_intra_plan_is_rbv_tools_own(nby, nbx):
    plan = tc.mc_intra_plan(nby, nbx)
    taps_h, taps_w, h_first, fused = plan
    for table, n_in, n_out in ((taps_h, nby, nby * 16),
                               (taps_w, nbx, nbx * 16)):
        i0, i1, w0, w1 = tools._linear_taps(n_in, n_out)
        assert table.dtype == np.int32 and table.shape == (n_out, 4)
        assert table[:, 0].tolist() == i0.tolist()
        assert table[:, 1].tolist() == i1.tolist()
        assert table[:, 2].tolist() == w0.view(np.int32).tolist()
        assert table[:, 3].tolist() == w1.view(np.int32).tolist()
    assert (h_first, fused) == tools.planar_order(nby, nbx, vmapped=True)
    if nby == nbx and nby in (64, 32):
        # the benchmark's planes: luma 64 x 64 blocks, chroma 32 x 32
        assert h_first and fused
    rng = np.random.default_rng(nby * 100 + nbx)
    mu = torch.from_numpy(rng.uniform(0, 1023, (nby, nbx)).astype(np.float32))
    want = tools.mosaic_planar(mu, nby * 16, nbx * 16, vmapped=True)
    got = _kernel_planar(mu, plan)
    assert got.numpy().view(np.uint32).tolist() == \
        want.numpy().view(np.uint32).tolist()


def test_both_second_products_are_planned():
    # the plan carries both forms of the second product, and both orders
    assert tc.mc_intra_plan(9, 5)[2:] == (True, False)
    assert tc.mc_intra_plan(5, 9)[2:] == (False, True)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("kw,takes", [
    ({}, True),
    ({"device": torch.device("cpu")}, False),
    ({"motion": False}, False),
    ({"intra": False}, False),
    ({"deblock": True}, False),
    ({"thr_k": 8}, False),
    ({"block": 8}, False),
    ({"gop_out": 1}, False),
])
def test_only_mc_intra_streams_on_a_card_take_the_kernel(kw, takes):
    args = dict(device=CUDA, block=16, motion=True, intra=True,
                deblock=False, thr_k=0, gop=2, gop_out=2)
    args.update(kw)
    assert tc.mc_intra_applies(**args) is takes


def _plane(seed=0, f=4, nby=4, nbx=4, gop=2):
    rng = np.random.default_rng(seed)
    q = np.round(rng.laplace(scale=6.0, size=(f, nby, nbx, 16, 16)))
    q[::gop, ..., 0, 0] = rng.integers(0, 400, size=q[::gop, ..., 0, 0].shape)
    mv = rng.integers(0, 49, size=(f, nby, nbx)).astype(np.int32)
    imode = rng.integers(0, 2, size=(-(-f // gop), nby, nbx)).astype(np.uint8)
    return (torch.from_numpy(q.astype(np.int16)), torch.from_numpy(mv),
            torch.from_numpy(imode))


@pytest.mark.parametrize("deblock,thr_k", [(False, 0), (True, 0), (False, 6)])
def test_cpu_tensors_deblocking_and_thresholds_run_the_plain_chains(
        monkeypatch, deblock, thr_k):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(rbv, "transcode_mc_intra", refuse)
    q, mv, imode = _plane()
    qs_in, qs_out = rbv._f32(rbv.qstep_of(22)), rbv._f32(rbv.qstep_of(42))
    launches = tc.MC_INTRA_LAUNCHES
    got_q, got_mode = rbv.transcode_chains(q, mv, imode, qs_in, qs_out,
                                           1023.0, 2, 2, deblock, True,
                                           thr_k)
    assert tc.MC_INTRA_LAUNCHES == launches
    pixels = tc.decode_chain(q, qs_in, 1023.0, 2, deblock, imode, mv)
    want = tc.encode_chain(pixels, qs_out, 1023.0, 2, recon=False,
                           deblock=deblock, thr_k=thr_k, intra=True, mv=mv)
    assert torch.equal(got_q, want["q"])
    assert torch.equal(got_mode, want["mode"])
    if not deblock and not thr_k:
        # the kernel's wrapper takes its plain twin for a CPU tensor
        monkeypatch.undo()
        assert tc.MC_INTRA_LAUNCHES == launches
        twin = tc.transcode_mc_intra(q, mv, imode, qs_in, qs_out, 1023.0, 2)
        assert tc.MC_INTRA_LAUNCHES == launches
        assert torch.equal(twin[0], got_q) and torch.equal(twin[1], got_mode)


def _transcode_cpu(data: bytes) -> bytes:
    reader, writer = V3CReader(), V3CWriter()
    context = reader.decode(reader.read(data)[0])
    Transcoder(TranscoderParameters(geometryQP=32, attributeQP=42),
               "cpu").transcode(context)
    return writer.write(writer.encode(context))


def test_a_cpu_submit_span_names_no_kernel():
    data = make_stream(4, 64, 64, motion=True, intra=True)
    with profile(activities=[ProfilerActivity.CPU]):
        _transcode_cpu(data)
    submits = [s for s in timing.RECORDER.spans if s.name == "submit"]
    assert len(submits) == 4  # geometry Y; attribute Y, U, V
    assert not any("kernel" in s.counts for s in submits)


def test_note_kernel_names_only_the_enclosing_submit_span():
    tc.note_kernel("mc_intra")  # outside a profiler: nothing to name
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("submit") as sub:
            tc.note_kernel("mc_intra")
        with timing.span("entropy_encode") as other:
            tc.note_kernel("gops")
        tc.note_kernel("gops")  # no open span
    assert sub.counts == {"kernel": "mc_intra"}
    assert other.counts == {}


def _submit(t0, t1, kernel=None):
    s = timing.Span("submit")
    s.t0, s.t1, s.thread = t0, t1, 1
    s.counts = {} if kernel is None else {"kernel": kernel}
    return s


@pytest.mark.parametrize("kernels,want", [
    (["mc_intra", "mc_intra", "gops", "mc_intra"], 100.0),
    (["mc_intra", None, None, "gops"], 50.0),
    ([None, None], 0.0),
    ([], None),
])
def test_kernel_submit_pct_reads_the_share_of_named_submits(
        monkeypatch, kernels, want):
    from benchmark import cells, harness

    spans = [_submit(1.0 + i, 1.5 + i, k) for i, k in enumerate(kernels)]
    # a span outside the window is not read
    spans.append(_submit(20.0, 21.0))
    monkeypatch.setattr(timing.RECORDER, "spans", spans)
    r = harness.Reading(cells.load("mcintra-depth1"), [],
                        [harness.Gof(0, 0.0, 10.0, 32)], 0.0, 10.0, [])
    got = harness.read_metric("kernel_submit_pct", r)
    assert got == (None if want is None else pytest.approx(want))
