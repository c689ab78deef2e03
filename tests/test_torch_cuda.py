"""The port's CUDA kernel against its plain PyTorch version, on the GPU.

Marked ``cuda``: skipped where there is no CUDA device (the kernel has no
CPU mode).  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu_torch.ops import transcode as tc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qs(qp: int) -> float:
    return float(np.float32(2.0 ** ((qp - 4.0) / 6.0)))


@pytest.mark.parametrize("gop_in,gop_out", [(1, 1), (2, 2), (4, 4), (2, 1),
                                            (1, 2), (3, 2)])
def test_kernel_matches_plain_version(cuda, gop_in, gop_out):
    rng = np.random.default_rng(0)
    c = torch.from_numpy(
        rng.integers(-60, 60, size=(5, 3, 4, 16, 16)).astype(np.int16)
    ).to(cuda)
    args = (c, _qs(16), _qs(32), 1023.0, gop_in, gop_out)
    before = tc.LAUNCHES
    got = tc.transcode_coeffs(*args)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == before + 1
    want = tc.transcode_coeffs_ref(*args)
    # both sum in the same order: exact, as on the CPU
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tc.transcode_coeffs_ref(c.cpu(), *args[1:]))


def test_kernel_rejects_bad_input(cuda):
    c = torch.zeros((2, 1, 1, 8, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        tc.transcode_coeffs(c, 1.0, 2.0, 255.0, 1, 1)
    with pytest.raises(TypeError):
        tc.transcode_coeffs(c.to(torch.int32), 1.0, 2.0, 255.0, 1, 1)


def test_kernel_on_every_device_while_device_0_is_current(cuda):
    # the kernel library links its own CUDA runtime: it must launch on the
    # tensor's card, not on its own current device, and leave the caller's
    # current device as it found it
    rng = np.random.default_rng(1)
    c = rng.integers(-60, 60, size=(4, 2, 3, 16, 16)).astype(np.int16)
    want = tc.transcode_coeffs_ref(torch.from_numpy(c), _qs(16), _qs(32),
                                   1023.0, 2, 2)
    torch.cuda.set_device(0)
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        got = tc.transcode_coeffs(torch.from_numpy(c).to(dev), _qs(16),
                                  _qs(32), 1023.0, 2, 2)
        torch.cuda.synchronize(dev)
        assert got.device == dev
        assert torch.equal(got.cpu(), want)
    assert torch.cuda.current_device() == 0


def _moving_frames(f=4, h=48, w=64, move=4):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(2)
    return np.stack([
        np.clip(512 + 300 * np.sin((xx + move * k) / 9.0) * np.cos(yy / 7.0)
                + rng.normal(scale=8.0, size=(h, w)), 0, 1023)
        for k in range(f)]).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(search=True, intra=True, weighted=True),
    dict(search=True, deblock=True, thr_k=8),
    dict(intra=True, deblock=True, thr_k=8),
])
def test_coding_tools_on_the_card_equal_the_cpu(cuda, kw):
    # the plain chains spell out every order and rounding that feeds a
    # rounding, so the card computes the CPU's values bit for bit
    from rabbit_transcoding_tpu_torch.ops.dct import blockify

    kw = dict(kw)
    frames = torch.from_numpy(_moving_frames())
    weights = (frames > 400).to(torch.float32) if kw.pop("weighted", False) \
        else None
    qs = _qs(26)
    want = tc.encode_chain(blockify(frames, 16), qs, 1023.0, 2,
                           weights=weights, **kw)
    got = tc.encode_chain(
        blockify(frames.to(cuda), 16), qs, 1023.0, 2,
        weights=None if weights is None else weights.to(cuda), **kw)
    for key in ("q", "rec", "mode", "mv"):
        if want[key] is not None:
            assert torch.equal(got[key].cpu(), want[key]), key
    mode, mv = want["mode"], want["mv"]
    dec_args = (qs, 1023.0, 2, kw.get("deblock", False))
    want_dec = tc.decode_chain(want["q"], *dec_args, mode, mv)
    got_dec = tc.decode_chain(
        want["q"].to(cuda), *dec_args,
        None if mode is None else mode.to(cuda),
        None if mv is None else mv.to(cuda))
    assert torch.equal(got_dec.cpu(), want_dec)


def test_requant_on_the_card_equals_the_cpu(cuda):
    from rabbit_transcoding_tpu_torch.ops import rbv_tools as tools

    rng = np.random.default_rng(3)
    q = torch.from_numpy(np.round(rng.laplace(
        scale=8.0, size=(5, 3, 4, 16, 16))).astype(np.int16))
    for fn in (lambda x: tools.requant(x, _qs(20), _qs(27)),
               lambda x: tools.requant_compensated(x, _qs(20), _qs(27), 2)):
        assert torch.equal(fn(q.to(cuda)).cpu(), fn(q))


@pytest.mark.parametrize("mode", ["reencode", "requant"])
def test_mc_intra_stream_transcodes_on_the_card_as_on_the_cpu(cuda, mode):
    from rabbit_transcoding_tpu_torch.testdata import make_stream
    from rabbit_transcoding_tpu_torch.transcoder import (
        Transcoder, TranscoderParameters, V3CReader, V3CWriter)

    data = make_stream(4, 64, 64, device=cuda, motion=True, intra=True)
    assert data == make_stream(4, 64, 64, motion=True, intra=True)
    params = TranscoderParameters(geometryQP=32, attributeQP=42, mode=mode)

    def run(device) -> bytes:
        reader = V3CReader()
        context = reader.decode(reader.read(data)[0])
        Transcoder(params, device).transcode(context)
        writer = V3CWriter()
        return writer.write(writer.encode(context))

    before = tc.LAUNCHES
    assert run(cuda) == run(torch.device("cpu"))
    assert tc.LAUNCHES == before  # these branches run the plain chains


def test_batched_kernel_equals_single_launches_and_plain_version(cuda):
    # one launch over the stream axis, per-stream steps read on the card:
    # bit-identical to one single-stream launch per stream
    rng = np.random.default_rng(4)
    c = torch.from_numpy(
        rng.integers(-60, 60, size=(3, 5, 2, 3, 16, 16)).astype(np.int16)
    ).to(cuda)
    qps_in, qps_out = (16, 20, 24), (30, 34, 28)
    qs_in = torch.tensor([_qs(q) for q in qps_in], device=cuda)
    qs_out = torch.tensor([_qs(q) for q in qps_out], device=cuda)
    for gop_in, gop_out in ((2, 2), (2, 1), (3, 2)):
        launches, batched = tc.LAUNCHES, tc.BATCHED_LAUNCHES
        got = tc.transcode_coeffs_batched(c, qs_in, qs_out, 1023.0, gop_in,
                                          gop_out)
        torch.cuda.synchronize()
        assert tc.LAUNCHES == launches + 1
        assert tc.BATCHED_LAUNCHES == batched + 1
        for si in range(3):
            single = tc.transcode_coeffs(c[si].contiguous(), _qs(qps_in[si]),
                                         _qs(qps_out[si]), 1023.0, gop_in,
                                         gop_out)
            assert torch.equal(got[si], single)
        want = tc.transcode_coeffs_batched_ref(c, qs_in, qs_out, 1023.0,
                                               gop_in, gop_out)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), tc.transcode_coeffs_batched_ref(
            c.cpu(), qs_in.cpu(), qs_out.cpu(), 1023.0, gop_in, gop_out))


def test_batched_kernel_rejects_bad_steps(cuda):
    c = torch.zeros((2, 2, 1, 1, 16, 16), dtype=torch.int16, device=cuda)
    good = torch.ones(2, device=cuda)
    for bad in (torch.ones(3, device=cuda), torch.ones(2),
                torch.ones(2, dtype=torch.float64, device=cuda)):
        with pytest.raises(ValueError):
            tc.transcode_coeffs_batched(c, bad, good, 255.0, 1, 1)


@pytest.mark.parametrize("kw,launches", [
    ({}, 4),  # one batched launch per plane for all three streams
    ({"mode": "requant"}, 0),
    ({"motion": True, "intra": True}, 0),
    ({"geometryCoeffThreshold": 6}, 3),  # geometry: the plain chain
])
def test_multistream_on_the_card_equals_the_sequential_port(cuda, kw,
                                                            launches):
    from rabbit_transcoding_tpu_torch.testdata import (
        make_stream,
        with_input_qps,
    )
    from rabbit_transcoding_tpu_torch.transcoder import (
        MultiStreamTranscoder, Transcoder, TranscoderParameters, V3CReader,
        V3CWriter)

    kw = dict(kw)
    tools = {k: kw.pop(k) for k in ("motion", "intra") if k in kw}
    base = make_stream(4, 64, 64, device=cuda, **tools)
    streams = [base] + [with_input_qps(base, q, q + 6, cuda)
                        for q in (18, 20)]
    params = TranscoderParameters(geometryQP=32, attributeQP=42, **kw)
    reader = V3CReader()

    def write(ctx) -> bytes:
        writer = V3CWriter()
        return writer.write(writer.encode(ctx))

    seq = []
    for data in streams:
        ctx = reader.decode(reader.read(data)[0])
        Transcoder(params, cuda).transcode(ctx)
        seq.append(write(ctx))
    ctxs = [reader.decode(reader.read(d)[0]) for d in streams]
    batched = tc.BATCHED_LAUNCHES
    MultiStreamTranscoder(params, cuda).transcode_many(ctxs)
    assert [write(c) for c in ctxs] == seq
    assert tc.BATCHED_LAUNCHES - batched == launches


def test_launch_counts_survive_concurrent_launches(cuda):
    # the batched path launches from one thread per plane: more threads
    # than host cores, a short switch interval, and no count may be lost
    import concurrent.futures as cf
    import sys

    c = torch.zeros((2, 2, 1, 2, 16, 16), dtype=torch.int16, device=cuda)
    qs = torch.ones(2, device=cuda)

    def launch_both(_):
        for _ in range(8):
            tc.transcode_coeffs(c[0], 1.0, 2.0, 255.0, 2, 2)
            tc.transcode_coeffs_batched(c, qs, qs * 2, 255.0, 2, 2)

    launches, batched = tc.LAUNCHES, tc.BATCHED_LAUNCHES
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(max_workers=32) as ex:
            list(ex.map(launch_both, range(32), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert tc.LAUNCHES - launches == 32 * 16
    assert tc.BATCHED_LAUNCHES - batched == 32 * 8


# --- the Hopper design: bit-identical to the plain version everywhere -------
def _coeffs(cuda, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(-60, 60, size=shape).astype(np.int16)).to(cuda)


@pytest.mark.parametrize("n_blocks", [1, 3, 12, 4097])
@pytest.mark.parametrize("gop_in,gop_out", [(1, 1), (2, 2), (4, 4), (2, 3),
                                            (3, 2)])
def test_kernel_ragged_blocks_and_gops(cuda, n_blocks, gop_in, gop_out):
    # n_blocks need not fill the last CTA: its idle block positions store
    # nothing; 4097 is one past the main path's 64 x 64
    c = _coeffs(cuda, (6, 1, n_blocks, 16, 16), seed=n_blocks + gop_out)
    args = (c, _qs(16), _qs(32), 1023.0, gop_in, gop_out)
    got = tc.transcode_coeffs(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tc.transcode_coeffs_ref(*args))


@pytest.mark.parametrize("streams", [1, 2, 3, 4, 5])
def test_batched_kernel_per_stream_qps(cuda, streams):
    c = _coeffs(cuda, (streams, 4, 2, 5, 16, 16), seed=streams)
    qs_in = torch.tensor([_qs(14 + 3 * i) for i in range(streams)],
                         device=cuda)
    qs_out = torch.tensor([_qs(40 - 2 * i) for i in range(streams)],
                          device=cuda)
    got = tc.transcode_coeffs_batched(c, qs_in, qs_out, 1023.0, 2, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, tc.transcode_coeffs_batched_ref(
        c, qs_in, qs_out, 1023.0, 2, 2))


@pytest.mark.parametrize("case", ["identity_qp", "clamp", "maxval_255",
                                  "maxval_1023"])
def test_kernel_edge_cases(cuda, case):
    c = _coeffs(cuda, (4, 3, 4, 16, 16), seed=11)
    qs_in, qs_out, maxval = _qs(16), _qs(32), 1023.0
    if case == "identity_qp":
        qs_out = qs_in
    elif case == "clamp":  # a tiny output step: quantised values hit +-32767
        qs_in, qs_out = _qs(40), 1e-3
    elif case == "maxval_255":
        maxval = 255.0
    args = (c, qs_in, qs_out, maxval, 2, 2)
    got = tc.transcode_coeffs(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tc.transcode_coeffs_ref(*args))
    if case == "clamp":
        assert int(got.abs().max()) == 32767


def test_kernel_rejects_misaligned_input(cuda):
    flat = torch.zeros(2 * 256 + 8, dtype=torch.int16, device=cuda)
    c = flat[1:1 + 2 * 256].view(2, 1, 1, 16, 16)  # 2 bytes past alignment
    assert c.is_contiguous() and c.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        tc.transcode_coeffs(c, 1.0, 2.0, 255.0, 1, 1)


def test_kernel_rejects_dead_zones_outside_0_1(cuda):
    # the kernel quantises an exact zero to 0 without the division, which is
    # floor(dz) only for 0 <= dz < 1: the C entry point refuses other zones
    from rabbit_transcoding_tpu_torch.ops import _build
    from rabbit_transcoding_tpu_torch.ops.dct import dct_tensor

    c = _coeffs(cuda, (2, 1, 1, 16, 16), seed=3)
    out = torch.empty_like(c)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    index = torch.cuda.current_device()
    for dz_intra, dz_inter in ((1.0, 0.25), (0.5, -0.25), (0.5, 1.5)):
        err = lib.rbv_transcode_gops(
            c.data_ptr(), out.data_ptr(), dct_tensor(16, cuda).data_ptr(), 2,
            1, 2, 2, _qs(16), _qs(32), 1023.0, dz_intra, dz_inter, index,
            stream)
        assert lib.rbv_cuda_error_string(err).decode() == "invalid argument"
    assert lib.rbv_transcode_gops(
        c.data_ptr(), out.data_ptr(), dct_tensor(16, cuda).data_ptr(), 2, 1,
        2, 2, _qs(16), _qs(32), 1023.0, 0.5, 1.0 / 3.0, index, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, tc.transcode_coeffs_ref(c, _qs(16), _qs(32),
                                                    1023.0, 2, 2))


def test_entry_points_default_to_the_card(cuda):
    from rabbit_transcoding_tpu_torch.transcoder import (
        MultiStreamTranscoder, Transcoder)
    from rabbit_transcoding_tpu_torch.utils.enums import CodecId
    from rabbit_transcoding_tpu_torch.video import VideoDecoder, VideoEncoder

    for obj in (Transcoder(), MultiStreamTranscoder(),
                VideoEncoder.create(CodecId.RBV),
                VideoDecoder.create(CodecId.RBV)):
        assert obj.device.type == "cuda"
