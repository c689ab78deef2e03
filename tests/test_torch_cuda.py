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

    before, mc_intra = tc.LAUNCHES, tc.MC_INTRA_LAUNCHES
    assert run(cuda) == run(torch.device("cpu"))
    # no transcode_gops launch; reencode runs the MC + intra kernel, requant
    # rescales in the coefficient domain
    assert tc.LAUNCHES == before
    if mode == "reencode":
        assert tc.MC_INTRA_LAUNCHES > mc_intra
    else:
        assert tc.MC_INTRA_LAUNCHES == mc_intra


def _mc_intra_input(seed, f, nby, nbx, gop, qs_in, maxval):
    """Coefficients of an MC + intra stream (I-frame DCs that decode inside
    [0, maxval]), its motion vectors (every offset, so edge blocks reach
    past the picture) and mode maps (both modes)."""
    rng = np.random.default_rng(seed)
    q = np.round(rng.laplace(scale=6.0, size=(f, nby, nbx, 16, 16)))
    q[::gop, ..., 0, 0] = rng.integers(
        0, int(maxval * 16 / qs_in), size=q[::gop, ..., 0, 0].shape)
    mv = rng.integers(0, 49, size=(f, nby, nbx)).astype(np.int32)
    imode = rng.integers(0, 2, size=(-(-f // gop), nby, nbx)).astype(np.uint8)
    return (torch.from_numpy(q.astype(np.int16)), torch.from_numpy(mv),
            torch.from_numpy(imode))


def _assert_mc_intra_kernel_is_its_twin(cuda, q, mv, imode, qs_in, qs_out,
                                        maxval, gop):
    on = [x.to(cuda) for x in (q, mv, imode)]
    steps = [s.to(cuda) if isinstance(s, torch.Tensor) else s
             for s in (qs_in, qs_out)]
    before = tc.MC_INTRA_LAUNCHES
    got_q, got_mode = tc.transcode_mc_intra(*on, *steps, maxval, gop)
    torch.cuda.synchronize()
    assert tc.MC_INTRA_LAUNCHES == before + gop + 1
    want_q, want_mode = tc.transcode_mc_intra_ref(*on, *steps, maxval, gop)
    assert torch.equal(got_q, want_q)
    assert torch.equal(got_mode, want_mode)
    cpu_q, cpu_mode = tc.transcode_mc_intra_ref(q, mv, imode, qs_in, qs_out,
                                                maxval, gop)
    assert torch.equal(got_q.cpu(), cpu_q)
    assert torch.equal(got_mode.cpu(), cpu_mode)
    return got_mode


@pytest.mark.parametrize("f,nby,nbx,gop,maxval", [
    (4, 8, 8, 2, 1023.0),    # 10-bit 4:0:0
    (4, 8, 8, 2, 255.0),     # 8-bit 4:2:0 luma
    (4, 4, 4, 2, 255.0),     # and its chroma
    (2, 32, 32, 2, 255.0),   # 512 x 512 chroma of a 1024 x 1024 atlas
    (8, 6, 5, 4, 1023.0),    # GOP 4: both pairs of planes in turn
    (5, 3, 7, 2, 1023.0),    # ragged F, and mosaics whose second resize
    (7, 9, 5, 4, 255.0),     # products are rounded, not fused
    (3, 1, 1, 2, 1023.0),    # one block: every gather clamped
    (3, 2, 3, 1, 1023.0),    # GOP 1: I frames only
])
def test_mc_intra_kernel_equals_the_plain_chains(cuda, f, nby, nbx, gop,
                                                 maxval):
    qs_in, qs_out = _qs(22), _qs(42)
    q, mv, imode = _mc_intra_input(f * nby + nbx, f, nby, nbx, gop, qs_in,
                                   maxval)
    mode = _assert_mc_intra_kernel_is_its_twin(cuda, q, mv, imode, qs_in,
                                               qs_out, maxval, gop)
    if nby * nbx >= 16:
        assert 0 < int(mode.sum()) < mode.numel()  # both intra modes


def test_mc_intra_kernel_stacked_streams_with_per_frame_steps(cuda):
    # S = 4 streams of different QPs stacked on the frame axis, each padded
    # to whole GOPs, as parallel/multistream.py:run_shard hands them over
    s, fp, gop, nby, nbx = 4, 6, 2, 8, 8
    q, mv, imode = _mc_intra_input(7, s * fp, nby, nbx, gop, _qs(16), 1023.0)
    qs_in = torch.tensor([_qs(q) for q in (16, 18, 20, 22)]
                         ).repeat_interleave(fp)
    qs_out = torch.tensor([_qs(q) for q in (32, 30, 36, 42)]
                          ).repeat_interleave(fp)
    _assert_mc_intra_kernel_is_its_twin(cuda, q, mv, imode, qs_in, qs_out,
                                        1023.0, gop)


def test_mc_intra_kernel_on_encoder_streams(cuda):
    # the coefficients, motion vectors and modes the port's encoder writes:
    # 10-bit 4:0:0 geometry and 8-bit 4:2:0 attribute
    from rabbit_transcoding_tpu_torch.testdata import (make_stream,
                                                       stream_planes)
    from rabbit_transcoding_tpu_torch.video import rbv

    data = make_stream(4, 128, 128, motion=True, intra=True)
    planes = stream_planes(data)
    assert sorted(planes) == [("ATTRIBUTE", 0), ("ATTRIBUTE", 1),
                              ("ATTRIBUTE", 2), ("GEOMETRY", 0)]
    for (kind, _), pl in planes.items():
        maxval = 1023.0 if kind == "GEOMETRY" else 255.0
        _assert_mc_intra_kernel_is_its_twin(
            cuda, pl.q, torch.from_numpy(pl.mv), torch.from_numpy(pl.mode),
            rbv._f32(rbv.qstep_of(22)), rbv._f32(rbv.qstep_of(42)), maxval,
            2)


def test_mc_intra_kernel_rejects_bad_input(cuda):
    q, mv, imode = (x.to(cuda) for x in _mc_intra_input(
        1, 4, 2, 2, 2, _qs(22), 255.0))
    with pytest.raises(ValueError):
        tc.transcode_mc_intra(q, mv[:3], imode, 1.0, 2.0, 255.0, 2)
    with pytest.raises(ValueError):
        tc.transcode_mc_intra(q, mv, imode[:1], 1.0, 2.0, 255.0, 2)
    with pytest.raises(ValueError):
        tc.transcode_mc_intra(q, mv, imode, torch.ones(3, device=cuda), 2.0,
                              255.0, 2)
    with pytest.raises(TypeError):
        tc.transcode_mc_intra(q.to(torch.int32), mv, imode, 1.0, 2.0, 255.0,
                              2)


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
    # one card: an unindexed device would shard over every visible card
    MultiStreamTranscoder(params, torch.device("cuda", 0)).transcode_many(
        ctxs)
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


# --- the decoder's device functions: the card against the CPU ----------------
# (small, and the decode cell's full size: 1024x1024, 256 patches)
_SIZES = [(2, 128, 128), (4, 1024, 1024)]


def _decoder_planes(f, h, w, seed=0):
    rng = np.random.default_rng(seed)
    blocks = rng.random((f, h // 16, w // 16)) < 0.5
    occ = np.repeat(np.repeat(blocks, 16, 1), 16, 2)
    occ = (occ & (rng.random((f, h, w)) < 0.95)).astype(np.uint8)
    geo = rng.integers(0, 1024, (f, h, w)).astype(np.int32)
    return torch.from_numpy(occ), torch.from_numpy(geo)


def _decoder_table(f, h, w):
    from rabbit_transcoding_tpu_torch.codec.patch_frame import _intra_patch
    from rabbit_transcoding_tpu_torch.ops.reproject import build_patch_table
    from rabbit_transcoding_tpu_torch.testdata import patch_units

    patches = [_intra_patch(du, i, 16, 16, 16, 0)
               for i, du in enumerate(patch_units(w, h))]
    table, counts = build_patch_table([patches] * f,
                                      -(-len(patches) // 32) * 32)
    return torch.from_numpy(table), torch.from_numpy(counts)


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("size", _SIZES)
@pytest.mark.parametrize("reverse", [False, True])
def test_reproject_on_the_card_equals_the_cpu(cuda, size, reverse):
    from rabbit_transcoding_tpu_torch.ops import reproject as rp

    occ, geo = _decoder_planes(*size)
    table, counts = _decoder_table(*size)
    want = rp.reproject(geo, occ, table, counts, 16, reverse)
    got = rp.reproject(geo.to(cuda), occ.to(cuda), table.to(cuda),
                       counts.to(cuda), 16, reverse)
    _same(got, want)
    assert want[1].any()


@pytest.mark.parametrize("size", _SIZES)
def test_occupancy_and_interleave_on_the_card_equal_the_cpu(cuda, size):
    from rabbit_transcoding_tpu_torch.codec.reconstruct import (
        occupancy_boundary,
    )
    from rabbit_transcoding_tpu_torch.ops import interleave, occupancy
    from rabbit_transcoding_tpu_torch.ops import reproject as rp

    occ, geo = _decoder_planes(*size, seed=1)
    table, counts = _decoder_table(*size)
    _same(occupancy.binarize((occ * 200).to(cuda), 127),
          occupancy.binarize(occ * 200, 127))
    _same(occupancy.prefilter_lossy_om((occ * 255).to(cuda)),
          occupancy.prefilter_lossy_om(occ * 255))
    owner = occupancy.upsample_nearest(
        rp.block_to_patch(occ, table, counts, 16), 16)
    smooth = (geo // 64 + 200).to(torch.int32)
    for radius in (1, 2):
        _same(occupancy.pbf_refine(occ.to(cuda), smooth.to(cuda),
                                   owner.to(cuda), 4.0, 2, radius),
              occupancy.pbf_refine(occ, smooth, owner, 4.0, 2, radius))
    _same(interleave.deinterleave_maps(geo.to(cuda), occ.to(cuda), 4),
          interleave.deinterleave_maps(geo, occ, 4))
    _same(occupancy_boundary(occ.to(cuda)), occupancy_boundary(occ))


@pytest.mark.parametrize("size", _SIZES)
@pytest.mark.parametrize("up_filter", [0, 4, "nearest"])
def test_colour_conversion_on_the_card_equals_the_cpu(cuda, size, up_filter):
    from rabbit_transcoding_tpu_torch.ops import color

    f, h, w = size
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.integers(0, 256, (f, h, w)).astype(np.uint8))
    u, v = (torch.from_numpy(
        rng.integers(0, 256, (f, h // 2, w // 2)).astype(np.uint8))
        for _ in range(2))
    _same(color.yuv420_to_rgb8(y.to(cuda), u.to(cuda), v.to(cuda),
                               up_filter),
          color.yuv420_to_rgb8(y, u, v, up_filter))
    yuv = torch.from_numpy(
        rng.integers(0, 65536, (h * w, 3)).astype(np.int32))
    _same(color.yuv16_to_rgb8(yuv.to(cuda)), color.yuv16_to_rgb8(yuv))


def _smoothing_cloud(n, radius, seed=0):
    """A noisy sphere surface of about 0.3 points per surface voxel."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = np.unique(np.round(500 + radius * d
                           + rng.normal(scale=1.5, size=(n, 3))
                           ).astype(np.int32), axis=0)
    rng.shuffle(p)
    n = len(p)
    # stripes that do not end on the grids' cell borders: mixed cells
    part = ((p[:, 0] // 44) + (p[:, 1] // 52) * 32).astype(np.int32)
    base = 128 + 60 * np.sin(p[:, 0] / 17.0) + 30 * np.cos(p[:, 1] / 11.0)
    col = np.clip(base[:, None] + rng.normal(scale=6, size=(n, 3)), 0,
                  255).astype(np.uint8)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (p, col, part, rng.random(n) < 0.5)]


# a small cloud, and one of a decode-cell frame's size
@pytest.mark.parametrize("n,radius", [(20_000, 75), (400_000, 330)])
def test_smoothing_grids_on_the_card_equal_the_cpu(cuda, n, radius):
    from rabbit_transcoding_tpu_torch.ops import smoothing as sm

    p, col, part, elig = _smoothing_cloud(n, radius)
    valid = torch.ones(len(p), dtype=torch.bool)
    on = [t.to(cuda) for t in (p, col, part, elig, valid)]
    _same(sm.grid_smooth(on[0], on[4], 16.0, 4.0, on[3], 8, 128),
          sm.grid_smooth(p, valid, 16.0, 4.0, elig, 8, 128))
    _same(sm.color_grid_smooth(on[0], on[1], on[4], 4.0, 8, 128),
          sm.color_grid_smooth(p, col, valid, 4.0, 8, 128))
    args = (10.0, 40.0, 30.0, 8, 128)
    first = sm.color_grid_smooth_gated(on[0], on[1], on[4], on[2], on[3],
                                       *args)
    again = sm.color_grid_smooth_gated(on[0], on[1], on[4], on[2], on[3],
                                       *args)
    # run to run the same: the scatter adds each cell's points in one order
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])
    want = sm.color_grid_smooth_gated(p, col, valid, part, elig, *args)
    assert want[1].any()
    # two clouds in one call, each in its own grid, as the wrappers batch
    group = torch.arange(len(p)) % 2
    got = sm.color_grid_smooth_gated(on[0], on[1], on[4], on[2], on[3],
                                     *args, group.to(cuda), 2)
    want2 = sm.color_grid_smooth_gated(p, col, valid, part, elig, *args,
                                       group, 2)
    assert (got[0].cpu() != want2[0]).any(dim=1).float().mean() <= 1e-4
    # against the CPU's serial sums: equal, or a luma sum's last bit flips
    # a gate at a few eligible points
    differ = (first[0].cpu() != want[0]).any(dim=1)
    assert differ.float().mean().item() <= 1e-4
    assert not (differ & ~elig).any()


def _faces_cloud(seed=0):
    """Points on and beyond the grid's faces (cells clamp there)."""
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 1024, (30_000, 3))
    plane[:10_000, 0] = 0
    plane[10_000:20_000, 1] = 1023
    plane[20_000:, 2] = rng.choice([-5, -1, 1023, 1030], 10_000)
    return np.unique(plane, axis=0)


def _dense_cloud():
    """Every voxel of a 24^3 cube in the grid's far corner: 27 full cells of
    512 points around a point, sums of x up to ~1.39e7, near 2^24."""
    axis = np.arange(992, 1016)
    return np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    -1).reshape(-1, 3)


def _grid_case(name):
    if name in ("20k", "400k"):
        n, radius = (20_000, 75) if name == "20k" else (400_000, 330)
        return [_smoothing_cloud(n, radius)[0].numpy()]
    if name == "2_clouds":
        return [_smoothing_cloud(20_000, 75, s)[0].numpy() for s in (1, 2)]
    if name == "8_clouds":
        return [_smoothing_cloud(400_000, 330, s)[0].numpy()
                for s in range(8)]
    return [_faces_cloud()] if name == "faces" else [_dense_cloud()]


@pytest.mark.parametrize("name", ["20k", "400k", "2_clouds", "8_clouds",
                                  "faces", "dense"])
@pytest.mark.parametrize("threshold,min_neighbors", [(16.0, 4.0),
                                                     (2.0, 170.0)])
def test_grid_kernel_equals_the_plain_filter(cuda, name, threshold,
                                             min_neighbors):
    from rabbit_transcoding_tpu_torch.ops import smoothing as sm

    clouds = _grid_case(name)
    counts = [len(c) for c in clouds]
    rng = np.random.default_rng(len(counts))
    p = torch.from_numpy(np.concatenate(clouds).astype(np.int32))
    elig = torch.from_numpy(rng.random(len(p)) < 0.5)
    before = sm.GRID_LAUNCHES
    got = sm.grid_smooth_kernel(p.to(cuda), elig.to(cuda), counts, threshold,
                                min_neighbors, 8, 128)
    torch.cuda.synchronize()
    assert sm.GRID_LAUNCHES == before + 1
    want = sm.grid_smooth(p, torch.ones(len(p), dtype=torch.bool), threshold,
                          min_neighbors, elig, 8, 128,
                          sm.cloud_index(counts, "cpu"), len(counts))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    if name == "dense":
        # the largest 27-cell sum of x lies just below 2^24
        cell = torch.div(p, 8, rounding_mode="floor").long()
        acc = torch.zeros(128 ** 3, dtype=torch.long).index_add_(
            0, (cell[:, 0] * 128 + cell[:, 1]) * 128 + cell[:, 2],
            p[:, 0].long())
        total = sum(acc[(((cell[:, 0] + dx).clamp(0, 127) * 128
                          + (cell[:, 1] + dy).clamp(0, 127)) * 128
                         + (cell[:, 2] + dz).clamp(0, 127))]
                    for dx, dy, dz in sm._OFFSETS)
        assert 0.8 * 2 ** 24 < int(total.max()) < 2 ** 24
    # the filter moves points, and the density test drops some
    moved, keep = want[2], want[1]
    assert moved.any() or name == "faces"
    assert not keep.all() or name == "dense" or min_neighbors == 4.0
    # the twin on the card too, and the dispatch
    on_card = sm.grid_smooth(p.to(cuda), torch.ones(len(p), dtype=torch.bool,
                                                    device=cuda),
                             threshold, min_neighbors, elig.to(cuda), 8, 128,
                             sm.cloud_index(counts, cuda), len(counts))
    for g, w in zip(on_card, want):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(sm.smooth_grid(p.to(cuda), elig.to(cuda), counts,
                                   threshold, min_neighbors, 8, 128), want):
        assert torch.equal(g.cpu(), w)
    assert sm.GRID_LAUNCHES == before + 2


def test_grid_kernel_rejects_bad_input(cuda):
    from rabbit_transcoding_tpu_torch.ops import smoothing as sm

    p = torch.zeros((6, 3), dtype=torch.int32, device=cuda)
    e = torch.ones(6, dtype=torch.bool, device=cuda)
    args = (4.0, 4.0, 8, 128)
    with pytest.raises(TypeError):
        sm.grid_smooth_kernel(p.long(), e, [6], *args)
    with pytest.raises(TypeError):
        sm.grid_smooth_kernel(p, e.to(torch.uint8), [6], *args)
    with pytest.raises(ValueError):
        sm.grid_smooth_kernel(p.cpu(), e.cpu(), [6], *args)
    with pytest.raises(ValueError):
        sm.grid_smooth_kernel(p, e.cpu(), [6], *args)
    with pytest.raises(ValueError):
        sm.grid_smooth_kernel(torch.zeros((3, 6), dtype=torch.int32,
                                          device=cuda).t(), e, [6], *args)
    with pytest.raises(ValueError):
        sm.grid_smooth_kernel(p, e, [2, 3], *args)
    with pytest.raises(ValueError):
        sm.grid_smooth_kernel(p, e, [1] * 6 + [0] * (sm._BATCH_CLOUDS - 5),
                              *args)


def test_scatter_sum_on_the_card_adds_in_point_order(cuda):
    from rabbit_transcoding_tpu_torch.ops import smoothing as sm

    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.integers(0, 500, 300_000))
    vals = torch.from_numpy((rng.random((300_000, 6)) * 1000).astype(
        np.float32))
    want = sm._scatter_sum(flat, vals, 500)
    got = sm._scatter_sum(flat.to(cuda), vals.to(cuda), 500)
    again = sm._scatter_sum(flat.to(cuda), vals.to(cuda), 500)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kw", [
    dict(smoothing=True), dict(map_pair=True, smoothing=True),
    dict(motion=True, intra=True), dict(lossless=True)])
def test_decoder_on_the_card_equals_the_cpu(cuda, kw):
    from rabbit_transcoding_tpu_torch.bitstream import V3CReader
    from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder
    from rabbit_transcoding_tpu_torch.testdata import make_stream

    data = make_stream(4, 256, 256, patches=True, **kw)
    reader = V3CReader()
    assert Decoder().device.type == "cuda"
    got, want = (Decoder(device=d).decode(reader.decode(reader.read(data)[0]))
                 for d in (cuda, "cpu"))
    for a, b in zip(got, want):
        for k in ("positions", "colors", "types", "partition"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# --- the normals and the metrics (no hand-written kernel on their path) ------
@pytest.mark.parametrize("maker,n", [("make_frame", 40_000),
                                     ("make_scene_frame", 40_000),
                                     ("make_dense_frame", 200_000)])
def test_normals_on_the_card_against_the_cpu(cuda, maker, n):
    """Covariances equal bit for bit (the same fused multiply-add chain),
    and the eigenvectors too: the host's LAPACK decomposes on every device
    (``normals._eigh``), so the oriented unit normals are equal."""
    from rabbit_transcoding_tpu_torch import testdata
    from rabbit_transcoding_tpu_torch.encoder import normals as nm

    pts = getattr(testdata, maker)(0, n=n).positions.astype(np.float32)
    idx = nm.knn_indices(pts, 16)
    t = torch.from_numpy(pts)
    ti = torch.from_numpy(idx).long()
    nb_c, nb_g = t[ti], t.to(cuda)[ti.to(cuda)]
    cov_c = nm._cov(nb_c - (nm._sum_k(nb_c) / 16)[:, None, :])
    cov_g = nm._cov(nb_g - (nm._sum_k(nb_g) / 16)[:, None, :])
    assert torch.equal(cov_g.cpu(), cov_c)
    got, _ = nm.compute_normals(pts, nbr_idx=idx, device=cuda)
    want, _ = nm.compute_normals(pts, nbr_idx=idx, device="cpu")
    m = testdata.normals_mismatch(got, want)
    print(maker, len(pts), m)
    assert m["share_beyond_1e-3"] <= 1e-4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_generate_normals_on_the_card_against_the_cpu(cuda):
    from rabbit_transcoding_tpu_torch import testdata
    from rabbit_transcoding_tpu_torch.encoder import normals as nm

    pts = testdata.make_frame(0, n=30_000).positions.astype(np.float32)
    for kw in (dict(), dict(orientation_strategy=3),
               dict(orientation_strategy=2, view_point=(900.0, 0.0, 0.0),
                    smoothing_iterations=2, weight_normal_smoothing=0.7,
                    store_eigenvalues=True, store_centroids=True,
                    store_number_of_nearest_neighbors=True)):
        got = nm.generate_normals(pts, nm.NormalsGenParams(**kw), cuda)
        want = nm.generate_normals(pts, nm.NormalsGenParams(**kw), "cpu")
        assert set(got) == set(want)
        m = testdata.normals_mismatch(got["normals"], want["normals"])
        assert m["share_beyond_1e-3"] <= 1e-3, (kw, m)
        if "centroids" in want:
            np.testing.assert_array_equal(got["centroids"], want["centroids"])
            np.testing.assert_array_equal(got["nn_counts"], want["nn_counts"])
            np.testing.assert_allclose(
                got["eigenvalues"], want["eigenvalues"], rtol=0,
                atol=1e-4 * float(want["eigenvalues"].max()))


@pytest.mark.parametrize("name", ["sphere_default",
                                  "scene_lossy_occupancy_pbf",
                                  "sphere_eom_lossless"])
def test_metrics_on_the_card_against_the_cpu_and_the_reference(cuda, name):
    """The committed encoder streams: decoded on the card, the reference
    decoder's checksums; measured with the normals computed on the card:
    every field that passes through no normal equals the committed
    reference value and the CPU's, D2 PSNR within 1e-5 dB of both."""
    import dataclasses

    from rabbit_transcoding_tpu_torch.bitstream import V3CReader
    from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder
    from rabbit_transcoding_tpu_torch.metrics.metrics import (
        compute_sequence_metrics,
    )
    from rabbit_transcoding_tpu_torch.testdata import load_encoder_stream

    data, sources, record = load_encoder_stream(name)
    reader = V3CReader()
    clouds = [ps for gof in reader.read(data)
              for ps in Decoder(device=cuda).decode(reader.decode(gof))]
    assert [ps.compute_checksum().hex() for ps in clouds] == (
        record["checksums"])
    _, got = compute_sequence_metrics(sources, clouds, device=cuda)
    _, cpu = compute_sequence_metrics(sources, clouds, device="cpu")
    want = record["metrics_summary"]
    for f in dataclasses.fields(got):
        a, b, c = (getattr(m, f.name) for m in (got, cpu, want))
        if f.name.startswith("d2_"):
            if f.name.endswith("psnr") and np.isfinite(c):
                assert abs(a - b) <= 1e-5 and abs(a - c) <= 1e-5, f.name
        else:
            assert a == b == c, f.name


# --- the encoder's device ops: the card against device="cpu" --------
def test_encoder_colour_ops_on_the_card_equal_the_cpu(cuda):
    from rabbit_transcoding_tpu_torch.ops import color

    rng = np.random.default_rng(5)
    rgb = torch.from_numpy(
        rng.integers(0, 256, (2, 256, 320, 3)).astype(np.uint8))
    pid = torch.from_numpy(np.repeat(np.repeat(
        rng.integers(-1, 6, (2, 16, 20)), 16, axis=1), 16, axis=2
    ).astype(np.int32))
    for filt in (0, 1, 2, 3, "box"):
        _same(color.rgb8_to_yuv420(rgb.to(cuda), filt),
              color.rgb8_to_yuv420(rgb, filt))
        _same(color.rgb8_to_yuv420_patch_aware(rgb.to(cuda), pid.to(cuda),
                                               filt),
              color.rgb8_to_yuv420_patch_aware(rgb, pid, filt))


def test_fills_on_the_card_equal_the_cpu(cuda):
    from rabbit_transcoding_tpu_torch.ops import dilate

    rng = np.random.default_rng(6)
    planes = (rng.random((6, 200, 300)) * 1023).astype(np.float32)
    occ = (rng.random((6, 200, 300)) < 0.3).astype(np.uint8)
    for mode in (0, 1, 2, 3):
        want = dilate.background_fill(planes, occ, mode, "cpu")
        got = dilate.background_fill(planes, occ, mode, cuda)
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), mode


@pytest.mark.parametrize("k", [1, 16, 64])
def test_grid_knn_on_the_card_equals_the_cpu(cuda, k):
    from rabbit_transcoding_tpu_torch.ops import knn

    p = _smoothing_cloud(200_000, 250)[0]
    q = p[::2] + 1
    _same(knn.grid_knn(q.to(cuda), p.to(cuda), k=k, cap=max(32, k)),
          knn.grid_knn(q, p, k=k, cap=max(32, k)))


def test_knn_smooth_and_device_recolour_on_the_card_equal_the_cpu(cuda):
    from rabbit_transcoding_tpu_torch.ops import recolor, smoothing

    p, col, part, elig = (t.numpy() for t in _smoothing_cloud(60_000, 120))
    want = smoothing.knn_smooth(p, part, eligible=elig, threshold=4.0,
                                device="cpu")
    got = smoothing.knn_smooth(p, part, eligible=elig, threshold=4.0,
                               device=cuda)
    assert want[1] == got[1] > 0 and np.array_equal(want[0], got[0])
    dst = p[::3] + np.array([0, 1, 0], np.int32)
    for k in (1, 4):
        assert np.array_equal(
            recolor.transfer_colors_device(p, col, dst, k=k, device="cpu"),
            recolor.transfer_colors_device(p, col, dst, k=k, device=cuda))


def test_segmentation_ops_on_the_card_equal_the_cpu(cuda):
    from rabbit_transcoding_tpu_torch.encoder import segment as sg

    rng = np.random.default_rng(7)
    n, n_vox = 100_000, 4_000
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = torch.from_numpy(nrm)
    for mode in range(5):
        w = torch.from_numpy(sg._direction_weights(mode, (0.6, 0.8, 1.0)))
        _same(sg._ppi_scores(nrm.to(cuda), w.to(cuda), mode),
              sg._ppi_scores(nrm, w, mode))
    scores = sg._ppi_scores(nrm, w, 4)
    ppi = scores.argmax(dim=1).to(torch.int32)
    idx = torch.from_numpy(rng.integers(0, n, (n, 48)))
    lam = float(np.float32(3.0 / 7))
    _same(sg._refine_all(ppi.to(cuda), scores.to(cuda), idx.to(cuda), lam,
                         10),
          sg._refine_all(ppi, scores, idx, lam, 10))
    inv = torch.from_numpy(rng.integers(0, n_vox, n))
    adj = torch.from_numpy(rng.integers(0, n_vox, (n_vox, 64)))
    ok = torch.from_numpy(rng.random((n_vox, 64)) < 0.6)
    wt = torch.from_numpy(
        (3.0 / rng.integers(1, 200, n_vox)).astype(np.float32))
    args = (inv, adj, ok, wt)
    _same(sg._grid_refine_all(ppi.to(cuda), scores.to(cuda),
                              *(a.to(cuda) for a in args), 10, n_vox),
          sg._grid_refine_all(ppi, scores, *args, 10, n_vox))


@pytest.mark.parametrize("name", ["sphere_default",
                                  "scene_lossy_occupancy_pbf",
                                  "sphere_eom_lossless"])
def test_encoder_on_the_card_writes_the_committed_stream(cuda, name):
    """The whole encoder on the card, its normals included: the bytes of
    the committed stream (which the CPU writes too,
    ``test_torch_encoder.py``)."""
    from rabbit_transcoding_tpu_torch.bitstream import V3CWriter
    from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames
    from rabbit_transcoding_tpu_torch.encoder.encoder import Encoder
    from rabbit_transcoding_tpu_torch.encoder.params import EncoderParameters
    from rabbit_transcoding_tpu_torch.testdata import load_encoder_stream

    data, sources, record = load_encoder_stream(name)
    context, _ = Encoder(EncoderParameters(**record["encoder_parameters"]),
                         cuda).encode(GroupOfFrames(sources))
    writer = V3CWriter()
    assert writer.write(writer.encode(context)) == data


def test_foreign_transcode_on_the_card_equals_the_cpu(cuda, monkeypatch):
    # a stream of the in-tree HEVC subsets with no external binary: the
    # occupancy's max-pool runs on the card, the HEVC coding on the host
    from rabbit_transcoding_tpu_torch import testdata
    from rabbit_transcoding_tpu_torch.transcoder import (
        Transcoder, TranscoderParameters, V3CReader, V3CWriter)

    monkeypatch.setenv("PATH", "/nonexistent")
    for role in ("ENCODER", "DECODER"):
        monkeypatch.delenv(f"RABBIT_HM_APP_{role}", raising=False)
    data = testdata.to_foreign(testdata.make_stream(2, 64, 64), cuda)
    params = TranscoderParameters(geometryQP=32, attributeQP=42,
                                  occupancyPrecision=4)
    outs = []
    for device in (cuda, torch.device("cpu")):
        reader, writer = V3CReader(), V3CWriter()
        context = reader.decode(reader.read(data)[0])
        Transcoder(params, device).transcode(context)
        outs.append(writer.write(writer.encode(context)))
    assert outs[0] == outs[1] and outs[0] != data


# --- the device mesh: a virtual mesh on card 0, and every card -----------------
def _mesh_devices(cuda, which: str) -> list:
    if which == "virtual":
        return [torch.device("cuda", 0)] * 8
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("which", ["virtual", "every_card"])
def test_mesh_transcode_on_the_card_equals_one_device(cuda, which):
    # the kernel's branch and the MC + intra chains over a mesh: bytes
    # equal to one card, one batched launch per shard and plane
    from rabbit_transcoding_tpu_torch.parallel.mesh import make_mesh
    from rabbit_transcoding_tpu_torch.parallel.multistream import (
        transcode_payloads)
    from rabbit_transcoding_tpu_torch.testdata import make_stream
    from rabbit_transcoding_tpu_torch.transcoder import V3CReader, VideoType

    mesh = make_mesh(_mesh_devices(cuda, which))
    reader = V3CReader()
    pays = []
    for tools in ({}, {}, {}, {"motion": True, "intra": True}):
        data = make_stream(2, 64, 64, device=cuda, **tools)
        atlas = reader.decode(reader.read(data)[0]).atlas(0)
        pays.append(atlas.video_bitstreams[VideoType.GEOMETRY].data)
    qps = [30, 34, 32, 30]
    one = transcode_payloads(pays, qps, torch.device("cuda", 0))
    before = tc.BATCHED_LAUNCHES
    assert transcode_payloads(pays, qps, mesh=mesh) == one
    # 3 plain streams over the flattened mesh, one launch per shard that
    # holds one
    assert tc.BATCHED_LAUNCHES - before == min(3, mesh.size)


@pytest.mark.parametrize("which", ["virtual", "every_card"])
def test_mesh_step_reproject_and_nn_on_the_card(cuda, which):
    from rabbit_transcoding_tpu_torch.core.patch import Patch
    from rabbit_transcoding_tpu_torch.ops import reproject as repro
    from rabbit_transcoding_tpu_torch.utils.enums import PatchOrientation
    from rabbit_transcoding_tpu_torch.parallel import mesh as pm
    from rabbit_transcoding_tpu_torch.parallel.pipeline import (
        make_sharded_nn_mse, sharded_reproject)

    mesh = pm.make_mesh(_mesh_devices(cuda, which))
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.integers(-40, 40, size=(5, 3, 4, 2, 16, 16))
                         .astype(np.int16))
    want = pm.transcode_compute_step(c, _qs(16), _qs(32), 1023.0)
    got = pm.make_sharded_transcode_step(mesh)(c.to(cuda), _qs(16), _qs(32),
                                               1023.0)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 * float(want[2])

    f, h, w = 5, 64, 64
    occ = torch.from_numpy((rng.random((f, h, w)) < 0.5).astype(np.uint8))
    geo = torch.from_numpy(rng.integers(0, 200, (f, h, w)).astype(np.int32))
    patches = []
    for k in range(f):
        p = Patch()
        p.size_u0, p.size_v0 = 3, 4
        p.u1, p.v1, p.d1 = 10 + k, 20, 30
        p.normal_axis, p.tangent_axis, p.bitangent_axis = 0, 1, 2
        p.orientation = PatchOrientation(k % 8)
        p.projection_mode = k % 2
        p.occupancy_resolution = 16
        patches.append([p])
    table, counts = (torch.as_tensor(np.asarray(x)) for x in
                     repro.build_patch_table(patches, 4))
    args = [x.to(cuda) for x in (geo, occ, table, counts)]
    for a, b in zip(sharded_reproject(mesh, *args, 16),
                    repro.reproject(geo, occ, table, counts, 16)):
        assert a.device == args[0].device
        assert torch.equal(a.cpu(), b)

    refs = rng.integers(200, 800, (20000, 3)).astype(np.int32)
    queries = np.clip(refs[:9000] + rng.integers(-3, 4, (9000, 3)), 0,
                      1023).astype(np.int32)
    cpu_mesh = pm.make_mesh([torch.device("cpu")])
    kw = dict(k_cell_bits=3, grid_dim=128, cap=64)
    assert (make_sharded_nn_mse(mesh, **kw)(queries, refs)
            == make_sharded_nn_mse(cpu_mesh, **kw)(queries, refs))
