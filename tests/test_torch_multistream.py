"""The port's batched multi-stream path against the JAX package on the CPU:
``parallel.multistream.transcode_payloads`` against the sequential
``rbv.transcode_payload`` / ``requantize``, and ``MultiStreamTranscoder``
against the single-stream ``Transcoder`` on each context.  Each package
parses V3C bytes with its own reader; the two meet only in bytes."""

import dataclasses

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.core.gof import GroupOfFrames
from rabbit_transcoding_tpu.core.image import Video
from rabbit_transcoding_tpu.encoder.encoder import Encoder
from rabbit_transcoding_tpu.encoder.params import EncoderParameters
from rabbit_transcoding_tpu.transcoder.multistream import (
    MultiStreamTranscoder as RefMultiStreamTranscoder,
)
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefParameters,
)
from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder as RefTranscoder
from rabbit_transcoding_tpu.utils.enums import ColorFormat
from rabbit_transcoding_tpu.video import rbv as ref_rbv
from rabbit_transcoding_tpu.video.rbv import RbvParams
from rabbit_transcoding_tpu_torch import bitstream
from rabbit_transcoding_tpu_torch.ops import transcode as tc
from rabbit_transcoding_tpu_torch.parallel.multistream import (
    transcode_payloads,
)
from rabbit_transcoding_tpu_torch.testdata import make_stream, with_input_qps
from rabbit_transcoding_tpu_torch.transcoder.multistream import (
    MultiStreamTranscoder,
)
from rabbit_transcoding_tpu_torch.transcoder.params import TranscoderParameters

from test_e2e_codec import make_sphere_cloud


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    tier-1 run puts six test processes on the host's cores, and torch's
    default pool of one thread per core in each of them oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _payload(qp, f=4, h=64, w=96, mc=False, gop=2, intra=False):
    """The reference's multi-stream test payload: 10-bit rings."""
    planes = [
        (300 + 200 * np.sin(
            np.linalg.norm(np.mgrid[0:h, 0:w], axis=0) / 9 + i
        )).astype(np.uint16)
        for i in range(f)
    ]
    v = Video(w, h, 10, ColorFormat.YUV400, [np.stack(planes)])
    p, _ = ref_rbv.encode(v, RbvParams(qp=qp, gop_size=gop, motion=mc,
                                       intra=intra))
    return p


def _lossless_payload():
    occ = (np.arange(4 * 32 * 32).reshape(4, 32, 32) % 7 == 0).astype(
        np.uint8)
    p, _ = ref_rbv.encode(Video(32, 32, 8, ColorFormat.YUV400, [occ]),
                          RbvParams(lossless=True))
    return p


# the eleven cases of the reference's multi-stream payload tests, and the
# coefficient threshold its batched call leaves out: (payloads, QP, options)
_CASES = {
    "mixed_qps_3_streams": (
        lambda: [_payload(16), _payload(20), _payload(24)], 32, {}),
    "intra": (lambda: [_payload(16, intra=True), _payload(22, intra=True),
                       _payload(20, intra=True, gop=1)], 32, {}),
    "intra_mc": (lambda: [_payload(16, mc=True, intra=True),
                          _payload(22, mc=True, intra=True)], 34, {}),
    "intra_requant": (lambda: [_payload(18, intra=True),
                               _payload(24, intra=True)], 30,
                      {"mode": "requant"}),
    "mc": (lambda: [_payload(16, mc=True), _payload(22, mc=True)], 34, {}),
    "requant": (lambda: [_payload(16), _payload(20)], 30,
                {"mode": "requant"}),
    "ragged_rows": (lambda: [_payload(18, h=48, w=48),
                             _payload(26, h=48, w=48)], 36, {}),
    "gop_restructure": (lambda: [_payload(16), _payload(20)], 32,
                        {"new_gop": 1}),
    "per_stream_qps": (lambda: [_payload(16), _payload(16)], [28, 40], {}),
    "lossless": (lambda: [_lossless_payload(), _lossless_payload()], 32, {}),
    "mixed_shapes": (lambda: [_payload(16), _payload(20, h=32, w=32),
                              _payload(24)], 30, {}),
    "threshold": (lambda: [_payload(16), _payload(20, f=5)], 30,
                  {"coeff_threshold": 6}),
    "ragged_gop_change": (lambda: [_payload(16, f=5), _payload(22, f=5)],
                          30, {"new_gop": 3}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_transcode_payloads_equals_sequential_reference(case):
    make, qp, kw = _CASES[case]
    pays = make()
    qps = [qp] * len(pays) if isinstance(qp, int) else qp
    if kw.get("mode") == "requant":
        seq = [ref_rbv.requantize(p, q) for p, q in zip(pays, qps)]
    else:
        seq = [ref_rbv.transcode_payload(
            p, q, new_gop=kw.get("new_gop"),
            coeff_threshold=kw.get("coeff_threshold", 0))
            for p, q in zip(pays, qps)]
    assert transcode_payloads(pays, qp, "cpu", **kw) == seq


def test_transcode_payloads_rejects_qp_count():
    with pytest.raises(ValueError, match="QP list"):
        transcode_payloads([_payload(16)], [28, 30], "cpu")


def test_no_op_requant_passes_through():
    p = _payload(20)
    assert transcode_payloads([p], 20, "cpu", mode="requant") == [p]


# --- MultiStreamTranscoder ----------------------------------------------------
def _encode(**kw) -> bytes:
    params = dict(minimumImageWidth=256, minimumImageHeight=64,
                  geometryQP=12, attributeQP=20, occupancyPrecision=2,
                  flagGeometrySmoothing=False, frameCount=1,
                  groupOfFramesSize=1)
    params.update(kw)
    context, _ = Encoder(EncoderParameters(**params)).encode(
        GroupOfFrames([make_sphere_cloud(seed=7)]))
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


@pytest.fixture(scope="module")
def streams() -> dict:
    base = make_stream(4, 128, 128)
    mc_intra = make_stream(4, 128, 128, motion=True, intra=True)
    return {
        "plain": [base, with_input_qps(base, 20, 26)],
        "mc_intra": [mc_intra, with_input_qps(mc_intra, 22, 28)],
        "map_streams": [_encode(multipleStreams=True, absoluteD1=False,
                                absoluteT1=False)] * 2,
        "lossless": [_encode(losslessGeo=True, losslessAttribute=True,
                             attributeVideo444=True,
                             enhancedOccupancyMapCode=True)] * 2,
    }


def _contexts(datas, bs=bitstream):
    """The first GOF of each stream, parsed by ``bs`` (the port's bitstream
    package unless the reference's is given)."""
    reader = bs.V3CReader()
    return [reader.decode(reader.read(d)[0]) for d in datas]


def _write(contexts, bs=bitstream) -> list[bytes]:
    writer = bs.V3CWriter()
    return [writer.write(writer.encode(c)) for c in contexts]


def _ref_params(params: TranscoderParameters) -> RefParameters:
    return RefParameters(**dataclasses.asdict(params))


def _sequential_reference(datas, params) -> list[bytes]:
    contexts = _contexts(datas, ref_bitstream)
    for ctx in contexts:
        RefTranscoder(_ref_params(params)).transcode(ctx)
    return _write(contexts, ref_bitstream)


@pytest.mark.parametrize("kind,threshold", [
    ("plain", 0), ("mc_intra", 0), ("map_streams", 0), ("lossless", 0),
    # the threshold reaches the batched calls (the kernel's branch turns
    # into the plain chain for geometry; MC + intra streams re-code)
    ("plain", 6), ("mc_intra", 6),
])
def test_multistream_equals_reference_transcoder(streams, kind, threshold):
    params = TranscoderParameters(geometryQP=28, attributeQP=36,
                                  geometryCoeffThreshold=threshold)
    datas = streams[kind]
    contexts = _contexts(datas)
    MultiStreamTranscoder(params, "cpu").transcode_many(contexts)
    got = _write(contexts)
    assert got == _sequential_reference(datas, params)
    if threshold == 0:
        # the reference's batched path agrees where it passes no threshold
        ref = _contexts(datas, ref_bitstream)
        RefMultiStreamTranscoder(_ref_params(params)).transcode_many(ref)
        assert got == _write(ref, ref_bitstream)


@pytest.mark.parametrize("kw", [
    {"mode": "requant"},
    {"rate_mode": "abr", "targetBitrateMbps": 1.0},
    {"allIntra": True, "computeHashSei": True},
])
def test_multistream_modes_equal_reference(streams, kw):
    params = TranscoderParameters(geometryQP=30, attributeQP=38, **kw)
    datas = streams["plain"] + streams["mc_intra"]
    contexts = _contexts(datas)
    MultiStreamTranscoder(params, "cpu").transcode_many(contexts)
    assert _write(contexts) == _sequential_reference(datas, params)


def test_mixed_round_keeps_per_stream_state(streams):
    # plain, MC + intra and lossless streams in one round; stream ids tie
    # each context to its own Transcoder (its ABR cache) across rounds
    params = TranscoderParameters(rate_mode="abr", targetBitrateMbps=0.5)
    datas = [streams["plain"][0], streams["mc_intra"][0],
             streams["lossless"][0]]
    mst = MultiStreamTranscoder(params, "cpu")
    refs = [RefTranscoder(_ref_params(params)) for _ in datas]
    for ids in ([0, 1, 2], [2, 0]):
        contexts = _contexts([datas[i] for i in ids])
        mst.transcode_many(contexts, stream_ids=ids)
        want = _contexts([datas[i] for i in ids], ref_bitstream)
        for i, ctx in zip(ids, want):
            refs[i].transcode(ctx)
        assert _write(contexts) == _write(want, ref_bitstream)
        assert [mst.single(i)._rc_cache for i in ids] == [
            refs[i]._rc_cache for i in ids]


def test_one_kernel_call_per_plane_for_the_group(streams, monkeypatch):
    # the kernel's branch: every stream of a group in one batched call per
    # plane (geometry luma, attribute Y, U, V), whatever the stream count
    calls = []
    real = tc.transcode_coeffs_batched_ref

    def spy(coeffs, *args, **kw):
        calls.append(coeffs.shape[0])
        return real(coeffs, *args, **kw)

    monkeypatch.setattr(tc, "transcode_coeffs_batched_ref", spy)
    datas = streams["plain"] * 2
    contexts = _contexts(datas)
    params = TranscoderParameters(geometryQP=28, attributeQP=36)
    MultiStreamTranscoder(params, "cpu").transcode_many(contexts)
    assert calls == [4, 4, 4, 4]
    assert _write(contexts) == _sequential_reference(datas, params)
