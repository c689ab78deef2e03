"""The port's RBV codec API and transcoder on streams with motion
compensation, intra prediction, deblocking and the coefficient threshold,
against the JAX reference: ``encode`` (payload bytes and recon), ``decode``,
``transcode_payload``, ``requantize``, the ``Transcoder`` in ``reencode`` and
``requant`` mode, and the MC + intra test stream.  Equality is exact, and
each package decodes the other's output.  Each package parses V3C bytes
with its own reader; the two meet only in bytes and numpy arrays."""

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.core.image import Video as RefVideo
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefParameters,
)
from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder as RefTranscoder
from rabbit_transcoding_tpu.utils.enums import ColorFormat as RefColorFormat
from rabbit_transcoding_tpu.video import rbv as ref
from rabbit_transcoding_tpu_torch import bitstream, testdata
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.core.image import Video
from rabbit_transcoding_tpu_torch.transcoder.params import TranscoderParameters
from rabbit_transcoding_tpu_torch.transcoder.transcoder import Transcoder
from rabbit_transcoding_tpu_torch.utils.enums import ColorFormat, VideoType
from rabbit_transcoding_tpu_torch.video import rbv


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


Y400, Y420 = ColorFormat.YUV400, ColorFormat.YUV420
CPU = torch.device("cpu")


def _video(f, h, w, bitdepth, fmt, seed=0, move=3):
    """Smooth content moving ``move`` px per frame, a little noise."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bitdepth <= 8 else np.uint16
    yy, xx = np.mgrid[0:h, 0:w]
    maxv = (1 << bitdepth) - 1

    def plane(hh, ww, k, c):
        base = 0.5 + 0.35 * np.sin((xx[:hh, :ww] + move * k + 5 * c) / 9.0) \
            * np.cos((yy[:hh, :ww] - 2 * k) / 7.0)
        noise = rng.normal(scale=0.02, size=(hh, ww))
        return np.clip((base + noise) * maxv, 0, maxv).astype(dt)

    dims = rbv._plane_dims(w, h, fmt)
    return Video(w, h, bitdepth, fmt, [
        np.stack([plane(ph, pw, k, c) for k in range(f)])
        for c, (ph, pw) in enumerate(dims)])


def _ref_video(video: Video) -> RefVideo:
    """The port's Video as the reference's (its own class and enum)."""
    return RefVideo(video.width, video.height, video.bitdepth,
                    RefColorFormat(int(video.format)), video.planes)


def _occupancy(f, h, w, seed=3):
    return (np.random.default_rng(seed).random((f, h, w)) > 0.4).astype(
        np.uint8)


def _planes_equal(a: Video, b: Video) -> None:
    assert (a.width, a.height, a.bitdepth, int(a.format)) == (
        b.width, b.height, b.bitdepth, int(b.format))
    for pa, pb in zip(a.planes, b.planes):
        assert pa.dtype == pb.dtype
        np.testing.assert_array_equal(pa, pb)


def _decodes_alike(payload: bytes) -> None:
    _planes_equal(rbv.decode(payload, CPU), ref.decode(payload))


# (frames, h, w, bitdepth, format, qp, gop, motion, intra, deblock, thr_k,
#  weighted MC search)
_STREAMS = {
    "intra_gop1": (4, 48, 64, 10, Y400, 26, 1, False, True, False, 0, False),
    "mc_gop2_weighted": (4, 80, 96, 8, Y420, 30, 2, True, False, False, 0,
                         True),
    "mc_intra_gop2": (4, 48, 64, 10, Y400, 24, 2, True, True, False, 0,
                      True),
    "mc_intra_deblock_gop3_ragged": (4, 64, 48, 8, Y420, 32, 3, True, True,
                                     True, 0, False),
    "intra_threshold_gop4": (4, 64, 48, 10, Y400, 22, 4, False, True, False,
                             8, False),
    "deblock_threshold_gop2": (4, 48, 64, 8, Y400, 28, 2, False, False, True,
                               8, False),
    "intra_deblock_gop3_ragged": (5, 48, 64, 10, Y400, 30, 3, False, True,
                                  True, 0, False),
    "mc_threshold_gop1": (3, 48, 64, 10, Y400, 26, 1, True, False, True, 8,
                          False),
}


def _encode_both(name):
    f, h, w, bd, fmt, qp, gop, motion, intra, db, thr, weighted = \
        _STREAMS[name]
    video = _video(f, h, w, bd, fmt, move=4)
    kw = dict(qp=qp, gop_size=gop, motion=motion, intra=intra, deblock=db,
              coeff_threshold=thr,
              mc_weight=_occupancy(f, h, w) if weighted else None)
    return ref.encode(_ref_video(video), ref.RbvParams(**kw)), rbv.encode(
        video, rbv.RbvParams(**kw), CPU)


@pytest.mark.parametrize("name", list(_STREAMS))
def test_encode_and_decode(name):
    (want, want_rec), (got, got_rec) = _encode_both(name)
    assert got == want
    _planes_equal(got_rec, want_rec)
    _decodes_alike(want)
    info = rbv.probe(got)
    _, _, _, _, _, _, gop, motion, intra, db, _, _ = _STREAMS[name]
    assert (info["motion"], info["intra"], info["deblock"]) == (
        motion and gop > 1, intra, db)


@pytest.mark.parametrize("name,new_qp,new_gop,thr_k", [
    ("mc_gop2_weighted", 38, None, 0),
    ("mc_intra_gop2", 34, 1, 8),          # MC keeps its GOP
    ("mc_intra_deblock_gop3_ragged", 40, None, 0),
    ("intra_gop1", 30, None, 0),
    ("intra_gop1", 32, 3, 0),
    ("intra_deblock_gop3_ragged", 36, 2, 0),
    ("intra_threshold_gop4", 30, 1, 8),
    ("deblock_threshold_gop2", 36, 1, 8),
])
def test_transcode_payload(name, new_qp, new_gop, thr_k):
    (payload, _), _ = _encode_both(name)
    want = ref.transcode_payload(payload, new_qp, new_gop=new_gop,
                                 coeff_threshold=thr_k)
    got = rbv.transcode_payload(payload, new_qp, new_gop=new_gop,
                                coeff_threshold=thr_k, device=CPU)
    assert got == want
    _decodes_alike(got)


@pytest.mark.parametrize("name", ["deblock_threshold_gop2", "mc_intra_gop2",
                                  "intra_gop1", "intra_threshold_gop4"])
def test_requantize(name):
    (payload, _), _ = _encode_both(name)
    qp = rbv.probe(payload)["qp"]
    got = rbv.requantize(payload, qp + 7, device=CPU)
    assert got == ref.requantize(payload, qp + 7)
    _decodes_alike(got)
    if rbv.probe(payload)["intra"]:
        # the mode maps pass through verbatim
        f, h, w = (rbv.probe(payload)[k] for k in ("frame_count", "height",
                                                    "width"))
        gop = rbv.probe(payload)["gop_size"]
        n_i = -(-f // gop)
        for b_in, b_out in zip(rbv._iter_blobs(payload, 1),
                               rbv._iter_blobs(got, 1)):
            if rbv.probe(payload)["motion"]:
                b_in = rbv._split_mv_section(b_in, f, h // 16, w // 16)[1]
                b_out = rbv._split_mv_section(b_out, f, h // 16, w // 16)[1]
            raw_in = rbv._split_intra_section(b_in, n_i, h // 16, w // 16)[2]
            raw_out = rbv._split_intra_section(b_out, n_i, h // 16,
                                               w // 16)[2]
            assert raw_in and raw_in == raw_out


def test_requantize_same_qp_and_lossless():
    (payload, _), _ = _encode_both("mc_intra_gop2")
    assert rbv.requantize(payload, rbv.probe(payload)["qp"],
                          device=CPU) is payload
    lossless, _ = ref.encode(_ref_video(_video(3, 32, 48, 10, Y400)),
                             ref.RbvParams(lossless=True))
    got = rbv.requantize(lossless, 30, device=CPU)
    assert got == ref.requantize(lossless, 30)
    _decodes_alike(got)


# --- the MC + intra test stream and the transcoder ---------------------------
FRAMES, WIDTH, HEIGHT = 4, 64, 64


@pytest.fixture(scope="module")
def mc_intra_stream() -> bytes:
    return testdata.make_stream(FRAMES, WIDTH, HEIGHT, motion=True,
                                intra=True)


def test_mc_intra_stream_payloads_match_reference_encode(mc_intra_stream):
    occ, geo, attr_y = testdata.content(FRAMES, WIDTH, HEIGHT)
    params = testdata.lossy_params(True, True, occ)
    u = np.full((FRAMES, HEIGHT // 2, WIDTH // 2), 128, np.uint8)
    videos = {
        "geometry": Video(WIDTH, HEIGHT, 10, Y400, [geo]),
        "attribute": Video(WIDTH, HEIGHT, 8, Y420, [attr_y, u, u.copy()]),
    }
    reader = V3CReader()
    atlas = reader.decode(reader.read(mc_intra_stream)[0]).atlas(0)
    for key, vt in (("geometry", VideoType.GEOMETRY),
                    ("attribute", VideoType.ATTRIBUTE)):
        payload = atlas.get_video_bitstream(vt).data
        want, _ = ref.encode(_ref_video(videos[key]),
                             ref.RbvParams(**params[key]))
        assert payload == want
        info = rbv.probe(payload)
        assert info["motion"] and info["intra"]


def _transcode(data: bytes, transcoder, bitstream) -> bytes:
    """The first GOF of ``data`` through ``transcoder``, read and written by
    the V3C reader and writer of ``bitstream`` (the transcoder's package)."""
    reader = bitstream.V3CReader()
    context = reader.decode(reader.read(data)[0])
    transcoder.transcode(context)
    writer = bitstream.V3CWriter()
    return writer.write(writer.encode(context))


@pytest.mark.parametrize("mode", ["reencode", "requant"])
def test_transcoder_on_mc_intra_stream(mc_intra_stream, mode):
    kw = dict(geometryQP=32, attributeQP=42, mode=mode, computeHashSei=True)
    want = _transcode(mc_intra_stream, RefTranscoder(RefParameters(**kw)),
                      ref_bitstream)
    got = _transcode(mc_intra_stream,
                     Transcoder(TranscoderParameters(**kw), CPU), bitstream)
    assert got == want
    reader = V3CReader()
    atlas = reader.decode(reader.read(got)[0]).atlas(0)
    for vt in (VideoType.GEOMETRY, VideoType.ATTRIBUTE):
        _decodes_alike(atlas.get_video_bitstream(vt).data)


def test_profile_script_mc_intra_runs_on_cpu(tmp_path):
    from rabbit_transcoding_tpu_torch.apps import profile_transcode

    out = tmp_path / "profile.txt"
    assert profile_transcode.main([
        "--device=cpu", "--frames=2", "--size=64", "--runs=1",
        "--tools=mc_intra", f"--out={out}"]) == 0
    text = out.read_text()
    assert "tools mc_intra" in text and "submit" in text
    assert text.count("plane ") == 4
