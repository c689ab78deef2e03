"""The port's RBV codec against the JAX reference, byte for byte: slab
layout, entropy blobs, encode, decode and transcode_payload of plain
streams, and a first check of each coding tool (MC, intra, deblocking,
threshold, requantisation)."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import native as ref_native
from rabbit_transcoding_tpu.core.image import Video as RefVideo
from rabbit_transcoding_tpu.utils.enums import ColorFormat as RefColorFormat
from rabbit_transcoding_tpu.video import rbv as ref
from rabbit_transcoding_tpu_torch import native
from rabbit_transcoding_tpu_torch.core.image import Video
from rabbit_transcoding_tpu_torch.utils.enums import ColorFormat
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


CPU = torch.device("cpu")


def _coeffs(seed, shape=(3, 4, 5, 16, 16), scale=6.0, decay=0.25):
    """Quantised-looking coefficients: Laplacian, energy falling with the
    zigzag frequency, mostly zero at high frequencies."""
    rng = np.random.default_rng(seed)
    rank = np.empty(256, np.int64)
    rank[ref._zz(16)] = np.arange(256)
    s = scale * np.exp(-decay * rank.reshape(16, 16))
    c = np.round(rng.laplace(size=shape) * s)
    return np.clip(c, -32767, 32767).astype(np.int16)


def _video(f, h, w, bitdepth, fmt, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bitdepth <= 8 else np.uint16
    yy, xx = np.mgrid[0:h, 0:w]
    maxv = (1 << bitdepth) - 1

    def plane(hh, ww, k):
        base = 0.5 + 0.35 * np.sin((xx[:hh, :ww] + 5 * k) / 9.0) * np.cos(
            yy[:hh, :ww] / 7.0)
        noise = rng.normal(scale=0.01, size=(hh, ww))
        return np.clip((base + noise) * maxv, 0, maxv).astype(dt)

    dims = rbv._plane_dims(w, h, fmt)
    planes = [np.stack([plane(ph, pw, k) for k in range(f)])
              for ph, pw in dims]
    return Video(w, h, bitdepth, fmt, planes)


def _ref_video(video: Video) -> RefVideo:
    """The port's Video as the reference's (its own class and enum)."""
    return RefVideo(video.width, video.height, video.bitdepth,
                    RefColorFormat(int(video.format)), video.planes)


def _ref_params(**kw):
    return ref.RbvParams(**kw)


def _port_params(**kw):
    return rbv.RbvParams(**kw)


# --- slab layout -------------------------------------------------------------
def test_freq_slab_round_trip_and_layout():
    c = _coeffs(0)
    q = torch.from_numpy(c)
    qf = rbv._to_freq_major(q)
    np.testing.assert_array_equal(
        qf.numpy(), np.asarray(ref._to_freq_major(jnp.asarray(c))))
    np.testing.assert_array_equal(
        rbv._freq_nnz(qf).numpy(),
        np.asarray(ref._freq_nnz(ref._to_freq_major(jnp.asarray(c)))))
    for kmax in (16, 256):
        slab = qf[:, :kmax].contiguous()
        back = rbv._from_freq_slab(slab, 16, kmax)
        want = np.asarray(ref._from_freq_slab(jnp.asarray(slab.numpy()), 16,
                                              kmax))
        np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_array_equal(
        rbv._from_freq_slab(qf.contiguous(), 16, 256).numpy(), c)


# --- entropy blobs -----------------------------------------------------------
@pytest.mark.parametrize("case", ["sparse", "dense", "zero", "dc_only"])
def test_encode_coeff_blob_bytes_identical(case):
    if case == "sparse":
        c = _coeffs(1)
    elif case == "dense":
        c = _coeffs(2, shape=(4, 8, 8, 16, 16), scale=40.0, decay=0.01)
    elif case == "zero":
        c = np.zeros((2, 3, 3, 16, 16), np.int16)
    else:
        c = np.zeros((2, 3, 3, 16, 16), np.int16)
        c[..., 0, 0] = np.arange(18, dtype=np.int16).reshape(2, 3, 3) * 7
    want = ref._encode_coeff_blob(jnp.asarray(c), 6)
    got = rbv._encode_coeff_blob(torch.from_numpy(c), 6)
    assert got == want


def test_band_backend_bytes_identical(monkeypatch):
    # a slab of 4 x 256 x 8 x 8 int16 = 128 KiB > 64 KiB lets the band
    # backend 'B' into the size race; handicap the other two backends (in
    # each package's native module, and zlib) so that 'B' wins
    c = _coeffs(2, shape=(4, 8, 8, 16, 16), scale=40.0, decay=0.01)
    pad = b"\0" * (1 << 20)
    compress = zlib.compress
    for mod in (native, ref_native):
        monkeypatch.setattr(mod, "compress_i16",
                            lambda a, f=mod.compress_i16: f(a) + pad)
    monkeypatch.setattr(zlib, "compress",
                        lambda data, level=-1: compress(data, level) + pad)
    want = ref._encode_coeff_blob(jnp.asarray(c), 6)
    got = rbv._encode_coeff_blob(torch.from_numpy(c), 6)
    assert want[3:4] == b"B"
    assert got == want
    np.testing.assert_array_equal(
        rbv._decode_coeff_blob(got, 4, 8, 8, 16, CPU).numpy(), c)


def _ref_blob(c: np.ndarray, backend: bytes) -> bytes:
    """A mode-3 blob written with the reference's helpers, forcing one
    backend of the size race."""
    f, nby, nbx, b, _ = c.shape
    qf = np.asarray(ref._to_freq_major(jnp.asarray(c)))
    kmax = 256
    slab = qf[:, :kmax].astype(np.int16).copy()
    dc = slab[:, 0].reshape(f, nby * nbx).astype(np.int32)
    slab[:, 0] = np.diff(dc, axis=1, prepend=0).astype(np.int16).reshape(
        f, nby, nbx)
    head = b"\x03" + struct.pack("<H", kmax)
    if backend == b"B":
        starts = ref._band_plan(kmax)
        segs = ref._band_segments(f, kmax, nby * nbx, starts)
        body = bytes([len(starts)]) + b"".join(
            struct.pack("<H", s) for s in starts
        ) + ref_native.compress_i16_bands(slab, segs, len(starts))
    elif backend == b"R":
        body = ref_native.compress_i16(slab)
    else:
        body = zlib.compress(slab.tobytes(), 6)
    return head + backend + body


@pytest.mark.parametrize("backend", [b"R", b"B", b"Z"])
def test_decode_coeff_blob_of_reference_backends(backend):
    c = _coeffs(3, shape=(2, 3, 4, 16, 16))
    blob = _ref_blob(c, backend)
    want = np.asarray(ref._decode_coeff_blob(blob, 2, 3, 4, 16))
    np.testing.assert_array_equal(want, c)
    got = rbv._decode_coeff_blob(blob, 2, 3, 4, 16, CPU)
    np.testing.assert_array_equal(got.numpy(), c)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_decode_coeff_blob_rejects_old_modes(mode):
    """Modes 0-2 are read (``test_torch_blob_modes.py``); a blob of one of
    them whose body is no zlib stream raises in both packages alike."""
    blob = bytes([mode]) + b"\0" * 16
    with pytest.raises(zlib.error):
        ref._decode_coeff_blob(blob, 1, 1, 1, 16)
    with pytest.raises(zlib.error):
        rbv._decode_coeff_blob(blob, 1, 1, 1, 16, CPU)


# --- encode / decode / transcode_payload -------------------------------------
_LOSSY = [
    # (frames, h, w, bitdepth, format, qp, gop)
    (4, 48, 64, 10, ColorFormat.YUV400, 16, 2),
    (3, 40, 56, 8, ColorFormat.YUV420, 22, 2),
    (4, 32, 32, 8, ColorFormat.YUV444, 30, 1),
]


@pytest.mark.parametrize("f,h,w,bd,fmt,qp,gop", _LOSSY)
def test_encode_lossy_bytes_identical(f, h, w, bd, fmt, qp, gop):
    video = _video(f, h, w, bd, fmt)
    want, want_rec = ref.encode(_ref_video(video),
                                _ref_params(qp=qp, gop_size=gop))
    got, got_rec = rbv.encode(video, _port_params(qp=qp, gop_size=gop), CPU)
    assert got == want
    for a, b in zip(got_rec.planes, want_rec.planes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tag", [b"P", b"Z"])
def test_encode_lossless_bytes_identical(tag):
    if tag == b"P":  # binary occupancy planes bit-pack 8:1
        occ = (np.random.default_rng(5).random((3, 24, 40)) > 0.6)
        video = Video(40, 24, 8, ColorFormat.YUV400, [occ.astype(np.uint8)])
    else:
        video = _video(2, 24, 40, 10, ColorFormat.YUV400)
    want, _ = ref.encode(_ref_video(video), _ref_params(lossless=True))
    got, rec = rbv.encode(video, _port_params(lossless=True), CPU)
    assert got == want
    assert got[rbv._HEADER.size + 4:][:1] == tag
    np.testing.assert_array_equal(rec.planes[0], video.planes[0])
    np.testing.assert_array_equal(rbv.decode(want, CPU).planes[0],
                                  video.planes[0])


@pytest.mark.parametrize("f,h,w,bd,fmt,qp,gop", _LOSSY)
def test_decode_equal(f, h, w, bd, fmt, qp, gop):
    payload, _ = ref.encode(_ref_video(_video(f, h, w, bd, fmt)),
                            _ref_params(qp=qp, gop_size=gop))
    want = ref.decode(payload)
    got = rbv.decode(payload, CPU)
    assert (got.width, got.height, got.bitdepth, got.format) == (
        want.width, want.height, want.bitdepth, want.format)
    for a, b in zip(got.planes, want.planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("new_qp,new_gop", [(32, None), (28, 1), (40, 2)])
@pytest.mark.parametrize("f,h,w,bd,fmt,qp,gop", _LOSSY[:2])
def test_transcode_payload_bytes_identical(f, h, w, bd, fmt, qp, gop,
                                           new_qp, new_gop):
    payload, _ = ref.encode(_ref_video(_video(f, h, w, bd, fmt)),
                            _ref_params(qp=qp, gop_size=gop))
    want = ref.transcode_payload(payload, new_qp, new_gop=new_gop)
    got = rbv.transcode_payload(payload, new_qp, new_gop=new_gop,
                                device=CPU)
    assert got == want
    # the reference's decoder reads the port's output
    dec = ref.decode(got)
    for a, b in zip(dec.planes, rbv.decode(got, CPU).planes):
        np.testing.assert_array_equal(a, b)


def test_transcode_payload_of_lossless_input():
    video = _video(3, 32, 48, 10, ColorFormat.YUV400)
    payload, _ = ref.encode(_ref_video(video), _ref_params(lossless=True))
    assert (rbv.transcode_payload(payload, 30, new_gop=2, device=CPU)
            == ref.transcode_payload(payload, 30, new_gop=2))


def test_probe_equal():
    payload, _ = ref.encode(_ref_video(_video(3, 40, 56, 8,
                                              ColorFormat.YUV420)),
                            _ref_params(qp=22))
    assert rbv.probe(payload) == ref.probe(payload)


# --- the coding tools beyond the plain I/P chain -----------------------------
# (tests/test_torch_rbv_tools.py and tests/test_torch_rbv_streams.py cover
# them in depth)
@pytest.mark.parametrize("feature", ["motion", "intra"])
def test_streams_outside_the_slice_raise(feature):
    video = _video(2, 32, 32, 8, ColorFormat.YUV400)
    payload, _ = ref.encode(_ref_video(video),
                            _ref_params(qp=30, gop_size=2, **{feature: True}))
    assert ref.probe(payload)[feature]
    assert rbv.transcode_payload(payload, 34, device=CPU) == (
        ref.transcode_payload(payload, 34))
    for a, b in zip(rbv.decode(payload, CPU).planes,
                    ref.decode(payload).planes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{"motion": True}, {"intra": True},
                                {"deblock": True}, {"coeff_threshold": 8}])
def test_encode_options_outside_the_slice_raise(kw):
    video = _video(2, 32, 32, 8, ColorFormat.YUV400)
    want, want_rec = ref.encode(_ref_video(video),
                                _ref_params(qp=30, gop_size=2, **kw))
    got, got_rec = rbv.encode(video, _port_params(qp=30, gop_size=2, **kw),
                              CPU)
    assert got == want
    np.testing.assert_array_equal(got_rec.planes[0], want_rec.planes[0])


def test_requantize_and_threshold_raise():
    payload, _ = ref.encode(_ref_video(_video(2, 32, 32, 8,
                                              ColorFormat.YUV400)),
                            _ref_params(qp=30))
    assert rbv.requantize(payload, 36, device=CPU) == ref.requantize(payload,
                                                                     36)
    assert (rbv.transcode_payload(payload, 36, coeff_threshold=8, device=CPU)
            == ref.transcode_payload(payload, 36, coeff_threshold=8))
