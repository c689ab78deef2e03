"""The port's live transcode as a whole against the JAX reference: the
benchmark stream, the Transcoder and the rabbit-transcode app give the same
bytes on the CPU.  Each package parses the input bytes with its own V3C
reader; the two meet only in bytes and numpy arrays."""

import importlib
import os

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefParameters,
)
from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder as RefTranscoder
from rabbit_transcoding_tpu.video import rbv as ref_rbv
from rabbit_transcoding_tpu_torch.apps import transcode as app
from rabbit_transcoding_tpu_torch.bitstream import V3CReader, V3CWriter, VideoBitstream
from rabbit_transcoding_tpu_torch.core.image import Video
from rabbit_transcoding_tpu_torch.testdata import make_stream
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


FRAMES, WIDTH, HEIGHT = 4, 128, 128


def _bench_make_stream(*args) -> bytes:
    # bench.py sets a JAX cache directory in the environment when imported;
    # keep this process's environment as it was
    saved = dict(os.environ)
    try:
        bench = importlib.import_module("bench")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return bench.make_stream(*args)


@pytest.fixture(scope="module")
def stream() -> bytes:
    return make_stream(FRAMES, WIDTH, HEIGHT)


def _transcode(data: bytes, transcoder) -> bytes:
    """The first GOF of ``data`` through the port's ``transcoder``, read and
    written by the port's own V3C reader and writer."""
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    transcoder.transcode(context)
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def _ref_transcode(data: bytes, **params) -> bytes:
    """The same through the reference's Transcoder, reader and writer."""
    reader = ref_bitstream.V3CReader()
    context = reader.decode(reader.read(data)[0])
    RefTranscoder(RefParameters(**params)).transcode(context)
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


def test_make_stream_matches_bench(stream):
    assert stream == _bench_make_stream(FRAMES, WIDTH, HEIGHT)


@pytest.mark.parametrize("kw", [
    {"computeHashSei": True},
    {"occupancyPrecision": 4},
    {"videoGopSize": 1},
    {"allIntra": True, "geometryQP": 24, "attributeQP": 30},
])
def test_transcoder_bytes_identical(stream, kw):
    params = dict(geometryQP=32, attributeQP=42, mode="reencode")
    params.update(kw)
    want = _ref_transcode(stream, **params)
    got = _transcode(stream, Transcoder(TranscoderParameters(**params), "cpu"))
    assert got == want


def test_output_decodes_in_both_packages(stream):
    out = _transcode(stream, Transcoder(
        TranscoderParameters(geometryQP=32, attributeQP=42), "cpu"))
    reader = V3CReader()
    atlas = reader.decode(reader.read(out)[0]).atlas(0)
    for vt in (VideoType.OCCUPANCY, VideoType.GEOMETRY, VideoType.ATTRIBUTE):
        payload = atlas.get_video_bitstream(vt).data
        a, b = rbv.decode(payload, "cpu"), ref_rbv.decode(payload)
        assert a.frame_count == FRAMES
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(pa, pb)


def test_app_matches_reference_transcoder(stream, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.bin").write_bytes(stream)
    rc = app.main(["--compressedStreamPath=in.bin", "--outStreamPath=out.bin",
                   "--geometryQP=30", "--attributeQP=40", "--device=cpu"])
    assert rc == 0
    want = _ref_transcode(stream, geometryQP=30, attributeQP=40)
    assert (tmp_path / "out.bin").read_bytes() == want


def test_app_without_gpu_raises_for_cuda(stream, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.bin").write_bytes(stream)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--compressedStreamPath=in.bin", "--outStreamPath=o.bin"])


@pytest.mark.parametrize("option", ["--profileDir=prof", "--trace=1",
                                    "--checkConformance=1"])
def test_app_options_not_ported_raise(option, stream, tmp_path, monkeypatch,
                                      capsys):
    """These flags raised until the app ported them; now each runs
    (``tests/test_torch_apps_small.py`` holds their output against the
    reference app's), the transcoded bytes stay the plain run's, and the
    table of flags that are not ported is gone."""
    assert not hasattr(app, "_NOT_PORTED")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.bin").write_bytes(stream)
    assert app.main(["--compressedStreamPath=in.bin", "--outStreamPath=o.bin",
                     option, "--device=cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert (tmp_path / "o.bin").read_bytes() == _ref_transcode(stream)
    marker = {"--trace=1": None,
              "--checkConformance=1": "conformance: ",
              "--profileDir=prof": "profiler trace written to prof"}[option]
    assert marker is None or any(ln.startswith(marker) for ln in out), out
    assert os.path.isdir(tmp_path / "prof") == (option == "--profileDir=prof")
    logs = [n for n in os.listdir(tmp_path) if n.startswith("enc_")]
    assert bool(logs) == (option == "--trace=1")


@pytest.mark.parametrize("kw", [
    {"mode": "requant"},
    {"rate_mode": "abr", "targetBitrateMbps": 1.0},
])
def test_modes_not_ported_raise(stream, kw):
    # both modes are ported now (DCT-domain requantisation, and ABR with its
    # probes): the same bytes as the reference
    params = TranscoderParameters(**kw)
    assert (_transcode(stream, Transcoder(params, "cpu"))
            == _ref_transcode(stream, **kw))


def _lossless_geometry_stream(with_occupancy: bool) -> bytes:
    """A stream whose geometry is lossless RBV (a first quantisation)."""
    reader = V3CReader()
    context = reader.decode(reader.read(make_stream(2, 64, 64))[0])
    atlas = context.atlas(0)
    rng = np.random.default_rng(7)
    geo = rng.integers(200, 400, size=(2, 64, 64)).astype(np.uint16)
    payload, _ = rbv.encode(Video(64, 64, 10, ColorFormat.YUV400, [geo]),
                            rbv.RbvParams(lossless=True), "cpu")
    atlas.set_video_bitstream(VideoBitstream(VideoType.GEOMETRY, payload))
    if not with_occupancy:
        del atlas.video_bitstreams[VideoType.OCCUPANCY]
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def test_lossless_input_bytes_identical():
    data = _lossless_geometry_stream(with_occupancy=False)
    params = TranscoderParameters(geometryQP=28, attributeQP=38)
    assert (_transcode(data, Transcoder(params, "cpu"))
            == _ref_transcode(data, geometryQP=28, attributeQP=38))


def test_lossless_input_with_occupancy_raises():
    # ported: the background is filled (push-pull) before re-encoding, as
    # the reference does
    data = _lossless_geometry_stream(with_occupancy=True)
    params = TranscoderParameters()
    assert (_transcode(data, Transcoder(params, "cpu"))
            == _ref_transcode(data))


def test_profile_script_runs_on_cpu(tmp_path, capsys):
    from rabbit_transcoding_tpu_torch.apps import profile_transcode

    out = tmp_path / "profile.txt"
    assert profile_transcode.main(["--device=cpu", "--frames=2", "--size=64",
                                   "--runs=1", f"--out={out}"]) == 0
    text = out.read_text()
    assert "frames_per_s" in text and "spans_ms" in text
    assert text.count("plane ") == 4  # geometry luma + attribute Y, U, V
    assert text.strip() == capsys.readouterr().out.strip()
