"""The port's own copies of the reference's host layers against the
originals on the CPU: the V3C reader and writer, the hash SEI and the rANS
library give the reference's bytes.  The entry points of the port run on the
card unless the caller asks for the CPU, and raise when there is none."""

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu import native as ref_native
from rabbit_transcoding_tpu.codec.hash import create_hash_sei as ref_hash_sei
from rabbit_transcoding_tpu.codec.patch_frame import (
    decode_patch_frames as ref_patch_frames,
)
from rabbit_transcoding_tpu.core.gof import GroupOfFrames
from rabbit_transcoding_tpu.encoder.encoder import Encoder
from rabbit_transcoding_tpu.encoder.params import EncoderParameters
from rabbit_transcoding_tpu_torch import bitstream, native
from rabbit_transcoding_tpu_torch.bitstream.bitio import BitWriter
from rabbit_transcoding_tpu_torch.bitstream.sei import write_sei_rbsp
from rabbit_transcoding_tpu_torch.codec.hash import create_hash_sei
from rabbit_transcoding_tpu_torch.codec.patch_frame import decode_patch_frames
from rabbit_transcoding_tpu_torch.parallel import multistream as ms
from rabbit_transcoding_tpu_torch.testdata import make_stream
from rabbit_transcoding_tpu_torch.transcoder import (
    MultiStreamTranscoder,
    Transcoder,
)
from rabbit_transcoding_tpu_torch.utils.enums import CodecId
from rabbit_transcoding_tpu_torch.video import VideoDecoder, VideoEncoder, rbv

from test_e2e_codec import make_sphere_cloud
from test_torch_transcoder import _bench_make_stream


def _encoder_stream(**kw) -> bytes:
    """A stream of the reference's V-PCC encoder: patches, SEI, per-map
    sub-streams where asked."""
    params = dict(minimumImageWidth=256, minimumImageHeight=64,
                  geometryQP=12, attributeQP=20, occupancyPrecision=2,
                  flagGeometrySmoothing=False, frameCount=1,
                  groupOfFramesSize=1)
    params.update(kw)
    context, _ = Encoder(EncoderParameters(**params)).encode(
        GroupOfFrames([make_sphere_cloud(seed=7)]))
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


_STREAMS = {
    "bench": lambda: _bench_make_stream(2, 64, 64),
    "plain": lambda: make_stream(2, 64, 64),
    "mc_intra": lambda: make_stream(2, 64, 64, motion=True, intra=True),
    "map_pair": lambda: make_stream(2, 64, 64, map_pair=True),
    "lossless": lambda: make_stream(2, 64, 64, lossless=True),
    "encoder": lambda: _encoder_stream(decodedAtlasInformationHash=1),
    "encoder_pairs": lambda: _encoder_stream(
        multipleStreams=True, absoluteD1=False, absoluteT1=False),
}


def _round_trip(data: bytes, bs) -> list[bytes]:
    """Every GOF of ``data`` parsed and written back by ``bs``'s reader and
    writer."""
    reader, writer = bs.V3CReader(), bs.V3CWriter()
    return [writer.write(writer.encode(reader.decode(gof)))
            for gof in reader.read(data)]


@pytest.mark.parametrize("name", list(_STREAMS))
def test_reader_writer_bytes_identical(name):
    data = _STREAMS[name]()
    got = _round_trip(data, bitstream)
    assert got == _round_trip(data, ref_bitstream)
    assert b"".join(got) == data


def _hash_sei_bytes(sei) -> bytes:
    bw = BitWriter()
    write_sei_rbsp(bw, [sei])
    return bw.data()


@pytest.mark.parametrize("name", ["encoder", "encoder_pairs", "plain"])
def test_hash_sei_equal(name):
    data = _STREAMS[name]()
    ref_reader = ref_bitstream.V3CReader()
    ref_atlas = ref_reader.decode(ref_reader.read(data)[0]).atlas(0)
    reader = bitstream.V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    want = ref_hash_sei(ref_atlas, ref_patch_frames(ref_atlas))
    got = create_hash_sei(atlas, decode_patch_frames(atlas))
    assert (got.high_level_md5, got.atlas_md5) == (want.high_level_md5,
                                                   want.atlas_md5)
    assert _hash_sei_bytes(got) == _hash_sei_bytes(want)


def _slab(seed: int, n: int) -> np.ndarray:
    """Coefficient-like int16 data: mostly zeros, a Laplacian tail."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.laplace(scale=3.0, size=n)).astype(np.int16)
    x[rng.random(n) < 0.6] = 0
    return x


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 4096), (2, 100_003)])
def test_rans_bytes_identical(seed, n):
    assert native.available() and ref_native.available()
    x = _slab(seed, n)
    blob = native.compress_i16(x)
    assert blob == ref_native.compress_i16(x)
    np.testing.assert_array_equal(native.decompress_i16(blob, n), x)


@pytest.mark.parametrize("n_bands", [1, 3, 5])
def test_rans_bands_bytes_identical(n_bands):
    x = _slab(10 + n_bands, 64 * 257)
    bounds = np.linspace(0, len(x), 4 * n_bands + 1).astype(int)
    segments = [(int(a), int(b - a), i % n_bands)
                for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]
    blob = native.compress_i16_bands(x, segments, n_bands)
    assert blob == ref_native.compress_i16_bands(x, segments, n_bands)
    np.testing.assert_array_equal(
        native.decompress_i16_bands(blob, len(x), segments, n_bands), x)


def test_native_builds_outside_the_reference_package():
    assert native.available()
    assert "build" in native._LIB and "rabbit_transcoding_tpu" not in (
        native._LIB.split("build")[-1])
    assert native._LIB != ref_native._LIB


# --- the entry points' device ------------------------------------------------
def _default_devices() -> dict:
    """The device each entry point picks when given none."""
    seen = []
    real = ms.resolve
    ms.resolve = lambda device="cuda": seen.append(real(device)) or seen[-1]
    try:
        assert ms.transcode_payloads([], 30) == []
    finally:
        ms.resolve = real
    return {
        "Transcoder": Transcoder().device,
        "MultiStreamTranscoder": MultiStreamTranscoder().device,
        "transcode_payloads": seen[0],
        "VideoEncoder": VideoEncoder.create(CodecId.RBV).device,
        "VideoDecoder": VideoDecoder.create(CodecId.RBV).device,
    }


def test_entry_points_default_to_the_card():
    # decided here, not at collection: a card present or not
    if torch.cuda.is_available():
        assert set(_default_devices().values()) == {torch.device("cuda")}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _default_devices()


@pytest.mark.parametrize("card", [False, True])
def test_entry_points_pick_cuda_or_raise(monkeypatch, card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    if card:
        assert set(_default_devices().values()) == {torch.device("cuda")}
        return
    for make in (Transcoder, MultiStreamTranscoder,
                 lambda: ms.transcode_payloads([], 30),
                 lambda: VideoEncoder.create(CodecId.RBV),
                 lambda: VideoDecoder.create(CodecId.RBV),
                 lambda: rbv.decode(b""),
                 lambda: rbv.transcode_payload(b"", 30)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # asked for, the CPU needs no card
    assert Transcoder(device="cpu").device == torch.device("cpu")
