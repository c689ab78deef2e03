"""The port's push-pull background fill and the transcode of lossless input
over an occupancy map, against the JAX package on the CPU.  Each package
parses V3C bytes with its own reader; the two meet only in bytes and numpy
arrays.  The last case holds the committed encoder stream of
``tests/fixtures_torch/`` against a fresh encode (this file already pays the
encoder's start-up and has the time to spare)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.core.gof import GroupOfFrames
from rabbit_transcoding_tpu.encoder.encoder import Encoder
from rabbit_transcoding_tpu.encoder.params import EncoderParameters
from rabbit_transcoding_tpu.ops import dilate as ref_dilate
from rabbit_transcoding_tpu.ops import occupancy as ref_occupancy
from rabbit_transcoding_tpu.testdata import make_frame
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefParameters,
)
from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder as RefTranscoder
from rabbit_transcoding_tpu_torch import bitstream
from rabbit_transcoding_tpu_torch.bitstream import V3CReader, V3CWriter
from rabbit_transcoding_tpu_torch.ops import dilate, occupancy
from rabbit_transcoding_tpu_torch.testdata import (
    load_encoder_stream,
    make_stream,
)
from rabbit_transcoding_tpu_torch.transcoder.params import TranscoderParameters
from rabbit_transcoding_tpu_torch.transcoder.transcoder import Transcoder
from rabbit_transcoding_tpu_torch.utils.enums import VideoType

from test_e2e_codec import make_sphere_cloud


def _planes(shape, density, seed):
    rng = np.random.default_rng(seed)
    img = np.round(rng.random(shape) * 1023).astype(np.float32)
    occ = (rng.random(shape) < density).astype(np.uint8)
    return img, occ


def _fill_both(img, occ):
    gpad, opad, (oh, ow) = dilate.pad_pow2(img, occ)
    rpad = ref_dilate.pad_pow2(img, occ)
    np.testing.assert_array_equal(gpad, rpad[0])
    np.testing.assert_array_equal(opad, rpad[1])
    assert (oh, ow) == rpad[2]
    want = np.asarray(ref_dilate.push_pull_fill(jnp.asarray(gpad),
                                                jnp.asarray(opad)))
    got = dilate.push_pull_fill(torch.from_numpy(gpad),
                                torch.from_numpy(opad)).numpy()
    return got[:, :oh, :ow], want[:, :oh, :ow]


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 128, 32), (1, 256, 256),
                                   (2, 37, 53), (2, 100, 70)])
@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
def test_push_pull_fill_equals_reference(shape, density):
    got, want = _fill_both(*_planes(shape, density, seed=sum(shape)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_fill_order_matters():
    # from the second pyramid level on the masked sums add fractions: the
    # reference's row-major order is pinned by the test above, which a
    # column-major order fails on these inputs
    img, occ = _planes((2, 64, 64), 0.3, seed=130)
    row_major = dilate._sum2x2
    try:
        dilate._sum2x2 = lambda x: (((x[:, 0::2, 0::2] + x[:, 1::2, 0::2])
                                     + x[:, 0::2, 1::2]) + x[:, 1::2, 1::2])
        got, want = _fill_both(img, occ)
    finally:
        dilate._sum2x2 = row_major
    assert (got != want).any()


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_upsample_nearest_equals_reference(factor):
    occ = (np.random.default_rng(factor).random((2, 5, 7)) < 0.5).astype(
        np.uint8)
    want = np.asarray(ref_occupancy.upsample_nearest(jnp.asarray(occ),
                                                     factor))
    got = occupancy.upsample_nearest(torch.from_numpy(occ), factor).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --- lossless video over an occupancy map -----------------------------------
def _transcode(data: bytes, transcoder) -> bytes:
    """The first GOF of ``data`` through ``transcoder``, read and written by
    the V3C reader and writer of the transcoder's own package."""
    bs = ref_bitstream if isinstance(transcoder, RefTranscoder) else bitstream
    reader = bs.V3CReader()
    context = reader.decode(reader.read(data)[0])
    transcoder.transcode(context)
    writer = bs.V3CWriter()
    return writer.write(writer.encode(context))


def _ref_params(params: TranscoderParameters) -> RefParameters:
    return RefParameters(**dataclasses.asdict(params))


def _encode(params: EncoderParameters, gof: GroupOfFrames) -> bytes:
    context, _ = Encoder(params).encode(gof)
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


@pytest.fixture(scope="module")
def encoder_lossless_stream() -> bytes:
    """The lossless encoder configuration of the reference's multi-stream
    edge-case test."""
    return _encode(EncoderParameters(
        minimumImageWidth=256, minimumImageHeight=64, geometryQP=12,
        attributeQP=20, occupancyPrecision=2, flagGeometrySmoothing=False,
        frameCount=1, groupOfFramesSize=1, losslessGeo=True,
        losslessAttribute=True, attributeVideo444=True,
        enhancedOccupancyMapCode=True,
    ), GroupOfFrames([make_sphere_cloud(seed=7)]))


@pytest.fixture(scope="module")
def lossless_predicted_pair_stream() -> bytes:
    """Lossless geometry with predicted per-map sub-streams (the
    ctc-*-lossless-D1-from-rec-D0 conditions)."""
    return _encode(EncoderParameters(
        losslessGeo=True, rawPointsPatch=True, enhancedOccupancyMapCode=True,
        noAttributes=False, minimumImageWidth=256, minimumImageHeight=64,
        allIntra=True, multipleStreams=True, absoluteD1=False,
        absoluteT1=False, frameCount=2, groupOfFramesSize=2,
    ), GroupOfFrames([make_frame(i, n=9000, radius=40.0, center=64.0)
                      for i in range(2)]))


@pytest.mark.parametrize("kw", [
    {"geometryQP": 28, "attributeQP": 36},
    {"geometryQP": 24, "attributeQP": 30, "videoGopSize": 1},
    {"geometryQP": 30, "attributeQP": 40, "occupancyPrecision": 4},
])
def test_encoder_lossless_input_bytes_identical(encoder_lossless_stream, kw):
    atlas = V3CReader().decode(
        V3CReader().read(encoder_lossless_stream)[0]).atlas(0)
    assert VideoType.OCCUPANCY in atlas.video_bitstreams
    params = TranscoderParameters(**kw)
    assert (_transcode(encoder_lossless_stream, Transcoder(params, "cpu"))
            == _transcode(encoder_lossless_stream,
                          RefTranscoder(_ref_params(params))))


def test_lossless_predicted_pair_bytes_identical(
        lossless_predicted_pair_stream):
    ctx = V3CReader().decode(V3CReader().read(
        lossless_predicted_pair_stream)[0])
    assert not ctx.map1_absolute()
    assert VideoType.GEOMETRY_D1 in ctx.atlas(0).video_bitstreams
    params = TranscoderParameters(geometryQP=28, attributeQP=36,
                                  computeHashSei=False)
    got = _transcode(lossless_predicted_pair_stream,
                     Transcoder(params, "cpu"))
    assert got == _transcode(lossless_predicted_pair_stream,
                             RefTranscoder(_ref_params(params)))
    assert len(got) < len(lossless_predicted_pair_stream)


@pytest.mark.parametrize("size", [(4, 128, 128), (3, 192, 128)])
def test_testdata_lossless_stream_bytes_identical(size):
    # lossless 10-bit geometry and 8-bit YUV420 attribute: the chroma masks
    # are the luma mask max-pooled
    data = make_stream(*size, lossless=True)
    params = TranscoderParameters(geometryQP=28, attributeQP=36)
    got = _transcode(data, Transcoder(params, "cpu"))
    assert got == _transcode(data, RefTranscoder(_ref_params(params)))
    assert len(got) < len(data)


def test_fill_changes_the_output():
    # the occupancy map matters: without it the same lossless input
    # re-encodes unfilled (the bare first quantisation)
    data = make_stream(2, 64, 64, lossless=True)
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    del context.atlas(0).video_bitstreams[VideoType.OCCUPANCY]
    writer = V3CWriter()
    no_occ = writer.write(writer.encode(context))
    params = TranscoderParameters(geometryQP=28, attributeQP=36)
    filled = _transcode(data, Transcoder(params, "cpu"))
    bare = _transcode(no_occ, Transcoder(params, "cpu"))
    assert bare == _transcode(no_occ, RefTranscoder(_ref_params(params)))

    def geometry(out):
        return reader.decode(reader.read(out)[0]).atlas(0).video_bitstreams[
            VideoType.GEOMETRY].data

    assert geometry(filled) != geometry(bare)


def test_committed_encoder_stream_equals_a_fresh_encode():
    """``tests/fixtures_torch/sphere_default.bin`` (what the card decodes,
    with the reference's checksums beside it) is what the encoder writes
    today: a stale fixture fails here.  The generator script is the single
    definition of the stream."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / (
        "make_torch_fixtures.py")
    spec = importlib.util.spec_from_file_location("make_torch_fixtures", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    data, sources, record = load_encoder_stream("sphere_default")
    assert tool.encode("sphere_default") == data
    for got, want in zip(sources, tool.source_clouds("sphere_default")):
        np.testing.assert_array_equal(got.positions, want.positions)
        np.testing.assert_array_equal(got.colors, want.colors)
    assert record["encoder_parameters"] == tool.FIXTURES["sphere_default"][2]
    assert len(data) < 1_000_000
