"""The port's V-PCC encoder on the CPU.

* The three committed encoder streams (``tests/fixtures_torch/``, written by
  the JAX encoder): the port, given the committed source clouds and
  parameters, writes each ``<name>.bin`` byte for byte, with its own
  normals.  No JAX encoder runs.
* ``Encoder()`` defaults to the card and raises without one; an external
  codec (the stand-in HM binaries) for the geometry or the attribute, and
  the HDRTools conversion (a stand-in HDRConvert), give the JAX encoder's
  bytes.
* The colour-conversion app against the JAX app.

``encode_both`` is the helper of the knob files
(``test_torch_encoder_knobs*.py``): one JAX encode and one port encode of
the same clouds and parameters, the port given the JAX normals frame by
frame through ``encoder/segment.py:_segmentation_normals``.  The port's own
normals are the JAX normals bit for bit (its ``eigh`` calls the LAPACK
``ssyevd`` that jaxlib calls, ROADMAP queue 3 item g.9, closed), and
``test_torch_eigh.py`` encodes knob cases with them; the seam keeps each
knob case to the encoder's own steps."""

import contextlib

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.core.gof import GroupOfFrames as RefGroupOfFrames
from rabbit_transcoding_tpu.encoder import segment as ref_segment
from rabbit_transcoding_tpu.encoder.encoder import Encoder as RefEncoder
from rabbit_transcoding_tpu.encoder.params import (
    EncoderParameters as RefEncoderParameters,
)
from rabbit_transcoding_tpu_torch import bitstream, testdata
from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames
from rabbit_transcoding_tpu_torch.core.pointset import PointSet
from rabbit_transcoding_tpu_torch.encoder import segment
from rabbit_transcoding_tpu_torch.encoder.encoder import Encoder
from rabbit_transcoding_tpu_torch.encoder.params import EncoderParameters

from test_e2e_codec import make_sphere_cloud


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    tier-1 run puts six test processes on the host's cores, and torch's
    default pool of one thread per core in each of them oversubscribes the
    cores (the fixture encode below took 154 s instead of 12 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the knob files' common configuration: one small image size, so that the
# JAX encoder's compiled programs are reused across cases of a file
KNOB_BASE = dict(minimumImageWidth=256, minimumImageHeight=64, frameCount=2,
                 groupOfFramesSize=2)


def knob_clouds():
    """Two frames of a small sphere, ~4,400 points each."""
    return [make_sphere_cloud(radius=18, center=32, n_theta=110, seed=3 + i)
            for i in range(2)]


def _write(writer, context) -> bytes:
    return writer.write(writer.encode(context))


@contextlib.contextmanager
def same_normals():
    """Within the block, the JAX encoder's segmentation normals are
    recorded call by call and the port's encoder is given them in the same
    order (each for the same points)."""
    fed = []
    ref_normals = ref_segment._segmentation_normals
    own_normals = segment._segmentation_normals

    def record(points, params, nbr_idx):
        n = ref_normals(points, params, nbr_idx)
        fed.append((points.copy(), n))
        return n

    def feed(points, params, nbr_idx, device):
        want, n = fed.pop(0)
        assert np.array_equal(want, points)
        return n

    ref_segment._segmentation_normals = record
    segment._segmentation_normals = feed
    try:
        yield fed
    finally:
        ref_segment._segmentation_normals = ref_normals
        segment._segmentation_normals = own_normals


def encode_both(params: dict, clouds, port_params: dict | None = None,
                own_normals: bool = False) -> tuple:
    """-> ((JAX bytes, closed-loop checksums), (port bytes, checksums)),
    the port on the CPU given the JAX normals, or computing its own with
    ``own_normals``; ``port_params`` overrides some of ``params`` for the
    port (its own stand-in binaries)."""
    seam = contextlib.nullcontext([]) if own_normals else same_normals()
    with seam as fed:
        ctx, rec = RefEncoder(RefEncoderParameters(**params)).encode(
            RefGroupOfFrames(clouds))
        want = (_write(ref_bitstream.V3CWriter(), ctx),
                [ps.compute_checksum() for ps in rec])
        port_clouds = [PointSet(positions=c.positions, colors=c.colors,
                                reflectances=c.reflectances)
                       for c in clouds]
        ctx, rec = Encoder(
            EncoderParameters(**{**params, **(port_params or {})}), "cpu"
        ).encode(GroupOfFrames(port_clouds))
        got = (_write(bitstream.V3CWriter(), ctx),
               [ps.compute_checksum() for ps in rec])
        assert not fed
    return want, got


@pytest.mark.parametrize("name", ["sphere_default",
                                  "scene_lossy_occupancy_pbf",
                                  "sphere_eom_lossless"])
def test_port_encoder_writes_the_committed_stream(name):
    """The port's own normals included: bytes equal the committed stream,
    and the closed loop's clouds carry the reference decoder's checksums."""
    data, sources, record = testdata.load_encoder_stream(name)
    encoder = Encoder(EncoderParameters(**record["encoder_parameters"]),
                      device="cpu")
    context, recon = encoder.encode(GroupOfFrames(sources))
    assert _write(bitstream.V3CWriter(), context) == data
    assert [ps.compute_checksum().hex() for ps in recon] == \
        record["checksums"]
    assert set(encoder.timer.stages) >= {
        "generateSegments", "placeSegments", "generateOccupancyMapVideo",
        "generateGeometryVideo", "reconstructGeometry",
        "generateAttributeVideo", "reconstructClouds",
        "createPatchFrameDataStructure"}


def test_encoder_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Encoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Encoder()


@pytest.mark.parametrize("option", ["videoEncoderGeometryCodecId",
                                    "videoEncoderAttributeCodecId"])
def test_external_codecs_raise_naming_their_roadmap_item(option, tmp_path):
    """Ported: HM_APP for the component, through the stand-in binaries of
    each package (the port's ``mock_hevc`` and the JAX package's), gives
    the JAX encoder's V3C bytes and closed-loop checksums; the component's
    sub-stream is Annex-B, the others RBV."""
    from rabbit_transcoding_tpu_torch.bitstream import V3CReader
    from test_torch_foreign import write_ref_wrappers

    comp = option[len("videoEncoder"):-len("CodecId")]
    port_enc, _ = testdata.write_codec_wrappers(tmp_path)
    ref_enc, _ = write_ref_wrappers(tmp_path / "ref")
    path = f"videoEncoder{comp}Path"
    (want, want_sums), (got, got_sums) = encode_both(
        {**KNOB_BASE, option: "HM_APP", path: ref_enc}, knob_clouds(),
        port_params={path: port_enc})
    assert got == want and got_sums == want_sums
    reader = V3CReader()
    atlas = reader.decode(reader.read(got)[0]).atlas(0)
    kinds = {vt.name: vb.data[:4] for vt, vb in
             atlas.video_bitstreams.items()}
    assert kinds[comp.upper()] == b"\x00\x00\x00\x01"
    assert kinds["OCCUPANCY"] == b"RBV2"


def test_hdrtools_conversion_raises_naming_its_roadmap_item(tmp_path):
    """Ported: the HDRTools colour conversion (a stand-in HDRConvert for
    RGB444 -> YUV420 and its inverse in the closed loop) gives the JAX
    encoder's bytes and checksums."""
    from test_torch_foreign import write_hdrconvert

    binary = write_hdrconvert(tmp_path)
    (tmp_path / "fwd.cfg").write_text(
        "SourceBitDepthCmp0: 8\nSourceChromaFormat: 3\nSourceColorSpace: 1\n"
        "OutputBitDepthCmp0: 8\nOutputChromaFormat: 1\n"
        "OutputColorSpace: 0\n")
    (tmp_path / "inv.cfg").write_text(
        "SourceBitDepthCmp0: 8\nSourceChromaFormat: 1\nSourceColorSpace: 0\n"
        "OutputBitDepthCmp0: 8\nOutputChromaFormat: 3\n"
        "OutputColorSpace: 1\n")
    params = dict(KNOB_BASE, colorSpaceConversionPath=binary,
                  colorSpaceConversionConfig=str(tmp_path / "fwd.cfg"),
                  inverseColorSpaceConversionConfig=str(tmp_path / "inv.cfg"))
    (want, want_sums), (got, got_sums) = encode_both(params, knob_clouds())
    assert got == want and got_sums == want_sums
    # the stand-in's colours differ from the internal conversion's
    (plain, _), _ = encode_both(KNOB_BASE, knob_clouds())
    assert got != plain


@pytest.mark.parametrize("conversion", ["rgb444toyuv420", "yuv420torgb444"])
def test_color_convert_app_equals_the_reference_app(tmp_path, monkeypatch,
                                                    conversion):
    from rabbit_transcoding_tpu.apps import color_convert as ref_app
    from rabbit_transcoding_tpu_torch.apps import color_convert as app

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    w, h = 32, 24
    n = 2 * (3 * w * h if conversion.startswith("rgb") else w * h * 3 // 2)
    rng.integers(0, 256, size=n).astype(np.uint8).tofile("in.raw")
    args = ["--srcVideoPath=in.raw", f"--width={w}", f"--height={h}",
            f"--conversion={conversion}"]
    assert ref_app.main(args + ["--dstVideoPath=ref.raw"]) == 0
    assert app.main(args + ["--dstVideoPath=port.raw", "--device=cpu"]) == 0
    assert (tmp_path / "port.raw").read_bytes() == \
        (tmp_path / "ref.raw").read_bytes()
