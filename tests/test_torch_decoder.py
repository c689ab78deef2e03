"""The port's V-PCC decoder against the JAX package's on the CPU, on the
port's own patch-carrying test stream (``testdata.make_stream(patches=True)``)
in its variants: both decoders read the same bytes and give equal
``positions``, ``colors``, ``types`` and ``partition`` per frame, as arrays in
order, and equal checksums.  Only bytes and numpy arrays pass between the
packages."""

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.decoder.decoder import Decoder as RefDecoder
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.codec.patch_frame import decode_patch_frames
from rabbit_transcoding_tpu_torch.codec.reconstruct import (
    ReconstructionEngine,
    first_occurrences,
)
from rabbit_transcoding_tpu_torch.decoder.decoder import (
    Decoder,
    DecoderParameters,
)
from rabbit_transcoding_tpu_torch.testdata import make_stream, patch_units

FIELDS = ("positions", "colors", "types", "partition", "reflectances")


def decode_port(data: bytes, **kw):
    reader = V3CReader()
    return [ps for gof in reader.read(data)
            for ps in Decoder(DecoderParameters(**kw), device="cpu").decode(
                reader.decode(gof))]


def decode_ref(data: bytes):
    reader = ref_bitstream.V3CReader()
    return [ps for gof in reader.read(data)
            for ps in RefDecoder().decode(reader.decode(gof))]


def assert_clouds_equal(got, want) -> None:
    """Per frame: every array equal in order (and of equal dtype), and the
    checksums equal."""
    assert len(got) == len(want) > 0
    for fi, (a, b) in enumerate(zip(got, want)):
        for name in FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), (fi, name)
            if x is not None:
                assert x.dtype == y.dtype, (fi, name, x.dtype, y.dtype)
                np.testing.assert_array_equal(x, y, err_msg=f"{fi} {name}")
        assert a.compute_checksum() == b.compute_checksum()


_VARIANTS = {
    "plain": dict(),
    "smoothing": dict(smoothing=True),
    "map_pair": dict(map_pair=True),
    "map_pair_smoothing": dict(map_pair=True, smoothing=True),
    "mc_intra": dict(motion=True, intra=True, smoothing=True),
    "lossless": dict(lossless=True),
}


@pytest.mark.parametrize("size", [128, 256])
@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_decoders_equal_on_the_patch_stream(variant, size):
    data = make_stream(4, size, size, patches=True, **_VARIANTS[variant])
    got = decode_port(data)
    assert_clouds_equal(got, decode_ref(data))
    assert sum(ps.point_count for ps in got) > 5000
    assert all(ps.colors is not None for ps in got)


def test_non_square_atlas_and_eight_frames():
    data = make_stream(8, 256, 128, patches=True, smoothing=True)
    assert_clouds_equal(decode_port(data), decode_ref(data))


def test_patch_stream_exercises_what_it_claims():
    data = make_stream(4, 256, 256, patches=True, smoothing=True)
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    atlas = context.atlas(0)
    frames = decode_patch_frames(atlas)
    assert [len(f) for f in frames] == [16] * 4
    patches = frames[0]
    assert {int(p.orientation) for p in patches} == set(range(8))
    assert {(p.normal_axis, p.projection_mode) for p in patches} == {
        (a, m) for a in range(3) for m in range(2)}
    # a longer patch's block box overlaps its neighbour's, and the
    # first-coded patch owns the contested blocks
    boxes = [p.canvas_bounds() for p in patches]
    overlaps = [(i, j) for i in range(16) for j in range(i + 1, 16)
                if boxes[i][0] < boxes[j][0] + boxes[j][2]
                and boxes[j][0] < boxes[i][0] + boxes[i][2]
                and boxes[i][1] < boxes[j][1] + boxes[j][3]
                and boxes[j][1] < boxes[i][1] + boxes[i][3]]
    assert overlaps
    assert atlas.asps_list[0].asps_patch_precedence_order_flag
    occ = np.ones((1, 256, 256), np.uint8)
    b2p = ReconstructionEngine(device="cpu").block_to_patch_maps(
        [patches], occ)[0]
    i, j = overlaps[0]
    contested = b2p[boxes[j][1] // 16, boxes[j][0] // 16]
    assert contested == i + 1
    # both smoothing stages ran and changed the clouds
    plain = decode_port(make_stream(4, 256, 256, patches=True))
    smooth = decode_port(data)
    assert any(a.point_count != b.point_count
               or (a.positions != b.positions).any()
               for a, b in zip(plain, smooth))
    # every coordinate stays within 10 bits
    for ps in plain:
        assert ps.positions.min() >= 0 and ps.positions.max() < 1024


def test_patches_off_leaves_the_stream_as_it_was():
    # the default arguments add nothing: no tile layer, no SEI, no ref list
    data = make_stream(2, 64, 64)
    reader = V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    assert not atlas.atlas_tile_layers and not atlas.seis_prefix
    assert not atlas.asps_list[0].ref_list_structs
    assert len(patch_units(1024, 1024)) == 256


def test_decoder_reads_the_port_s_transcoded_stream():
    from rabbit_transcoding_tpu_torch.transcoder import (
        Transcoder,
        TranscoderParameters,
        V3CWriter,
    )

    data = make_stream(4, 128, 128, patches=True, smoothing=True)
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    Transcoder(TranscoderParameters(geometryQP=28, attributeQP=38),
               "cpu").transcode(context)
    writer = V3CWriter()
    out = writer.write(writer.encode(context))
    got = decode_port(out)
    assert_clouds_equal(got, decode_ref(out))
    # the transcode moved some points
    src = decode_port(data)
    assert any(a.point_count != b.point_count
               or (a.positions != b.positions).any()
               for a, b in zip(src, got))


def test_decoder_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Decoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReconstructionEngine()
    assert Decoder(device="cpu").device == torch.device("cpu")


def test_annexb_payload_names_the_roadmap_item():
    from rabbit_transcoding_tpu_torch.utils.enums import VideoType

    dec = Decoder(device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        dec._vdec(VideoType.GEOMETRY, b"\x00\x00\x00\x01\x40\x01")
    with pytest.raises(ValueError, match="neither RBV nor"):
        dec._vdec(VideoType.GEOMETRY, b"nonsense")


@pytest.mark.parametrize("seed", [0, 1])
def testfirst_occurrences_equal_numpy_unique(seed):
    rng = np.random.default_rng(seed)
    n = 20_000
    frame = np.sort(rng.integers(0, 3, n))
    pos = rng.integers(-5, 12, (n, 3)).astype(np.int32)
    got = first_occurrences(torch.from_numpy(frame),
                             torch.from_numpy(pos)).numpy()
    rows = np.concatenate([frame[:, None], pos], axis=1)
    _, want = np.unique(rows, axis=0, return_index=True)
    np.testing.assert_array_equal(got, np.sort(want))
    # coordinates beyond the packed key: the caller falls back to the host
    pos[0, 0] = 1 << 20
    assert first_occurrences(torch.from_numpy(frame),
                              torch.from_numpy(pos)) is None
