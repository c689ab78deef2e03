"""The decoder's half of the foreign route, on the CPU: V3C streams with
HEVC sub-streams of the stand-in codec, decoded through the stand-in
binaries by the port's decoder and the JAX package's.  Clouds equal as
arrays in order (tolerance 0).  The streams, the binaries and the helpers
are ``test_torch_foreign.py``'s."""

from test_torch_decoder import assert_clouds_equal
from test_torch_foreign import (  # noqa: F401 (fixtures)
    _paths, bins, decode_port, decode_ref, mock_stream, no_binaries,
    one_torch_thread, rbv_stream, rewrite, videos_of)


def test_decoder_on_a_stand_in_stream(mock_stream, rbv_stream, bins,
                                      no_binaries):
    """Every video an HEVC stand-in payload, decoded through the binaries
    named by the videoDecoder*Path parameters: clouds equal the JAX
    decoder's, and the RBV stream's (the stand-in is lossless at these
    QPs only for the occupancy, so the points move)."""
    got = decode_port(mock_stream, **_paths(bins["port"]))
    assert_clouds_equal(got, decode_ref(mock_stream, **_paths(bins["ref"])))
    assert sum(ps.point_count for ps in got) > 1000


def test_decoder_on_a_mixed_stream(rbv_stream, mock_stream, bins,
                                   no_binaries, monkeypatch):
    """RBV occupancy and attribute with an HEVC geometry, the decoder
    binary found through RABBIT_HM_APP_DECODER."""
    data = rewrite(rbv_stream,
                   GEOMETRY=videos_of(mock_stream)["GEOMETRY"])
    clouds = {}
    for pkg, run in (("port", decode_port), ("ref", decode_ref)):
        monkeypatch.setenv("RABBIT_HM_APP_DECODER", bins[pkg][1])
        clouds[pkg] = run(data)
    assert_clouds_equal(clouds["port"], clouds["ref"])
