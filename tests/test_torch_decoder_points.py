"""The port's decoder on the JAX encoder's streams whose tools change which
points exist (raw points, EOM points, 45-degree projection planes, level of
detail): both decoders give equal clouds and the encoder's closed-loop
checksums.  The streams and the comparison are those of
``test_torch_decoder_streams.py``."""

import pytest

from test_torch_decoder import decode_port
from test_torch_decoder_streams import (  # noqa: F401  (streams: a fixture)
    POINT_STREAMS,
    check_stream,
    streams,
)


@pytest.mark.parametrize("name", POINT_STREAMS)
def test_decoders_equal_on_point_streams(streams, name):
    check_stream(streams, name)


def test_raw_points_belong_to_no_patch(streams):
    raw = decode_port(streams("raw_points")[0])[0]
    assert (raw.partition == -1).any() and (raw.types[raw.partition == -1]
                                            == 0).all()
