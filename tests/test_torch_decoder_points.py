"""The port's decoder on the JAX encoder's streams whose tools change which
points exist (raw points, EOM points, 45-degree projection planes, level of
detail): both decoders give equal clouds and the encoder's closed-loop
checksums.  The streams and the comparison are those of
``test_torch_decoder_streams.py``."""

import pytest
import torch

from test_torch_decoder import decode_port
from test_torch_decoder_streams import (  # noqa: F401  (streams: a fixture)
    POINT_STREAMS,
    check_stream,
    streams,
)


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


@pytest.mark.parametrize("name", POINT_STREAMS)
def test_decoders_equal_on_point_streams(streams, name):
    check_stream(streams, name)


def test_raw_points_belong_to_no_patch(streams):
    raw = decode_port(streams("raw_points")[0])[0]
    assert (raw.partition == -1).any() and (raw.types[raw.partition == -1]
                                            == 0).all()
