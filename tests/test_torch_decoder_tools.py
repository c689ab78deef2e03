"""The port's decoder on the JAX encoder's streams, one per coding tool the
decoder has a branch for (lossy occupancy with patch-border filtering, point
local reconstruction, pixel interleaving): both decoders give equal clouds
and the encoder's closed-loop checksums.  The streams and the comparison are those
of ``test_torch_decoder_streams.py``."""

import pytest

from test_torch_decoder_streams import (  # noqa: F401  (streams: a fixture)
    TOOL_STREAMS,
    check_stream,
    streams,
)


@pytest.mark.parametrize("name", TOOL_STREAMS)
def test_decoders_equal_on_tool_streams(streams, name):
    check_stream(streams, name)


def test_plr_stream_codes_a_mode_per_patch(streams):
    from rabbit_transcoding_tpu_torch.bitstream import V3CReader
    from rabbit_transcoding_tpu_torch.codec.patch_frame import (
        decode_patch_frames,
    )

    reader = V3CReader()
    atlas = reader.decode(reader.read(streams("plr")[0])[0]).atlas(0)
    assert any(p.plr_mode for p in decode_patch_frames(atlas)[0])
