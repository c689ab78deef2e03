"""More encoder knobs through both encoders (see
``test_torch_encoder_knobs.py``): colour pre-smoothing, geometry padding,
grid-based segmentation and refinement, lossless attributes.  No
tolerance: bytes."""

import pytest

from test_torch_encoder import (  # noqa: F401 (an autouse fixture)
    KNOB_BASE, encode_both, knob_clouds, one_torch_thread)

KNOBS = {
    "color_pre_smoothing": dict(flagColorPreSmoothing=True),
    "geometry_padding": dict(geometryPadding=1),
    "grid_based_segmentation": dict(gridBasedSegmentation=True),
    "grid_based_refine_segmentation": dict(gridBasedRefineSegmentation=True),
    "lossless_attribute": dict(losslessAttribute=True),
}


@pytest.fixture(scope="module")
def encodes():
    cache = {}
    clouds = knob_clouds()

    def get(name):
        if name not in cache:
            cache[name] = encode_both({**KNOB_BASE, **KNOBS[name]}, clouds)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(KNOBS))
def test_knob_bytes_equal(encodes, name):
    (want, want_sums), (got, got_sums) = encodes(name)
    assert len(want) > 500
    assert got == want
    assert got_sums == want_sums
