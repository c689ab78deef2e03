"""One map (``mapCountMinus1=0``) through both encoders (see
``test_torch_encoder_knobs.py``); the default two maps with absolute D1/T1
run ``group_dilation`` and are covered there and by the committed streams.
Its own file: one map compiles its own JAX programs.  Also, with one map,
the full-KNN geometry smoothing that the closed loop runs without an SEI
(``gridSmoothing=0``).  No tolerance: bytes."""

import pytest

from test_torch_encoder import (  # noqa: F401 (an autouse fixture)
    KNOB_BASE, encode_both, knob_clouds, one_torch_thread)


@pytest.fixture(scope="module")
def one_map():
    return encode_both({**KNOB_BASE, "mapCountMinus1": 0}, knob_clouds())


def test_one_map_bytes_equal(one_map):
    (want, want_sums), (got, got_sums) = one_map
    assert len(want) > 500
    assert got == want


def test_one_map_closed_loop_equal(one_map):
    (_, want_sums), (_, got_sums) = one_map
    assert got_sums == want_sums


def test_knn_geometry_smoothing_bytes_equal():
    (want, want_sums), (got, got_sums) = encode_both(
        {**KNOB_BASE, "mapCountMinus1": 0, "gridSmoothing": False},
        knob_clouds())
    assert got == want
    assert got_sums == want_sums
