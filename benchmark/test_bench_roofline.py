"""The frozen roofline count against hand-worked shapes and the program's
own count."""

import math

import pytest

from benchmark import roofline


def test_row_flops_are_below_the_dense_count():
    idct, dct = roofline.row_flops()
    # a dense 16-term row: 16 outputs x 16 FMAs of 2 FLOPs
    assert 0 < idct < 512 and 0 < dct < 512


@pytest.mark.parametrize("shape, us, kind", [
    ((32, 64, 64, 16, 16), 49.30, "operations"),     # luma, GOP 2 -> 2
    ((32, 32, 32, 16, 16), 12.32, "operations"),     # a 4:2:0 chroma plane
    ((4, 32, 64, 64, 16, 16), 197.19, "operations"),  # four streams batched
])
def test_bound_of_the_main_path_shapes(shape, us, kind):
    ms, got = roofline.bound_ms(shape, 2)
    assert got == kind
    assert ms * 1e3 == pytest.approx(us, abs=0.01)


def test_bound_by_hand_for_one_block_row():
    idct, dct = roofline.row_flops()
    f, gop = 4, 2
    # one IDCT and one DCT a frame, one recon IDCT for frames 0 and 2
    flops = 1 * 2 * 16 * ((f + 2) * idct + f * dct)
    ms, kind = roofline.bound_ms((f, 1, 1, 16, 16), gop)
    byte_ms = 2 * 2 * f * 256 / 3.35e12 * 1e3
    assert ms == pytest.approx(max(flops / 67e12 * 1e3, byte_ms))
    assert kind == ("operations" if flops / 67e12 * 1e3 >= byte_ms
                    else "bytes")


def test_bound_is_linear_in_streams_and_blocks():
    one, _ = roofline.bound_ms((32, 64, 64, 16, 16), 2)
    four, _ = roofline.bound_ms((4, 32, 64, 64, 16, 16), 2)
    assert math.isclose(four, 4 * one)


def test_frozen_count_equals_the_programs():
    from rabbit_transcoding_tpu_torch.ops.transcode import (
        transcode_bound_ms)

    for shape in ((32, 64, 64, 16, 16), (32, 32, 32, 16, 16),
                  (4, 32, 64, 64, 16, 16), (7, 3, 5, 16, 16)):
        for gop in (1, 2, 4):
            assert roofline.bound_ms(shape, gop) == transcode_bound_ms(
                shape, gop)
