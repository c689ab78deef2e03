"""The encoder's device ops of the port against the JAX package on the CPU:
the encoder's half of ``ops/color.py`` and ``ops/dilate.py``'s fills (the
KNN, recolouring and smoothing ops are in ``test_torch_encoder_knn.py``).
The same numpy inputs, made from a seed, go through both; only numpy arrays
pass between the packages.

Tolerances: none.  Integer and uint8 outputs are compared for equality, and
float32 outputs bit for bit (as int32 views)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rabbit_transcoding_tpu.ops import color as ref_color
from rabbit_transcoding_tpu.ops import dilate as ref_dilate
from rabbit_transcoding_tpu_torch.ops import color, dilate

from test_torch_encoder import one_torch_thread  # noqa: F401 (autouse)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


# --- colour -----------------------------------------------------------------
def test_rgb_to_yuv709_float_forms_equal():
    """The compiled reference computes y = fma(Kb, b, fma(Kr, r, Kg * g))
    and u, v = fma(b - y, c, 0.5) with c the float32 of 0.5 / (1 - K):
    equal bit for bit on every 8-bit level of each channel."""
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 256, size=(3, 2, 96, 96)).astype(np.float32)
         / np.float32(255.0))
    want = ref_color.rgb_to_yuv709(*(jnp.asarray(c) for c in x))
    got = color.rgb_to_yuv709(*(_t(c) for c in x))
    for w, g in zip(want, got):
        assert _bits_equal(w, g.numpy())


def test_rgb_to_yuv709_unfused_forms_differ():
    """The FMA forms matter: plain products and sums differ from the
    reference on this input (so the test above tells them apart)."""
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 256, size=(3, 1, 64, 64)).astype(np.float32)
         / np.float32(255.0))
    y = np.asarray(ref_color.rgb_to_yuv709(*(jnp.asarray(c) for c in x))[0])
    r, g, b = (_t(c) for c in x)
    plain = (r * float(np.float32(0.2126)) + g * float(np.float32(0.7152))
             + b * float(np.float32(0.0722)))
    assert not _bits_equal(y, plain.numpy())


@pytest.mark.parametrize("filt", [0, 1, 2, 3, "box"])
def test_downsample_chroma_equal(filt):
    rng = np.random.default_rng(1)
    p = rng.random((2, 40, 56)).astype(np.float32)
    assert _bits_equal(ref_color.downsample_chroma(jnp.asarray(p), filt),
                       color.downsample_chroma(_t(p), filt).numpy())


@pytest.mark.parametrize("filt", [0, 1, 2, 3, "box"])
def test_rgb8_to_yuv420_equal(filt):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, size=(2, 48, 64, 3)).astype(np.uint8)
    want = ref_color.rgb8_to_yuv420(jnp.asarray(rgb), filt)
    got = color.rgb8_to_yuv420(_t(rgb), filt)
    for w, g in zip(want, got):
        assert g.dtype == torch.uint8
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("filt", [1, 2])
def test_rgb8_to_yuv420_patch_aware_equal(filt):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, size=(2, 48, 64, 3)).astype(np.uint8)
    # blocky owners with background, as the encoder's patch-id map
    pid = np.repeat(np.repeat(
        rng.integers(-1, 4, size=(2, 6, 8)), 8, axis=1), 8, axis=2)
    want = ref_color.rgb8_to_yuv420_patch_aware(
        jnp.asarray(rgb), jnp.asarray(pid.astype(np.int32)), filt)
    got = color.rgb8_to_yuv420_patch_aware(
        _t(rgb), _t(pid.astype(np.int32)), filt)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


# --- fills ------------------------------------------------------------------
def _plane_and_occupancy(seed: int, shape=(3, 64, 32)):
    rng = np.random.default_rng(seed)
    img = np.round(rng.random(shape) * 1023).astype(np.float32)
    occ = (rng.random(shape) < 0.2).astype(np.uint8)
    return img, occ


@pytest.mark.parametrize("iterations", [1, 2, 8])
def test_dilate_equal(iterations):
    """From the second pass on the values are means of means: the
    neighbour sums' order decides the bits."""
    img, occ = _plane_and_occupancy(4)
    want = ref_dilate.dilate(jnp.asarray(img), jnp.asarray(occ),
                             iterations=iterations)
    got = dilate.dilate(_t(img), _t(occ), iterations)
    assert _bits_equal(want, got.numpy())


def test_harmonic_fill_equal():
    img, occ = _plane_and_occupancy(5)
    assert _bits_equal(
        ref_dilate.harmonic_fill(jnp.asarray(img), jnp.asarray(occ)),
        dilate.harmonic_fill(_t(img), _t(occ)).numpy())


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_background_fill_equal(mode):
    """attributeBGFill 0-3 on planes that need padding to powers of two."""
    rng = np.random.default_rng(6 + mode)
    planes = (rng.random((6, 50, 40)) * 255).astype(np.float32)
    occ = (rng.random((6, 50, 40)) < 0.3).astype(np.uint8)
    want = ref_dilate.background_fill(planes, occ, mode)
    got = dilate.background_fill(planes, occ, mode, device="cpu")
    assert _bits_equal(want, got)


@pytest.mark.parametrize("channels", [0, 3])
def test_group_dilation_equal(channels):
    rng = np.random.default_rng(10 + channels)
    shape = (4, 16, 24) + ((channels,) if channels else ())
    filled = (rng.random(shape) * 255).astype(np.float32)
    occ = (rng.random((2, 16, 24)) < 0.5).astype(np.uint8)
    want = ref_dilate.group_dilation(filled.copy(), occ, 2)
    got = dilate.group_dilation(filled.copy(), occ, 2)
    assert _bits_equal(want, got)
