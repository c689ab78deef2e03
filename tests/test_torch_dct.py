"""The port's block DCT helpers against the JAX reference (ops/dct.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.ops import dct as ref
from rabbit_transcoding_tpu_torch.ops import dct


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


def _blocks(seed: int, shape=(6, 5, 16, 16)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1023, 1023, size=shape).astype(np.float32)


def test_dct_matrix_equal():
    for n in (4, 8, 16):
        np.testing.assert_array_equal(dct.dct_matrix(n), ref.dct_matrix(n))


@pytest.mark.parametrize("fn", ["dct2d", "idct2d"])
@pytest.mark.parametrize("seed", [0, 1])
def test_transform_matches_jax(fn, seed):
    x = _blocks(seed)
    want = np.asarray(getattr(ref, fn)(jnp.asarray(x)))
    got = getattr(dct, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("fn", ["dct2d", "idct2d"])
def test_transform_bit_exact(fn):
    # matmul4 sums in the reference's CPU order, so the transforms agree
    # bit for bit (what keeps the quantised coefficients identical)
    x = _blocks(2, shape=(3, 7, 16, 16))
    want = np.asarray(getattr(ref, fn)(jnp.asarray(x)))
    got = getattr(dct, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_round_trip():
    x = torch.from_numpy(_blocks(3))
    np.testing.assert_allclose(dct.idct2d(dct.dct2d(x)).numpy(), x.numpy(),
                               rtol=0, atol=1e-3)


def test_blockify_deblockify_match_jax():
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 1024, size=(3, 48, 64)).astype(np.float32)
    want = np.asarray(ref.blockify(jnp.asarray(frames), 16))
    got = dct.blockify(torch.from_numpy(frames), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dct.deblockify(got).numpy(), frames)


def test_pad_to_block_matches_jax():
    x = np.arange(2 * 19 * 23, dtype=np.uint16).reshape(2, 19, 23)
    np.testing.assert_array_equal(dct.pad_to_block(x, 16),
                                  ref.pad_to_block(x, 16))
