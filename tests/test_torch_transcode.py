"""The port's fused GOP transcode (plain PyTorch version, which the CUDA
wrapper takes for CPU tensors) against the JAX reference: the XLA path
``rbv._transcode_device`` and the Pallas kernel in interpret mode.

Equality is exact: the port sums its 16-term products in the reference's
order (ops/dct.py), so no coefficient flips at a rounding boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.ops.pallas_transcode import transcode_coeffs_pallas
from rabbit_transcoding_tpu.video.rbv import (
    _decode_device,
    _encode_device,
    _transcode_device,
    qstep_of,
)
from rabbit_transcoding_tpu_torch.ops import transcode as tc
from rabbit_transcoding_tpu_torch.ops.dct import blockify, deblockify


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


def _qs(qp: int) -> float:
    return float(np.float32(qstep_of(qp)))


def _jax_transcode(c, qs_in, qs_out, maxval, gop_in, gop_out):
    return np.asarray(_transcode_device(
        jnp.asarray(c), jnp.float32(qs_in), jnp.float32(qs_out),
        jnp.float32(maxval), 16, gop_in, gop_out,
    ))


def _frames(f: int, h: int, w: int, bitdepth: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    scale = (1 << bitdepth) / 1024.0
    return np.stack([
        (300 + 120 * np.sin((xx + 7 * k) / 37.0) * np.cos((yy - 3 * k) / 29.0))
        * scale for k in range(f)
    ]).astype(np.uint16 if bitdepth > 8 else np.uint8)


def _encoded(f, h, w, bitdepth, qp, gop) -> np.ndarray:
    maxval = float((1 << bitdepth) - 1)
    q, _ = _encode_device(jnp.asarray(_frames(f, h, w, bitdepth)),
                          jnp.float32(_qs(qp)), jnp.float32(maxval), 16, gop)
    return np.array(q)


@pytest.mark.parametrize("gop", [1, 2, 4])
def test_random_coeffs_match_xla_and_pallas(gop):
    rng = np.random.default_rng(0)
    c = rng.integers(-60, 60, size=(4, 3, 4, 16, 16)).astype(np.int16)
    args = (_qs(16), _qs(32), 1023.0)
    got = tc.transcode_coeffs_ref(torch.from_numpy(c), *args, gop, gop)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_transcode(c, *args, gop, gop))
    pallas = np.asarray(transcode_coeffs_pallas(jnp.asarray(c), gop, *args,
                                                interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("bitdepth,qp_in,qp_out,gop_out", [
    (10, 16, 32, 2), (10, 16, 32, 1), (8, 22, 42, 2), (8, 22, 42, 1),
])
def test_encoded_content_matches_xla(bitdepth, qp_in, qp_out, gop_out):
    c = _encoded(4, 64, 96, bitdepth, qp_in, 2)
    args = (_qs(qp_in), _qs(qp_out), float((1 << bitdepth) - 1), 2, gop_out)
    got = tc.transcode_coeffs_ref(torch.from_numpy(c), *args)
    np.testing.assert_array_equal(got.numpy(), _jax_transcode(c, *args))


def test_identity_qp_on_real_coefficients():
    # as tests/test_pallas_transcode.py: an identity-QP transcode of a
    # decodable stream reproduces its coefficients except at deadzone
    # borderlines, and equals the Pallas kernel exactly
    yy, xx = np.mgrid[0:32, 0:64]
    frames = np.stack(
        [128 + 90 * np.sin((xx + 3 * f) / 7.0) * np.cos(yy / 5.0)
         for f in range(2)]
    ).astype(np.float32)
    qs = qstep_of(24)
    coeffs, _ = _encode_device(
        jnp.asarray(frames), jnp.float32(qs), jnp.float32(255.0), 16, 1
    )
    coeffs = np.array(coeffs)
    got = tc.transcode_coeffs_ref(torch.from_numpy(coeffs), _qs(24), _qs(24),
                                  255.0, 1, 1).numpy()
    assert (got == coeffs).mean() > 0.97
    pallas = np.asarray(transcode_coeffs_pallas(jnp.asarray(coeffs), 1, qs,
                                                qs, 255.0, interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("f,gop_in,gop_out", [(5, 2, 2), (3, 2, 1),
                                              (5, 1, 2), (7, 4, 2)])
def test_ragged_last_gop_matches_padded_reference(f, gop_in, gop_out):
    # the reference pads to whole GOPs by repeating the last frame; the
    # chains are causal, so the unpadded port gives the same first f frames
    c = _encoded(f, 32, 48, 10, 16, 1)
    args = (_qs(16), _qs(32), 1023.0)
    padded = c
    for g in (gop_in, gop_out):
        pad = (-padded.shape[0]) % g
        padded = np.concatenate([padded, np.repeat(padded[-1:], pad, 0)])
    want = _jax_transcode(padded, *args, gop_in, gop_out)[:f]
    got = tc.transcode_coeffs_ref(torch.from_numpy(c), *args, gop_in, gop_out)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gop", [1, 2, 3])
def test_encode_and_decode_chains_match_jax(gop):
    frames = _frames(6, 32, 48, 10)
    qs, maxval = _qs(20), 1023.0
    q_ref, rec_ref = _encode_device(jnp.asarray(frames), jnp.float32(qs),
                                    jnp.float32(maxval), 16, gop)
    coded = tc.encode_chain(
        blockify(torch.from_numpy(frames.astype(np.float32)), 16), qs,
        maxval, gop)
    q, rec = coded["q"], coded["rec"]
    np.testing.assert_array_equal(q.numpy(), np.array(q_ref))
    np.testing.assert_array_equal(deblockify(rec).numpy(),
                                  np.asarray(rec_ref).astype(np.float32))
    dec_ref = _decode_device(q_ref, jnp.float32(qs), jnp.float32(maxval), 16,
                             gop)
    dec = deblockify(tc.decode_chain(q, qs, maxval, gop))
    np.testing.assert_array_equal(dec.numpy(),
                                  np.asarray(dec_ref).astype(np.float32))


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    c = torch.from_numpy(
        rng.integers(-60, 60, size=(4, 2, 3, 16, 16)).astype(np.int16))
    before = tc.LAUNCHES
    got = tc.transcode_coeffs(c, _qs(16), _qs(32), 1023.0, 2, 1)
    assert tc.LAUNCHES == before  # no kernel launched
    np.testing.assert_array_equal(
        got.numpy(),
        tc.transcode_coeffs_ref(c, _qs(16), _qs(32), 1023.0, 2, 1).numpy())


def test_wrapper_rejects_other_devices():
    c = torch.zeros((2, 1, 1, 16, 16), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        tc.transcode_coeffs(c, 1.0, 2.0, 255.0, 1, 1)


def test_kernel_dct_literals_are_the_package_matrix():
    # the CUDA kernels carry D as hexadecimal float literals (their FMA
    # immediates, in the header they share): they must be dct_matrix(16)'s
    # float32 values, bit for bit
    import re
    from pathlib import Path

    from rabbit_transcoding_tpu.ops.dct import dct_matrix as ref_dct_matrix
    from rabbit_transcoding_tpu_torch.ops.dct import dct_matrix

    src = (Path(tc.__file__).resolve().parents[1] / "csrc"
           / "block16.cuh").read_text()
    table = re.search(r"constexpr float kD\[kB \* kB\] = \{(.*?)\};", src,
                      re.S).group(1)
    lits = re.findall(r"-?0x[0-9a-f.]+p[-+]?\d+f", table)
    got = np.array([float.fromhex(x[:-1]) for x in lits], np.float32)
    assert got.shape == (256,)
    want = dct_matrix(16).reshape(-1)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    np.testing.assert_array_equal(want, np.asarray(ref_dct_matrix(16)
                                                   ).reshape(-1))


def test_dct_matrix_symmetry_that_the_kernel_shares():
    # the kernel's products with D^T compute out[15 - x] from out[x]'s
    # partial sums: D[k][15 - x] = (-1)^k D[k][x] bit for bit
    from rabbit_transcoding_tpu_torch.ops.dct import dct_matrix

    d = dct_matrix(16)
    sign = np.where(np.arange(16) % 2, -1, 1).astype(np.float32)[:, None]
    assert (d[:, ::-1] * sign).view(np.uint32).tolist() == \
        d.view(np.uint32).tolist()


def test_transcode_bound_counts():
    luma = (32, 64, 64, 16, 16)
    dense_ms, by = tc.transcode_bound_ms(luma, 2, dense=True)
    assert by == "operations" and abs(dense_ms - 0.08013) < 1e-5
    # distinct chains: half of a D^T row's products are its mirror's, and D's
    # first and middle rows share theirs
    assert tc.row_flops() == (213, 468)
    ms, by = tc.transcode_bound_ms(luma, 2)
    assert by == "operations" and abs(ms - 0.04930) < 1e-5
    # S streams: S times the work
    s4, _ = tc.transcode_bound_ms((4,) + luma, 2)
    assert abs(s4 - 4 * ms) < 1e-9
    # one frame per GOP: no closed-loop IDCT; bytes bound a tiny plane
    assert tc.transcode_bound_ms(luma, 1)[0] < ms
