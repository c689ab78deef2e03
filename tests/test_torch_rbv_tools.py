"""The port's RBV coding tools against the JAX reference functions, each
called as the reference calls it (inside its jitted program): threshold,
deblocking, the intra mosaic helpers, motion search and compensation, the
MC / intra / deblocking / threshold chains and fused transcodes, DCT-domain
requantisation and the side sections.

Equality is exact.  XLA's CPU code contracts ``a * b + c`` into one FMA,
sums the intra prediction's block means in an order fixed per program, and
gives floor(log2(8192)) = 12; the port reproduces each (``ops/rbv_tools.py``).
"""

from fractions import Fraction
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.video import rbv as ref
from rabbit_transcoding_tpu_torch.ops import rbv_tools as tools
from rabbit_transcoding_tpu_torch.ops import transcode as tc
from rabbit_transcoding_tpu_torch.ops.dct import blockify, deblockify
from rabbit_transcoding_tpu_torch.video import rbv


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
    return float(np.float32(ref.qstep_of(qp)))


def _frames(f, h, w, bitdepth, seed=0, move=3):
    """Smooth moving content with a little noise: integer samples."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    maxv = (1 << bitdepth) - 1
    out = []
    for k in range(f):
        base = 0.5 + 0.35 * np.sin((xx + move * k) / 9.0) * np.cos(
            (yy - 2 * k) / 7.0)
        noise = rng.normal(scale=0.02, size=(h, w))
        out.append(np.clip((base + noise) * maxv, 0, maxv))
    return np.stack(out).astype(np.uint16 if bitdepth > 8 else np.uint8)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _blocks(frames: np.ndarray) -> torch.Tensor:
    return blockify(torch.from_numpy(frames.astype(np.float32)), 16)


def _assert_equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- numerics ----------------------------------------------------------------
def test_fma_rounds_once():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=400).astype(np.float32) * s
               for s in (1.0, 3.0, 1e-3))
    got = tools.fma(_t(a), _t(b), _t(c)).numpy()
    exact = [np.float32(float(Fraction(float(x)) * Fraction(float(y))
                              + Fraction(float(z))))
             for x, y, z in zip(a, b, c)]
    # Fraction -> float rounds to nearest double first; it is exact here
    # unless the sum needs more than 53 bits, which these inputs never do
    np.testing.assert_array_equal(got, np.array(exact, np.float32))
    xla = jax.jit(lambda x, y, z: x * y + z)(a, b, c)
    np.testing.assert_array_equal(got, np.asarray(xla))


@pytest.mark.parametrize("block", [4, 8, 16])
def test_hf_rank(block):
    np.testing.assert_array_equal(tools.hf_rank(block), ref._hf_rank(block))


@pytest.mark.parametrize("thr_k", [1, 8, 64])
def test_threshold_coeffs(thr_k):
    q = np.random.default_rng(thr_k).integers(
        -3, 4, size=(2, 3, 4, 16, 16)).astype(np.float32)
    want = jax.jit(partial(ref._threshold_coeffs, block=16, thr_k=thr_k))(q)
    _assert_equal(tools.threshold_coeffs(_t(q), 16, thr_k), want)


@pytest.mark.parametrize("qp,bitdepth", [(22, 10), (34, 10), (40, 8)])
def test_deblock(qp, bitdepth):
    rec = _frames(3, 48, 64, bitdepth, seed=qp).astype(np.float32)
    maxval = float((1 << bitdepth) - 1)
    want = jax.jit(partial(ref._deblock, block=16))(
        rec, jnp.float32(_qs(qp)), jnp.float32(maxval))
    _assert_equal(tools.deblock(_t(rec), _qs(qp), maxval, 16), want)


def test_rate_proxy_with_the_log2_quirk():
    rng = np.random.default_rng(1)
    q = rng.integers(-40, 40, size=(2, 3, 2, 16, 16)).astype(np.float32)
    q *= rng.random(q.shape) < 0.3
    special = [8192, -8192, 8191, 4096, 16384, -16384, 32767, 1, -2]
    q[0, 0, 0, 0, :len(special)] = special
    q[1, 2, 1, 5, 3] = 8192
    want = jax.jit(ref._rate_proxy)(q)
    _assert_equal(tools.rate_proxy(_t(q)), want)


def test_block_means_and_mosaic_dc_of_samples():
    x = _frames(2, 48, 64, 10).astype(np.float32)
    # integer samples sum exactly in any order
    for lanes in (True, False):
        _assert_equal(tools.block_means(_t(x), 16, lanes),
                      ref._block_means(jnp.asarray(x), 16))
    mu = np.random.default_rng(2).normal(size=(2, 3, 4)).astype(np.float32)
    _assert_equal(tools.mosaic_dc(_t(mu), 16), ref._mosaic_dc(mu, 16))


@pytest.mark.parametrize("nby,nbx", [(3, 4), (4, 4), (5, 3), (64, 64)])
def test_linear_taps_are_the_resize_weights(nby, nbx):
    from jax._src.image.scale import compute_weight_mat, _kernels
    from jax._src.image.scale import ResizeMethod

    for n_in in (nby, nbx):
        n_out = 16 * n_in
        w = np.asarray(compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0,
            _kernels[ResizeMethod.LINEAR], True))
        i0, i1, w0, w1 = tools._linear_taps(n_in, n_out)
        dense = np.zeros_like(w)
        cols = np.arange(n_out)
        dense[i0, cols] += w0
        dense[i1, cols] += w1
        np.testing.assert_array_equal(dense, w)


@pytest.mark.parametrize("h,w", [(48, 64), (64, 48)])
def test_mosaic_planar_within_one_rounding(h, w):
    # the exact two-tap form depends on XLA's program (tested through the
    # intra programs below); alone, it agrees within float32 rounding
    mu = np.random.default_rng(3).uniform(
        0, 1023, size=(2, h // 16, w // 16)).astype(np.float32)
    want = np.asarray(jax.jit(partial(ref._mosaic_planar, h=h, w=w))(mu))
    got = tools.mosaic_planar(_t(mu), h, w).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)


# --- intra, deblocking and threshold in the chains ---------------------------
_CHAIN = [
    # (h, w, gop, deblock, thr_k): both resize orders, with and without the
    # per-GOP vmap
    (48, 64, 1, False, 0), (48, 64, 1, True, 8), (48, 64, 2, False, 8),
    (64, 48, 1, False, 0), (64, 48, 2, True, 0), (64, 64, 3, False, 0),
]


@pytest.mark.parametrize("h,w,gop,deblock,thr_k", _CHAIN)
def test_intra_encode_and_decode_chains(h, w, gop, deblock, thr_k):
    # the reference's device programs take whole GOPs
    fr = _frames(2 * gop, h, w, 10, seed=gop)
    qs, maxval = _qs(26), 1023.0
    q, mode, rec = ref._encode_device(
        jnp.asarray(fr), jnp.float32(qs), jnp.float32(maxval), 16, gop,
        deblock, thr_k, True)
    got = tc.encode_chain(_blocks(fr), qs, maxval, gop, deblock=deblock,
                          thr_k=thr_k, intra=True)
    _assert_equal(got["q"], q)
    _assert_equal(got["mode"], mode)
    _assert_equal(deblockify(got["rec"]), np.asarray(rec).astype(np.float32))
    want = ref._decode_device_intra(q, mode, jnp.float32(qs),
                                    jnp.float32(maxval), 16, gop, deblock)
    dec = tc.decode_chain(_t(q), qs, maxval, gop, deblock, _t(mode))
    _assert_equal(deblockify(dec), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("h,w", [(96, 96), (80, 96)])
def test_intra_planar_resize_sums_rounded_products(h, w):
    # nby or nbx of 5 or 6: XLA's second resize product sums two rounded
    # products instead of the FMA chain; this content has planar blocks
    # whose recon tells the two forms apart
    fr = _frames(4, h, w, 10, seed=3)
    qs, maxval = _qs(29), 1023.0
    q, mode, rec = ref._encode_device(
        jnp.asarray(fr), jnp.float32(qs), jnp.float32(maxval), 16, 1, False,
        0, True)
    got = tc.encode_chain(_blocks(fr), qs, maxval, 1, intra=True)
    _assert_equal(got["q"], q)
    _assert_equal(deblockify(got["rec"]), np.asarray(rec).astype(np.float32))


@pytest.mark.parametrize("gop,deblock,thr_k", [(2, True, 0), (1, False, 8),
                                               (4, True, 8)])
def test_deblock_and_threshold_chains(gop, deblock, thr_k):
    fr = _frames(4, 48, 64, 8, seed=5)
    qs, maxval = _qs(30), 255.0
    q, rec = ref._encode_device(jnp.asarray(fr), jnp.float32(qs),
                                jnp.float32(maxval), 16, gop, deblock, thr_k)
    got = tc.encode_chain(_blocks(fr), qs, maxval, gop, deblock=deblock,
                          thr_k=thr_k)
    _assert_equal(got["q"], q)
    _assert_equal(deblockify(got["rec"]), np.asarray(rec).astype(np.float32))
    want = ref._transcode_device(q, jnp.float32(qs), jnp.float32(_qs(38)),
                                 jnp.float32(maxval), 16, gop, 2, deblock,
                                 thr_k)
    _assert_equal(tc.transcode_coeffs_ref(_t(q), qs, _qs(38), maxval, gop, 2,
                                          deblock, thr_k), want)


# --- motion search and compensation ------------------------------------------
def test_mc_predict():
    rng = np.random.default_rng(4)
    prev = rng.uniform(0, 255, size=(48, 64)).astype(np.float32)
    mv = rng.integers(0, len(tools.MC_OFFSETS), size=(3, 4)).astype(np.int32)
    want = jax.jit(partial(ref._mc_predict, block=16))(prev, mv)
    _assert_equal(tools.mc_predict(_t(prev), _t(mv), 16), want)
    assert tools.MC_OFFSETS == ref._MC_OFFSETS


@pytest.mark.parametrize("weighted,intra,deblock,thr_k", [
    (False, False, False, 0), (True, False, False, 8), (False, True, True, 0),
    (True, True, False, 0),
])
def test_mc_encode_chain(weighted, intra, deblock, thr_k):
    # content that moves 4 px per frame: the search finds non-zero motion
    fr = _frames(4, 48, 64, 10, seed=6, move=4)
    qs, maxval = _qs(28), 1023.0
    occ = (np.random.default_rng(6).random(fr.shape) > 0.4).astype(np.uint8)
    args = (jnp.float32(qs), jnp.float32(maxval), 16, 2, deblock, thr_k,
            intra)
    if weighted:
        got_ref = ref._encode_device_mc_w(jnp.asarray(fr), jnp.asarray(occ),
                                          *args)
    else:
        got_ref = ref._encode_device_mc(jnp.asarray(fr), *args)
    got = tc.encode_chain(_blocks(fr), qs, maxval, 2, deblock=deblock,
                          thr_k=thr_k, intra=intra, search=True,
                          weights=_t(occ) if weighted else None)
    _assert_equal(got["q"], got_ref[0])
    _assert_equal(got["mv"], got_ref[1])
    assert (got["mv"][1::2] != (len(tools.MC_OFFSETS) // 2)).any()
    _assert_equal(deblockify(got["rec"]),
                  np.asarray(got_ref[2]).astype(np.float32))
    if intra:
        _assert_equal(got["mode"], got_ref[3])


def test_mc_search_rate_bias_decides():
    # two candidates of equal SAD: only the rate bias separates them, and
    # the zero motion wins
    frame = np.full((16, 32), 100.0, np.float32)
    got_idx, _ = tools.mc_search(_t(frame), _t(frame), 16, 16.0)
    assert (got_idx == ref._MC_OFFSETS.index((0, 0))).all()


@pytest.mark.parametrize("intra,deblock", [(False, False), (True, False),
                                           (True, True)])
def test_mc_decode_and_transcode(intra, deblock):
    fr = _frames(6, 48, 64, 8, seed=7, move=4)
    qs, maxval = _qs(30), 255.0
    enc = ref._encode_device_mc(jnp.asarray(fr), jnp.float32(qs),
                                jnp.float32(maxval), 16, 3, deblock, 0, intra)
    q, mv = enc[0], enc[1]
    mode = enc[3] if intra else None
    if intra:
        want = ref._decode_device_mc_intra(q, mv, mode, jnp.float32(qs),
                                           jnp.float32(maxval), 16, 3,
                                           deblock)
    else:
        want = ref._decode_device_mc(q, mv, jnp.float32(qs),
                                     jnp.float32(maxval), 16, 3, deblock)
    mode_t = None if mode is None else _t(mode)
    dec = tc.decode_chain(_t(q), qs, maxval, 3, deblock, mode_t, _t(mv))
    _assert_equal(deblockify(dec), np.asarray(want).astype(np.float32))
    qs_out = _qs(36)
    if intra:
        q2, mode2 = ref._transcode_device_mc_intra(
            q, mv, mode, jnp.float32(qs), jnp.float32(qs_out),
            jnp.float32(maxval), 16, 3, deblock, 8)
    else:
        q2 = ref._transcode_device_mc(q, mv, jnp.float32(qs),
                                      jnp.float32(qs_out),
                                      jnp.float32(maxval), 16, 3, deblock, 8)
    got = tc.encode_chain(dec, qs_out, maxval, 3, recon=False,
                          deblock=deblock, thr_k=8, intra=intra, mv=_t(mv))
    _assert_equal(got["q"], q2)
    if intra:
        _assert_equal(got["mode"], mode2)


@pytest.mark.parametrize("gop_in,gop_out", [(1, 1), (2, 1), (1, 3), (3, 3)])
def test_intra_transcode(gop_in, gop_out):
    fr = _frames(6, 64, 48, 10, seed=8)
    qs, maxval = _qs(24), 1023.0
    q, mode, _ = ref._encode_device(jnp.asarray(fr), jnp.float32(qs),
                                    jnp.float32(maxval), 16, gop_in, False,
                                    0, True)
    want_q, want_mode = ref._transcode_device_intra(
        q, mode, jnp.float32(qs), jnp.float32(_qs(32)), jnp.float32(maxval),
        16, gop_in, gop_out, False, 0)
    pixels = tc.decode_chain(_t(q), qs, maxval, gop_in, False, _t(mode))
    got = tc.encode_chain(pixels, _qs(32), maxval, gop_out, recon=False,
                          intra=True)
    _assert_equal(got["q"], want_q)
    _assert_equal(got["mode"], want_mode)


# --- requantisation and side sections ----------------------------------------
@pytest.mark.parametrize("f,gop", [(4, 2), (5, 2), (6, 3), (3, 1)])
def test_requant(f, gop):
    rng = np.random.default_rng(f + gop)
    q = np.round(rng.laplace(scale=8.0, size=(f, 2, 3, 16, 16))).astype(
        np.int16)
    old, new = _qs(20), _qs(27)
    _assert_equal(tools.requant(_t(q), old, new),
                  ref._requant_device(q, jnp.float32(old), jnp.float32(new)))
    want = ref._requant_compensated_device(q, jnp.float32(old),
                                           jnp.float32(new), gop)
    _assert_equal(tools.requant_compensated(_t(q), old, new, gop), want)


def test_side_sections():
    rng = np.random.default_rng(9)
    mv = rng.integers(0, 49, size=(5, 3, 4)).astype(np.int32)
    blob = rbv._encode_mv_section(mv, 6)
    assert blob == ref._encode_mv_section(mv, 6)
    got, rest = rbv._split_mv_section(blob + b"rest", 5, 3, 4)
    np.testing.assert_array_equal(got, mv)
    assert rest == b"rest"
    mode = rng.integers(0, 2, size=(3, 3, 4)).astype(np.uint8)
    blob = rbv._encode_intra_section(mode, 6)
    assert blob == ref._encode_intra_section(mode, 6)
    got, rest, raw = rbv._split_intra_section(blob + b"rest", 3, 3, 4)
    np.testing.assert_array_equal(got, mode)
    assert (rest, raw) == (b"rest", blob)
    assert rbv._split_mv_section(b"xyz", 1, 1, 1) == (None, b"xyz")
    assert rbv._split_intra_section(b"xyz", 1, 1, 1) == (None, b"xyz", b"")
