"""The decoder's device functions of the port against the JAX package's on
the CPU, on inputs made from a numpy seed: the occupancy ops (binarise,
lossy prefilter, patch-border filtering), pixel de-interleaving, the colour
conversion (every up-filter) and the three smoothing grids.  Integer
functions give equal integers; the float ones give equal bytes, because the
port rounds where the reference's compiled CPU code rounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.codec import reconstruct as ref_recon
from rabbit_transcoding_tpu.ops import color as ref_color
from rabbit_transcoding_tpu.ops import interleave as ref_il
from rabbit_transcoding_tpu.ops import occupancy as ref_occ
from rabbit_transcoding_tpu.ops import smoothing as ref_sm
from rabbit_transcoding_tpu_torch.codec import reconstruct as recon
from rabbit_transcoding_tpu_torch.ops import color, interleave, occupancy
from rabbit_transcoding_tpu_torch.ops import smoothing as sm


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# --- occupancy ---------------------------------------------------------------
@pytest.mark.parametrize("threshold", [0, 1, 127])
def test_binarize_equal(threshold):
    occ = np.random.default_rng(threshold).integers(
        0, 256, (3, 40, 56)).astype(np.uint8)
    _eq(occupancy.binarize(_t(occ), threshold),
        ref_occ.binarize(jnp.asarray(occ), threshold))


@pytest.mark.parametrize("seed,shape", [(0, (2, 32, 48)), (1, (1, 5, 3)),
                                        (2, (3, 64, 64))])
def test_prefilter_lossy_om_equal(seed, shape):
    rng = np.random.default_rng(seed)
    planes = (rng.random(shape) < 0.4).astype(np.uint8) * 255
    _eq(occupancy.prefilter_lossy_om(_t(planes)),
        ref_occ.prefilter_lossy_om(jnp.asarray(planes)))


def _pbf_inputs(seed: int, f: int = 2, h: int = 64, w: int = 80):
    """Block occupancy owned by a few patches, smooth depth with a drifting
    rim and noise, so that some boundary pixels pass the threshold and some
    do not."""
    rng = np.random.default_rng(seed)
    owner_b = rng.integers(0, 4, (f, h // 8, w // 8)).astype(np.int32)
    owner = np.repeat(np.repeat(owner_b, 8, 1), 8, 2)
    occ = (owner > 0).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    geo = (200 + 30 * np.sin(xx / 9.0) * np.cos(yy / 7.0))[None].repeat(f, 0)
    geo = geo + rng.integers(-6, 7, geo.shape) * (rng.random(geo.shape) < 0.3)
    return occ, geo.astype(np.int32), owner


@pytest.mark.parametrize("radius,passes", [(1, 1), (1, 2), (2, 2), (2, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pbf_refine_equal(seed, radius, passes):
    occ, geo, owner = _pbf_inputs(seed)
    want = np.asarray(ref_occ.pbf_refine(
        jnp.asarray(occ), jnp.asarray(geo), jnp.asarray(owner),
        jnp.float32(4.0), passes=passes, radius=radius))
    got = occupancy.pbf_refine(_t(occ), _t(geo), _t(owner), 4.0,
                               passes=passes, radius=radius)
    _eq(got, want)
    dropped = occ.astype(bool) & ~want
    assert dropped.any() and (want & occ.astype(bool)).any()


def _ring_case(rim: int):
    occ = np.zeros((1, 32, 32), np.uint8)
    occ[0, 4:28, 4:28] = 1                      # 24x24 patch
    geo = np.full((1, 32, 32), 100, np.int32)
    # the outer ring of the patch carries fill at ``rim``
    geo[0, 4:28, 4] = rim
    geo[0, 4:28, 27] = rim
    geo[0, 4, 4:28] = rim
    geo[0, 27, 4:28] = rim
    return occ, geo, occ.astype(np.int32)       # single patch id 1


def test_pbf_off_surface_rim_eroded():
    occ, geo, owner = _ring_case(140)
    out = occupancy.pbf_refine(_t(occ), _t(geo), _t(owner), 4.0, passes=2,
                               radius=1).numpy()
    # rim dropped, interior intact
    assert not out[0, 4, 10] and not out[0, 10, 4]
    assert out[0, 6:26, 6:26].all()


def test_pbf_on_surface_rim_kept():
    occ, geo, owner = _ring_case(100)           # smooth everywhere
    out = occupancy.pbf_refine(_t(occ), _t(geo), _t(owner), 4.0, passes=2,
                               radius=1).numpy()
    assert (out == occ.astype(bool)).all()


def test_pbf_wrap_band_is_masked():
    # content at both atlas edges: a radius-2 window must not reach around
    occ, geo, owner = _pbf_inputs(3, f=1, h=32, w=32)
    occ[:, :, :3] = 1
    occ[:, :, -3:] = 1
    owner[:, :, :3] = 1
    owner[:, :, -3:] = 1
    geo[:, :, :3] = 50
    geo[:, :, -3:] = 900
    _eq(occupancy.pbf_refine(_t(occ), _t(geo), _t(owner), 4.0, radius=2),
        ref_occ.pbf_refine(jnp.asarray(occ), jnp.asarray(geo),
                           jnp.asarray(owner), jnp.float32(4.0), radius=2))


@pytest.mark.parametrize("seed", [0, 1])
def test_occupancy_boundary_rings_equal(seed):
    occ, _, _ = _pbf_inputs(seed)
    occ[0, 0, :] = 1
    np.testing.assert_array_equal(recon.occupancy_boundary(occ),
                                  ref_recon.occupancy_boundary(occ))
    np.testing.assert_array_equal(recon.occupancy_near_boundary(occ),
                                  ref_recon.occupancy_near_boundary(occ))
    got = recon.occupancy_boundary(_t(occ))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_recon.occupancy_boundary(occ))


# --- pixel interleaving --------------------------------------------------------
@pytest.mark.parametrize("use_occ", [False, True])
@pytest.mark.parametrize("thickness", [None, 1, 4])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_deinterleave_maps_equal(use_occ, thickness, dtype):
    rng = np.random.default_rng(7)
    top = 1000 if dtype == np.int32 else 256
    plane = rng.integers(0, top, (2, 24, 37)).astype(dtype)
    occ = (rng.random(plane.shape) < 0.6).astype(np.uint8)
    want = ref_il.deinterleave_maps(
        jnp.asarray(plane), occ=jnp.asarray(occ) if use_occ else None,
        thickness=thickness)
    got = interleave.deinterleave_maps(
        _t(plane), occ=_t(occ) if use_occ else None, thickness=thickness)
    for g, w in zip(got, want):
        _eq(g, w)


def test_interleave_maps_equal():
    rng = np.random.default_rng(8)
    m0 = rng.integers(0, 1000, (2, 9, 14)).astype(np.int32)
    m1 = rng.integers(0, 1000, (2, 9, 14)).astype(np.int32)
    _eq(interleave.interleave_maps(_t(m0), _t(m1)),
        ref_il.interleave_maps(jnp.asarray(m0), jnp.asarray(m1)))


# --- colour --------------------------------------------------------------------
def _yuv(seed: int, f: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (f, h, w)).astype(np.uint8),
            rng.integers(0, 256, (f, h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (f, h // 2, w // 2)).astype(np.uint8))


def test_up_filter_bank_equal():
    assert color._UP_FILTERS == ref_color._UP_FILTERS


@pytest.mark.parametrize("up_filter", list(ref_color._UP_FILTERS))
@pytest.mark.parametrize("seed,f,h,w", [(0, 2, 64, 96), (1, 1, 256, 256)])
def test_yuv420_to_rgb8_equal_bytes(seed, f, h, w, up_filter):
    y, u, v = _yuv(seed, f, h, w)
    want = ref_color.yuv420_to_rgb8(jnp.asarray(y), jnp.asarray(u),
                                    jnp.asarray(v), up_filter)
    _eq(color.yuv420_to_rgb8(_t(y), _t(u), _t(v), up_filter), want)


def test_yuv420_to_rgb8_every_luma_chroma_pair():
    # every (y, u) pair in frame 0 and every (y, v) pair in frame 1, the
    # other chroma neutral: 2 x 65,536 distinct conversions (each on a 2x2
    # pixel quad under the nearest filter)
    rows, cols = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    y = np.repeat(np.repeat(rows, 2, 0), 2, 1)
    neutral = np.full_like(cols, 128)
    y = np.stack([y, y]).astype(np.uint8)
    u = np.stack([cols, neutral]).astype(np.uint8)
    v = np.stack([neutral, cols]).astype(np.uint8)
    want = ref_color.yuv420_to_rgb8(jnp.asarray(y), jnp.asarray(u),
                                    jnp.asarray(v), "nearest")
    _eq(color.yuv420_to_rgb8(_t(y), _t(u), _t(v), "nearest"), want)


def test_yuv709_to_rgb_float_forms_equal():
    rng = np.random.default_rng(5)
    y, u, v = (rng.random((3, 50_000)).astype(np.float32))
    want = ref_color.yuv709_to_rgb(jnp.asarray(y), jnp.asarray(u),
                                   jnp.asarray(v))
    got = color.yuv709_to_rgb(_t(y), _t(u), _t(v))
    for g, w in zip(got, want):
        _eq(g, w)
    # the naive forms (rounded products, a true division by Kg) differ, so
    # this comparison can tell them apart
    ty, tu, tv = _t(y), _t(u) - 0.5, _t(v) - 0.5
    r = ty + color._C_R * tv
    b = ty + color._C_B * tu
    g = (ty - np.float32(color._KR) * r - np.float32(color._KB) * b) / (
        np.float32(color._KG))
    assert (g.numpy() != np.asarray(want[1])).mean() > 0.01
    assert (r.numpy() != np.asarray(want[0])).mean() > 0.01


@pytest.mark.parametrize("n", [1, 1000, 40_001])
def test_yuv16_to_rgb8_equal_bytes(n):
    yuv = np.random.default_rng(n).integers(0, 65536, (n, 3)).astype(
        np.uint16)
    want = ref_color.yuv16_to_rgb8(jnp.asarray(yuv))
    _eq(color.yuv16_to_rgb8(_t(yuv.astype(np.int32))), want)


# --- smoothing -------------------------------------------------------------------
def _cloud(seed: int, n: int = 30_000, ext: int = 200):
    """A noisy sphere surface without duplicate points, in random order:
    patch indices in stripes (several per cell), colours smooth plus noise,
    half the points eligible."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = np.round(ext / 2 + (ext / 2 - 10) * d
                 + rng.normal(scale=1.5, size=(n, 3))).astype(np.int32)
    p = np.unique(p, axis=0)
    rng.shuffle(p)
    n = len(p)
    part = ((p[:, 0] // 20) + (p[:, 1] // 24) * 16).astype(np.int32)
    base = 128 + 60 * np.sin(p[:, 0] / 17.0) + 30 * np.cos(p[:, 1] / 11.0)
    col = np.clip(base[:, None] + rng.normal(scale=6, size=(n, 3))
                  + np.array([0, 10, -10]), 0, 255).astype(np.uint8)
    return p, col, part, rng.random(n) < 0.5


def _padded(n: int, *arrays):
    """The arrays padded with zeros to the reference's power-of-two
    bucket, and the valid mask."""
    cap = 1 << max(10, (n - 1).bit_length())
    out = []
    for a in arrays:
        b = np.zeros((cap,) + a.shape[1:], a.dtype)
        b[:n] = a
        out.append(jnp.asarray(b))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return out, jnp.asarray(valid)


_GRIDS = [(8, 32), (4, 64), (16, 16)]
# a 27-cell count near the cloud's median, so the density test drops some
_MIN_NEIGHBORS = {8: 170.0, 4: 45.0, 16: 600.0}


@pytest.mark.parametrize("grid_size,grid_dim", _GRIDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_smooth_equal(seed, grid_size, grid_dim):
    p, _, _, elig = _cloud(seed)
    n = len(p)
    (pp, ee), valid = _padded(n, p, elig)
    min_nb = _MIN_NEIGHBORS[grid_size]
    want = ref_sm.grid_smooth(pp, valid, jnp.float32(2.0),
                              jnp.float32(min_nb), ee, grid_size, grid_dim)
    got = sm.grid_smooth(_t(p), torch.ones(n, dtype=torch.bool), 2.0, min_nb,
                         _t(elig), grid_size, grid_dim)
    for g, w in zip(got, want):
        _eq(g, np.asarray(w)[:n])
    moved, keep = np.asarray(want[2])[:n], np.asarray(want[1])[:n]
    assert 0 < moved.sum() < n and 0 < keep.sum() < n


@pytest.mark.parametrize("grid_size,grid_dim", _GRIDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_color_grid_smooth_equal(seed, grid_size, grid_dim):
    p, col, _, _ = _cloud(seed)
    n = len(p)
    (pp, cc), valid = _padded(n, p, col)
    want = ref_sm.color_grid_smooth(pp, cc, valid, jnp.float32(4.0),
                                    grid_size, grid_dim)
    got = sm.color_grid_smooth(_t(p), _t(col),
                               torch.ones(n, dtype=torch.bool), 4.0,
                               grid_size, grid_dim)
    for g, w in zip(got, want):
        _eq(g, np.asarray(w)[:n])
    assert 0 < np.asarray(want[1])[:n].sum() < n


@pytest.mark.parametrize("thr,variation,difference", [
    (10.0, 255.0, 255.0), (20.0, 12.0, 6.0), (30.0, 8.0, 3.0)])
@pytest.mark.parametrize("grid_size,grid_dim", [(8, 32), (16, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_color_grid_smooth_gated_equal(seed, grid_size, grid_dim, thr,
                                       variation, difference):
    p, col, part, elig = _cloud(seed)
    n = len(p)
    (pp, cc, pt, ee), valid = _padded(n, p, col, part, elig)
    want = ref_sm.color_grid_smooth_gated(
        pp, cc, valid, pt, ee, jnp.float32(thr), jnp.float32(variation),
        jnp.float32(difference), grid_size, grid_dim)
    got = sm.color_grid_smooth_gated(
        _t(p), _t(col), torch.ones(n, dtype=torch.bool), _t(part), _t(elig),
        thr, variation, difference, grid_size, grid_dim)
    for g, w in zip(got, want):
        _eq(g, np.asarray(w)[:n])
    assert 0 < np.asarray(want[1])[:n].sum() < n


def test_smoothing_float_forms_equal():
    """The 3-term luma dot, the sum of squares and the variance as the
    reference's compiled code forms them (fused multiply-adds), on values
    where the unfused forms differ."""
    import jax

    rng = np.random.default_rng(9)
    x = (rng.random((50_000, 3)) * 255).astype(np.float32)
    lw = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)
    want = np.asarray(jax.jit(lambda c: c @ lw)(jnp.asarray(x)))
    np.testing.assert_array_equal(sm._dot_lw(_t(x)).numpy(), want)
    t = _t(x)
    naive = (t[:, 0] * sm._LW[0] + t[:, 1] * sm._LW[1]) + t[:, 2] * sm._LW[2]
    assert (naive.numpy() != want).mean() > 0.01
    want = np.asarray(jax.jit(lambda c: jnp.sum(c ** 2, axis=1))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(sm._sum_squares(t).numpy(), want)
    want = np.asarray(jax.jit(lambda q, m: q - m ** 2)(
        jnp.asarray(x[:, 0] * 200), jnp.asarray(x[:, 1])))
    np.testing.assert_array_equal(
        sm._variance(t[:, 0] * 200, t[:, 1]).numpy(), want)


def test_scatter_sum_adds_in_point_order():
    # float values whose sum depends on the order: a serial sum in point
    # order, cell by cell
    rng = np.random.default_rng(11)
    n, cells = 200_000, 50
    flat = rng.integers(0, cells, n)
    vals = (rng.random((n, 2)) * 1000).astype(np.float32)
    got = sm._scatter_sum(_t(flat), _t(vals), cells).numpy()
    want = np.zeros((cells, 2), np.float32)
    for c in range(cells):
        for k in range(2):
            acc = np.float32(0)
            for v in vals[flat == c, k]:
                acc = np.float32(acc + v)
            want[c, k] = acc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("coord_bits,grid_size", [(10, 8), (10, 2), (11, 4)])
def test_host_wrappers_equal(coord_bits, grid_size):
    p, col, part, elig = _cloud(3, n=8000)
    want = ref_sm.smooth_cloud(p, 2.0, 6, grid_size, coord_bits, elig)
    got = sm.smooth_cloud(p, 2.0, 6, grid_size, coord_bits, elig,
                          device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0
    for partition in (None, part):
        want = ref_sm.smooth_colors(p, col, 10.0, grid_size, coord_bits,
                                    partition, elig, 40.0, 30.0)
        got = sm.smooth_colors(p, col, 10.0, grid_size, coord_bits,
                               partition, elig, 40.0, 30.0, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert sm.smooth_cloud(p[:0], device="cpu")[2] == 0
    assert sm.smooth_colors(p[:0], col[:0], device="cpu")[1] == 0


def test_batched_clouds_equal_one_by_one(monkeypatch):
    """Several clouds through one call of a grid (each in its own cells of
    one accumulator) give what each gives alone, also across the wrappers'
    batch limit and with an empty cloud among them."""
    monkeypatch.setattr(sm, "_BATCH_CLOUDS", 2)
    clouds = [_cloud(s, n=4000 + 1500 * s, ext=80 + 30 * s)
              for s in range(4)]
    empty = tuple(a[:0] for a in clouds[0])
    clouds.insert(2, empty)
    many = sm.smooth_clouds([(p, e) for p, _, _, e in clouds], 2.0, 20, 8,
                            10, device="cpu")
    for (p, _, _, e), got in zip(clouds, many):
        want = sm.smooth_cloud(p, 2.0, 20, 8, 10, e, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert sum(m for _, _, m in many) > 0
    for gated in (True, False):
        many = sm.smooth_colors_many(
            [(p, c, pt if gated else None, e) for p, c, pt, e in clouds],
            10.0, 8, 10, 40.0, 30.0, device="cpu")
        for (p, c, pt, e), got in zip(clouds, many):
            want = sm.smooth_colors(p, c, 10.0, 8, 10, pt if gated else None,
                                    e, 40.0, 30.0, device="cpu")
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        assert sum(m for _, m in many) > 0


def test_xla_cpu_sqrt_is_within_one_ulp_of_ieee():
    """The one float form of the decoder that the port does not reproduce:
    the reference's compiled ``sqrt`` differs from the correctly rounded one
    at a small share of inputs, by one unit in the last place.  The gated
    colour filter only compares it against integer-valued thresholds."""
    import jax

    x = (np.random.default_rng(0).random(30_001) * 60_000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sqrt)(jnp.asarray(x)))
    got = torch.sqrt(_t(x)).numpy()
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    print(f"sqrt: {(ulps > 0).sum()} of {len(x)} differ, max {ulps.max()} ulp")
    assert ulps.max() <= 1
    assert (ulps > 0).mean() < 0.02
