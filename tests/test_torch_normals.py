"""The port's normals generator against the JAX package's on the CPU.

Inputs are numpy arrays from a seed; only numpy arrays pass between the
packages.  What is held, and how tightly:

* the KNN graph and the spanning-tree orientation are the same C++ source:
  equal (``test_torch_host_copies.py``);
* the covariances are reproduced bit for bit (one fused multiply-add chain
  over the k neighbours in index order): tolerance 0;
* the eigen-decompositions are reproduced too (both call LAPACK ``ssyevd``
  from scipy's ``cython_lapack``; ``test_torch_eigh.py`` holds them bit for
  bit, ROADMAP queue 3 item g.9): the ceilings below date from when they
  were not.  Raw PCA normals are compared with the sign ignored, oriented
  normals as they are.  The measured mismatch (the share of normals beyond
  1e-5 rad and beyond 1e-3 rad, the largest angle; measured 0) is printed
  and asserted under the ceilings.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rabbit_transcoding_tpu import native as ref_native
from rabbit_transcoding_tpu.encoder import normals as ref
from rabbit_transcoding_tpu_torch import native, testdata
from rabbit_transcoding_tpu_torch.encoder import normals as port
from rabbit_transcoding_tpu_torch.testdata import normals_mismatch as mismatch


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


# ceilings on the mismatch of unit normals, port on the CPU against JAX on
# the CPU (measured: largest angle 1.4e-6 rad on the three clouds below, no
# normal beyond 1e-5 rad, no sign differs after the orientation)
MAX_ANGLE = 1e-5          # rad
SHARE_BEYOND_1E5 = 0.0
SHARE_BEYOND_1E3 = 0.0


def angles(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle in rad between corresponding rows, in float64."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=1),
                      (a * b).sum(axis=1))


def assert_under_ceilings(m: dict, signed: bool = True) -> None:
    pre = "" if signed else "unsigned_"
    assert m[pre + "max_angle"] <= MAX_ANGLE, m
    assert m[pre + "share_beyond_1e-5"] <= SHARE_BEYOND_1E5, m
    assert m[pre + "share_beyond_1e-3"] <= SHARE_BEYOND_1E3, m


def _t(x):
    return torch.from_numpy(np.array(x))


def _sphere(n=500, radius=40.0, center=(64.0, 64.0, 64.0), seed=3):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (np.asarray(center) + radius * v).astype(np.float32)


def _voxel_sphere(center, r, n, seed):
    rng = np.random.default_rng(seed)
    th = np.arccos(1 - 2 * rng.uniform(0, 1, n))
    ph = rng.uniform(0, 2 * np.pi, n)
    return np.round(center + r * np.stack([
        np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th),
    ], 1)).astype(np.float32)


# name -> (cloud maker, points asked for)
_CLOUDS = {"sphere": ("make_frame", 20000),
           "scene": ("make_scene_frame", 20000),
           "dense": ("make_dense_frame", 40000)}


@pytest.fixture(scope="module")
def clouds():
    cache = {}

    def get(name):
        if name not in cache:
            maker, n = _CLOUDS[name]
            pts = getattr(testdata, maker)(0, n=n).positions.astype(np.float32)
            cache[name] = (pts, port.knn_indices(pts, 16))
        return cache[name]
    return get


def test_native_library_has_all_three_sources():
    assert native.available() and ref_native.available()


@pytest.mark.parametrize("name", list(_CLOUDS))
def test_knn_graphs_equal(clouds, name):
    pts, idx = clouds(name)
    np.testing.assert_array_equal(idx, ref.knn_indices(pts, 16))
    got_i, got_d = port.knn_graph(pts, 8)
    want_i, want_d = ref.knn_graph(pts, 8)
    np.testing.assert_array_equal(got_d, want_d)      # tolerance 0
    np.testing.assert_array_equal(got_i, want_i)


@jax.jit
def _ref_cov(points, nbr_idx):
    """The covariance of ``ref._pca_normals``, before its ``eigh``."""
    nbrs = points[nbr_idx]
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    return jnp.einsum("nki,nkj->nij", centered, centered,
                      precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 37.5)])
def test_covariances_equal_bit_for_bit(seed, scale):
    """Random float points (no product is exact): the index-order sum and
    the fused multiply-add chain give XLA's bits.  Tolerance 0."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((3000, 3)) * scale).astype(np.float32)
    idx = ref.knn_indices(pts, 16)
    want = np.asarray(_ref_cov(jnp.asarray(pts), jnp.asarray(idx)))
    nbrs = _t(pts)[_t(idx).long()]
    mean = (port._sum_k(nbrs) / 16)[:, None, :]
    np.testing.assert_array_equal(port._cov(nbrs - mean).numpy(), want)
    # the order matters: a library product does not give these bits
    plain = torch.einsum("nki,nkj->nij", nbrs - mean, nbrs - mean).numpy()
    assert (plain != want).any()


@pytest.mark.parametrize("name", list(_CLOUDS))
def test_pca_normals_within_the_recorded_mismatch(clouds, name):
    pts, idx = clouds(name)
    want = np.asarray(ref._pca_normals(jnp.asarray(pts), jnp.asarray(idx)))
    got = port._pca_normals(_t(pts), _t(idx).long()).numpy()
    m = mismatch(got, want)
    print(f"pca normals, {name}, {len(pts)} points:", m)
    # the sign of an eigenvector is free: compare with the sign ignored
    assert_under_ceilings(m, signed=False)


@pytest.mark.parametrize("name", list(_CLOUDS))
def test_compute_normals_within_the_recorded_mismatch(clouds, name):
    """Oriented unit normals: the tree fixes the signs, so they compare as
    they are.  This is the mismatch that ROADMAP records."""
    pts, idx = clouds(name)
    want, want_idx = ref.compute_normals(pts)
    got, got_idx = port.compute_normals(pts, device="cpu")
    np.testing.assert_array_equal(got_idx, want_idx)
    assert got.dtype == np.float32 and got.shape == want.shape
    m = mismatch(got, want)
    print(f"oriented normals, {name}, {len(pts)} points:", m)
    assert_under_ceilings(m)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_compute_normals_takes_a_graph_and_an_integer_cloud(clouds):
    pts, idx = clouds("sphere")
    pts, idx = pts[:3000], port.knn_indices(pts[:3000], 8)
    want, _ = ref.compute_normals(pts.astype(np.int32), nbr_idx=idx)
    got, got_idx = port.compute_normals(pts.astype(np.int32), nbr_idx=idx,
                                        device="cpu")
    assert got_idx is idx or np.array_equal(got_idx, idx)
    assert_under_ceilings(mismatch(got, want))


def _graph(n=4000, seed=5, k=16):
    pts = _voxel_sphere(np.array([128.0, 128.0, 128.0]), 50, n, seed)
    idx = ref.knn_indices(pts, k)
    rng = np.random.default_rng(seed)
    normals = rng.standard_normal((len(pts), 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, idx, normals


def test_orient_sweep_signs_equal():
    """Same input normals: a sweep only flips signs, so the outputs are
    equal as arrays unless a vote is within rounding of 0 (share of equal
    rows >= 0.999; measured 1.0)."""
    pts, idx, normals = _graph()
    want = np.asarray(ref._orient_sweep(jnp.asarray(normals),
                                        jnp.asarray(idx)))
    got = port._orient_sweep(_t(normals), _t(idx).long()).numpy()
    assert (got == want).all(axis=1).mean() >= 0.999
    assert (got != normals).any()


@pytest.mark.parametrize("sweeps", [0, 2])
def test_orient_all_sign_pattern(sweeps):
    """The centroid is a float32 mean over all N points, whose order XLA
    chooses: held on the sign pattern (share of equal signs >= 0.999) and
    on the angle (<= 1e-5 rad where the signs agree)."""
    pts, idx, _ = _graph()
    pca = np.asarray(ref._pca_normals(jnp.asarray(pts), jnp.asarray(idx)))
    want = np.asarray(ref._orient_all(jnp.asarray(pca), jnp.asarray(pts),
                                      jnp.asarray(idx), sweeps))
    got = port._orient_all(_t(pca), _t(pts), _t(idx).long(), sweeps).numpy()
    same = (got * want).sum(axis=1) > 0
    assert same.mean() >= 0.999
    assert angles(got[same], want[same]).max() <= 1e-5


@pytest.mark.parametrize("radius", [np.inf, 3.0])
def test_pca_normals_full_equal_up_to_the_eigenvectors(radius):
    """Barycentres and counts equal (tolerance 0), eigenvalues within 1e-4
    of the largest (float32 eigen-solvers), normals under the ceilings
    (signs fixed by the viewpoint flip, so compared as they are wherever
    the normal is not perpendicular to the view ray within 1e-4)."""
    pts, _, _ = _graph(seed=9)
    idx, dist = ref.knn_graph(pts, 12)
    ok = dist <= radius
    ok[:, 0] = True
    vp = np.array([300.0, 10.0, -40.0], np.float32)
    want = [np.asarray(x) for x in ref._pca_normals_full(
        jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(ok), jnp.asarray(vp))]
    got = [x.numpy() for x in port._pca_normals_full(
        _t(pts), _t(idx).long(), _t(ok), _t(vp))]
    np.testing.assert_array_equal(got[2], want[2])     # barycentres
    np.testing.assert_array_equal(got[3], want[3])     # counts
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-4 * float(want[1].max()))
    # a count of 1 or 2 leaves the normal free: compare where the
    # smallest eigenvalue is simple
    vals = want[1]
    simple = (vals[:, 1] - vals[:, 0]) > 1e-3 * np.maximum(vals[:, 2], 1e-6)
    ray = vp[None] - pts
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    decided = np.abs((want[0] * ray).sum(axis=1)) > 1e-4
    keep = simple & decided
    assert keep.mean() > (0.9 if radius == np.inf else 0.3)
    assert_under_ceilings(mismatch(got[0][keep], want[0][keep]))
    m = mismatch(got[0][simple], want[0][simple])
    assert m["unsigned_max_angle"] <= MAX_ANGLE, m


@pytest.mark.parametrize("weight,iterations", [(1.0, 1), (0.8, 4)])
def test_smooth_normals_close(weight, iterations):
    """Same input normals; float32 sums and norms in another order: the
    largest angle stays under 1e-5 rad."""
    pts, idx, normals = _graph(k=8)
    dist = np.linalg.norm(pts[idx] - pts[:, None, :], axis=2)
    ok = dist <= 4.0
    want = np.asarray(ref._smooth_normals(
        jnp.asarray(normals), jnp.asarray(idx), jnp.asarray(ok),
        jnp.float32(weight), iterations))
    got = port._smooth_normals(_t(normals), _t(idx).long(), _t(ok),
                               float(np.float32(weight)), iterations).numpy()
    assert angles(got, want).max() <= 1e-5
    assert angles(got, normals).max() > 0.1


_GEN_CASES = {
    "defaults": dict(),
    "no_orientation": dict(orientation_strategy=0),
    "viewpoint": dict(orientation_strategy=2, view_point=(300.0, 64.0, 64.0)),
    "cubemap": dict(orientation_strategy=3),
    "tree_other_k_and_radius": dict(knn_normal_orientation=8,
                                    radius_normal_orientation=6.0,
                                    view_point=(0.0, 500.0, 0.0)),
    "smoothed": dict(knn_normal_estimation=6, orientation_strategy=2,
                     view_point=(300.0, 64.0, 64.0), smoothing_iterations=3,
                     weight_normal_smoothing=0.8, knn_normal_smoothing=10,
                     radius_normal_smoothing=8.0),
    "stores": dict(store_eigenvalues=True, store_centroids=True,
                   store_number_of_nearest_neighbors=True,
                   radius_normal_estimation=5.0),
}


@pytest.mark.parametrize("case", list(_GEN_CASES))
def test_generate_normals_against_the_reference(case):
    """Every orientation strategy and the store flags, on a voxelised
    sphere: the same keys; normals under the ceilings; barycentres and
    counts equal; eigenvalues within 1e-4 of the largest."""
    kw = _GEN_CASES[case]
    pts = _voxel_sphere(np.array([64.0, 64.0, 64.0]), 40, 3000, 21)
    pts = np.unique(pts, axis=0)
    want = ref.generate_normals(pts, ref.NormalsGenParams(**kw))
    got = port.generate_normals(pts, port.NormalsGenParams(**kw),
                                device="cpu")
    assert set(got) == set(want)
    keep = np.ones(len(pts), bool)
    if "eigenvalues" in want:
        # few neighbours inside the radius cap: where the two smallest
        # eigenvalues are (nearly) equal the normal is free, and two
        # solvers pick different ones (seen: 0.098 rad at one point while
        # the port used torch's eigh; both now call the same ssyevd)
        vals = want["eigenvalues"]
        keep = (vals[:, 1] - vals[:, 0]) > 1e-2 * np.maximum(vals[:, 2], 1e-6)
        assert keep.mean() > 0.9
    m = mismatch(got["normals"][keep], want["normals"][keep])
    print(f"generate_normals {case}:", m)
    if kw.get("orientation_strategy", 1) == 0:
        # no orientation: the estimation-time flip toward the origin decides
        # the sign, free where the normal is perpendicular to the ray
        assert m["unsigned_max_angle"] <= MAX_ANGLE, m
        assert m["share_beyond_1e-3"] <= 1e-3, m
    else:
        assert_under_ceilings(m)
    if "centroids" in want:
        np.testing.assert_array_equal(got["centroids"], want["centroids"])
        np.testing.assert_array_equal(got["nn_counts"], want["nn_counts"])
        assert got["nn_counts"].dtype == np.uint32
        np.testing.assert_allclose(
            got["eigenvalues"], want["eigenvalues"], rtol=0,
            atol=1e-4 * float(want["eigenvalues"].max()))


# --- tests/test_aux_apps.py::TestGenerateNormals through the port ------------
class TestGenerateNormals:
    def test_unit_length_and_surface_alignment(self):
        pts = _sphere()
        n = port.generate_normals(pts, port.NormalsGenParams(),
                                  device="cpu")["normals"]
        assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)
        radial = pts - pts.mean(axis=0)
        radial /= np.linalg.norm(radial, axis=1, keepdims=True)
        assert np.mean(np.abs(np.einsum("nc,nc->n", n, radial)) > 0.9) > 0.95

    def test_viewpoint_orientation(self):
        pts = _sphere()
        vp = (300.0, 64.0, 64.0)
        out = port.generate_normals(
            pts, port.NormalsGenParams(view_point=vp, orientation_strategy=2),
            device="cpu")
        dots = np.einsum("nc,nc->n", out["normals"], np.asarray(vp)[None] - pts)
        assert (dots >= -1e-5).all()

    def test_spanning_tree_analog_is_consistent(self):
        pts = _sphere()
        out = port.generate_normals(
            pts, port.NormalsGenParams(orientation_strategy=1), device="cpu")
        dots = np.einsum("nc,nc->n", out["normals"], pts - pts.mean(axis=0))
        frac_out = np.mean(dots > 0)
        assert frac_out > 0.95 or frac_out < 0.05

    def test_cubemap_orientation_points_outward(self):
        pts = _sphere(n=800)
        out = port.generate_normals(
            pts, port.NormalsGenParams(orientation_strategy=3), device="cpu")
        dots = np.einsum("nc,nc->n", out["normals"], pts - pts.mean(axis=0))
        assert np.mean(dots > 0) > 0.9

    def test_smoothing_reduces_noise(self):
        pts = _sphere(n=800)
        base = dict(knn_normal_estimation=4, orientation_strategy=2,
                    view_point=(300.0, 64.0, 64.0))
        rough = port.generate_normals(
            pts, port.NormalsGenParams(**base), device="cpu")["normals"]
        smooth = port.generate_normals(
            pts, port.NormalsGenParams(smoothing_iterations=4,
                                       weight_normal_smoothing=0.8, **base),
            device="cpu")["normals"]
        radial = pts - pts.mean(axis=0)
        radial /= np.linalg.norm(radial, axis=1, keepdims=True)

        def err(n):
            return np.mean(1.0 - np.abs(np.einsum("nc,nc->n", n, radial)))
        assert err(smooth) <= err(rough) + 1e-6

    def test_store_flags(self):
        pts = _sphere(n=200)
        out = port.generate_normals(
            pts, port.NormalsGenParams(
                store_eigenvalues=True, store_centroids=True,
                store_number_of_nearest_neighbors=True), device="cpu")
        assert out["eigenvalues"].shape == (200, 3)
        assert (out["eigenvalues"][:, 0]
                <= out["eigenvalues"][:, 2] + 1e-6).all()
        assert out["centroids"].shape == (200, 3)
        assert (out["nn_counts"] == 16).all()

    def test_radius_cap_limits_neighbors(self):
        pts = _sphere(n=200)
        out = port.generate_normals(
            pts, port.NormalsGenParams(
                radius_normal_estimation=1e-6,
                store_number_of_nearest_neighbors=True), device="cpu")
        assert (out["nn_counts"] == 1).all()  # only self survives the cap


# --- tests/test_normals_orientation.py through the port ----------------------
def consistency(normals, pos, center):
    """Per-body sign consistency: the fraction of the dominant sign of
    dot(normal, outward).  1.0 = every normal on the same side."""
    out = np.einsum("nc,nc->n", normals, pos - center) > 0
    return max(out.mean(), 1.0 - out.mean())


@pytest.fixture(scope="module")
def multibody():
    """A large sphere + a small FAR OFF-CENTER body: the global centroid
    sits inside the big sphere, so centroid-outward seeding is wrong for
    half the small body."""
    a = _voxel_sphere(np.array([100.0, 100.0, 100.0]), 60, 12000, 0)
    b = _voxel_sphere(np.array([350.0, 120.0, 100.0]), 25, 3000, 1)
    pts = np.concatenate([a, b])
    idx = port.knn_indices(pts, 16)
    pca = port._pca_normals(_t(pts), _t(idx).long()).numpy()
    return pts, idx, pca, len(a)


class TestMultiBody:
    def test_tree_orients_every_body(self, multibody):
        pts, idx, pca, na = multibody
        tree = port.orient_spanning_tree(pca, pts, idx)
        assert consistency(tree[:na], pts[:na],
                           np.array([100.0, 100.0, 100.0])) > 0.99
        assert consistency(tree[na:], pts[na:],
                           np.array([350.0, 120.0, 100.0])) > 0.99

    def test_sweeps_misorient_small_body(self, multibody):
        pts, idx, pca, na = multibody
        sweep = port._orient_all(_t(pca), _t(pts), _t(idx).long(), 2).numpy()
        assert consistency(sweep[na:], pts[na:],
                           np.array([350.0, 120.0, 100.0])) < 0.9

    def test_component_count(self, multibody):
        pts, idx, pca, _ = multibody
        n = np.ascontiguousarray(pca, np.float32).copy()
        comps = native.orient_normals_tree(
            n, pts, idx, np.ones(idx.shape, np.uint8),
            np.zeros(3, np.float32))
        assert comps >= 2

    def test_tree_equal_to_the_reference_on_the_same_pca(self, multibody):
        pts, idx, pca, _ = multibody
        np.testing.assert_array_equal(
            port.orient_spanning_tree(pca, pts, idx),
            ref.orient_spanning_tree(pca, pts, idx))


class TestConvexEquivalence:
    def test_sphere_tree_matches_sweeps(self):
        pts = _voxel_sphere(np.array([128.0, 128.0, 128.0]), 80, 15000, 3)
        idx = port.knn_indices(pts, 16)
        pca = port._pca_normals(_t(pts), _t(idx).long()).numpy()
        tree = port.orient_spanning_tree(pca, pts, idx)
        sweep = port._orient_all(_t(pca), _t(pts), _t(idx).long(), 2).numpy()
        agree = (np.einsum("nc,nc->n", tree, sweep) > 0).mean()
        assert max(agree, 1.0 - agree) > 0.999, agree

    def test_compute_normals_uses_tree(self):
        center = np.array([128.0, 128.0, 128.0])
        pts = _voxel_sphere(center, 60, 8000, 4)
        n, _ = port.compute_normals(pts.astype(np.int32), device="cpu")
        assert consistency(n, pts, center) > 0.999
        assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


class TestThinSheet:
    def test_two_layer_sheet_consistent(self):
        rng = np.random.default_rng(5)
        m = 8000
        xy = rng.uniform(0, 200, (m, 2))
        z = np.where(rng.random(m) < 0.5, 100.0, 101.0)
        pts = np.round(np.column_stack([xy, z])).astype(np.float32)
        idx = port.knn_indices(pts, 16)
        pca = port._pca_normals(_t(pts), _t(idx).long()).numpy()
        tree = port.orient_spanning_tree(pca, pts, idx)
        sign = np.einsum("nc,c->n", tree, np.array([0.0, 0.0, 1.0]))
        frac = (sign > 0).mean()
        assert frac > 0.99 or frac < 0.01, frac


# --- the fallbacks and the device ---------------------------------------------
def test_without_the_native_library_both_fall_back_to_the_sweeps(monkeypatch):
    """No native library: cKDTree for the graph, the sweeps for the signs,
    in both packages.  Distances equal; sign pattern share >= 0.999."""
    def gone(*a, **k):
        raise RuntimeError("native library unavailable")
    for mod in (native, ref_native):
        monkeypatch.setattr(mod, "knn_grid", gone)
        monkeypatch.setattr(mod, "orient_normals_tree", gone)
    pts = _voxel_sphere(np.array([128.0, 128.0, 128.0]), 50, 4000, 8)
    pts = np.unique(pts, axis=0)
    np.testing.assert_array_equal(port.knn_graph(pts, 8)[1],
                                  ref.knn_graph(pts, 8)[1])
    want, _ = ref.compute_normals(pts)
    got, _ = port.compute_normals(pts, device="cpu")
    same = (got * want).sum(axis=1) > 0
    assert same.mean() >= 0.999
    assert angles(got[same], want[same]).max() <= 1e-5
    want = ref.generate_normals(pts)["normals"]
    got = port.generate_normals(pts, device="cpu")["normals"]
    same = (got * want).sum(axis=1) > 0
    assert same.mean() >= 0.999
    # tiny clouds pad the graph with the point itself
    tiny = pts[:5]
    np.testing.assert_array_equal(port.knn_indices(tiny, 8),
                                  ref.knn_indices(tiny, 8))


def test_normals_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _sphere(n=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compute_normals(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.generate_normals(pts)
