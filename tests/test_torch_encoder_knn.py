"""The encoder's KNN, recolouring and smoothing ops of the port against the
JAX package on the CPU: ``ops/knn.py``, ``ops/recolor.py`` and
``ops/smoothing.py``'s ``knn_smooth`` / ``presmooth_colors``.  The same numpy
inputs, made from a seed, go through both; only numpy arrays pass between
the packages.

Tolerances: none.  Integer and uint8 outputs are compared for equality, and
float32 outputs bit for bit (as int32 views); KNN results are compared on
their distances (equal), and on their indices where the reference's tie
order is reproduced (``grid_knn`` sorts each query's candidates stably, as
``top_k`` keeps ties in candidate order)."""

import numpy as np
import pytest
import jax.numpy as jnp

from rabbit_transcoding_tpu.ops import knn as ref_knn
from rabbit_transcoding_tpu.ops import recolor as ref_recolor
from rabbit_transcoding_tpu.ops import smoothing as ref_smoothing
from rabbit_transcoding_tpu_torch.ops import knn, recolor, smoothing

from test_e2e_codec import make_sphere_cloud
from test_recolor_full import CASES as RECOLOR_CASES
from test_smoothing_knobs import _two_patch_slab

from test_torch_encoder import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encoder_ops import _bits_equal, _t


# --- KNN --------------------------------------------------------------------
@pytest.mark.parametrize("k,n_theta,jitter", [(1, 120, (1, 0, 0)),
                                               (4, 100, (0, 0, 0)),
                                               (64, 40, (0, 1, 1))])
def test_grid_knn_equal(k, n_theta, jitter):
    """Distances equal; indices equal too, ties included (stable order)."""
    pts = make_sphere_cloud(n_theta=n_theta).positions.astype(np.int32)
    queries = (pts[::3] + np.asarray(jitter, np.int32)).astype(np.int32)
    cap = max(32, k)
    d_ref, i_ref = ref_knn.grid_knn(jnp.asarray(queries), jnp.asarray(pts),
                                    k=k, cap=cap, chunk=1024)
    d, i = knn.grid_knn(_t(queries), _t(pts), k=k, cap=cap, chunk=700)
    assert _bits_equal(d_ref, d.numpy())
    assert np.array_equal(np.asarray(i_ref), i.numpy())


def test_knn_wrapper_sizes_cells_as_the_reference():
    pts = make_sphere_cloud(n_theta=80).positions
    queries = pts[::5] + np.array([0, 2, 0], np.int32)
    d_ref, _ = ref_knn.knn(queries, pts, k=4)
    d, _ = knn.knn(queries, pts, k=4, device="cpu")
    assert _bits_equal(d_ref, d)
    refs = np.zeros((10, 3), np.int32)
    far = np.array([[900, 900, 900]], np.int32)
    d, i = knn.knn(far, refs, k=1, device="cpu")
    assert np.isinf(d[0, 0]) and i[0, 0] == -1


# --- recolouring -------------------------------------------------------------
def _recolor_inputs(seed: int):
    rng = np.random.default_rng(seed)
    src = make_sphere_cloud(radius=20, center=40, n_theta=90, seed=seed)
    src_pts = src.positions.astype(np.float32)
    dst = (src.positions[::2]
           + rng.integers(-1, 2, size=(len(src.positions[::2]), 3)))
    return src_pts, src.colors, dst.astype(np.float32)


@pytest.mark.parametrize("case", range(len(RECOLOR_CASES)))
def test_transfer_colors_fwd_bwd_equal(case):
    """The reference's recolouring knob cases (test_recolor_full.py) on
    integer clouds, where the native grid KNN answers."""
    src_pts, src_col, dst = _recolor_inputs(20 + case)
    p = RECOLOR_CASES[case]
    want = ref_recolor.transfer_colors_fwd_bwd(
        src_pts, src_col, dst, ref_recolor.RecolorParams(**vars(p)))
    got = recolor.transfer_colors_fwd_bwd(
        src_pts, src_col, dst, recolor.RecolorParams(**vars(p)))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("k", [1, 4])
def test_transfer_colors_device_equal(k):
    src_pts, src_col, dst = _recolor_inputs(3)
    # an isolated outlier takes the host fix-up
    dst = np.concatenate([dst, [[900.0, 900.0, 900.0]]]).astype(np.float32)
    want = ref_recolor.transfer_colors_device(src_pts, src_col, dst, k=k)
    got = recolor.transfer_colors_device(src_pts, src_col, dst, k=k,
                                         device="cpu")
    assert np.array_equal(want, got)


# --- smoothing --------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(neighbor_count=64, radius2=36.0, radius2_boundary=36.0,
         threshold=16.0),
    dict(neighbor_count=16, radius2=64.0, radius2_boundary=9.0,
         threshold=4.0),
])
def test_knn_smooth_equal(kw):
    pos, part = _two_patch_slab()
    rng = np.random.default_rng(11)
    pos = pos.copy()
    moved_rows = rng.choice(len(pos), 200, replace=False)
    pos[moved_rows, 2] += rng.integers(1, 6, size=200)
    elig = rng.random(len(pos)) < 0.8
    want = ref_smoothing.knn_smooth(pos, part, eligible=elig, **kw)
    got = smoothing.knn_smooth(pos, part, eligible=elig, device="cpu", **kw)
    assert want[1] == got[1] and want[1] > 0
    assert np.array_equal(want[0], got[0])


@pytest.mark.parametrize("kw", [
    dict(radius2=9.0, max_neighbors=32, threshold=20.0, entropy_threshold=4.5),
    dict(radius2=64.0, max_neighbors=64, threshold=10.0,
         entropy_threshold=3.0),
])
def test_presmooth_colors_equal(kw):
    cloud = make_sphere_cloud(radius=20, center=40, n_theta=90, seed=5)
    rng = np.random.default_rng(12)
    cols = cloud.colors.copy()
    spikes = rng.choice(len(cols), 50, replace=False)
    cols[spikes] = 255 - cols[spikes]
    elig = rng.random(len(cols)) < 0.5
    want = ref_smoothing.presmooth_colors(cloud.positions, cols,
                                          eligible=elig, **kw)
    got = smoothing.presmooth_colors(cloud.positions, cols, eligible=elig,
                                     **kw)
    assert want[1] == got[1]
    assert np.array_equal(want[0], got[0])
