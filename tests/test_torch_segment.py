"""The port's patch segmentation against the JAX package's on the CPU.

Given the same normals (the JAX normals, passed as numpy through the port's
``_segmentation_normals`` seam), both packages give the same PPI, the same
refined PPI and the same patch list, on the point-KNN refinement and on
``gridBasedRefineSegmentation``.  The scores and the refinement steps are
held bit for bit: the reference's compiled CPU code makes the score dot an
FMA chain in index order and each refinement step one FMA
(``encoder/segment.py``'s docstring); argmaxes need no tolerance.

With each package's own normals the normals are equal bit for bit (the
port's ``eigh`` calls the LAPACK ``ssyevd`` that jaxlib calls, ROADMAP queue
3 item g.9, closed), so no point near a tie between two directions takes the
other one: ``test_ppi_share_with_own_normals`` records the share of points
whose PPI differs (printed with ``-s``; measured 0) and holds it under 1%,
and ``test_torch_eigh.py::test_ppi_equal_with_own_normals`` holds it at 0."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rabbit_transcoding_tpu import testdata as ref_testdata
from rabbit_transcoding_tpu.encoder import segment as ref_segment
from rabbit_transcoding_tpu.encoder.normals import knn_indices
from rabbit_transcoding_tpu_torch.encoder import segment

from test_torch_encoder import one_torch_thread  # noqa: F401 (autouse)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _unit_normals(n: int, seed: int) -> np.ndarray:
    nrm = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("axis_weight", [None, (0.6, 0.8, 1.0)])
def test_ppi_scores_equal_bit_for_bit(mode, axis_weight):
    nrm = _unit_normals(4000, mode)
    w = ref_segment._direction_weights(mode, axis_weight)
    want = np.asarray(ref_segment._ppi_scores(jnp.asarray(nrm),
                                              jnp.asarray(w), mode))
    got = segment._ppi_scores(_t(nrm), _t(w), mode).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    want_ppi = ref_segment.initial_segmentation(nrm, mode, axis_weight)
    assert np.array_equal(
        want_ppi, segment.initial_segmentation(nrm, mode, axis_weight, "cpu"))


def _refine_inputs(seed: int, n: int = 3000, k: int = 16):
    rng = np.random.default_rng(seed)
    nrm = _unit_normals(n, seed)
    w = ref_segment._direction_weights(1, (0.7, 0.9, 1.0))
    scores = np.asarray(ref_segment._ppi_scores(jnp.asarray(nrm),
                                                jnp.asarray(w), 1))
    ppi = scores.argmax(axis=1).astype(np.int32)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    return scores, ppi, idx


@pytest.mark.parametrize("lam", [3.0 / 48, 3.0 / 7, 2.5 / 11])
def test_refine_all_equal(lam):
    """lambda / k inexact in float32 (3/7, 2.5/11): the step's FMA decides
    near-ties."""
    scores, ppi, idx = _refine_inputs(1)
    lam32 = np.float32(lam)
    want = np.asarray(ref_segment._refine_all(
        jnp.asarray(ppi), jnp.asarray(scores), jnp.asarray(idx),
        jnp.float32(lam32), 5))
    got = segment._refine_all(_t(ppi), _t(scores), _t(idx).long(),
                              float(lam32), 5).numpy()
    assert np.array_equal(want, got)


def test_grid_refine_all_equal():
    scores, ppi, _ = _refine_inputs(2)
    rng = np.random.default_rng(3)
    n, n_vox = len(ppi), 300
    inv = rng.integers(0, n_vox, size=n).astype(np.int32)
    adj = rng.integers(0, n_vox, size=(n_vox, 24)).astype(np.int32)
    ok = rng.random((n_vox, 24)) < 0.7
    weights = (3.0 / rng.integers(1, 60, size=n_vox)).astype(np.float32)
    want = np.asarray(ref_segment._grid_refine_all(
        jnp.asarray(ppi), jnp.asarray(scores), jnp.asarray(inv),
        jnp.asarray(adj), jnp.asarray(ok), jnp.asarray(weights), 4, n_vox))
    got = segment._grid_refine_all(
        _t(ppi), _t(scores), _t(inv).long(), _t(adj).long(), _t(ok),
        _t(weights), 4, n_vox).numpy()
    assert np.array_equal(want, got)


def _assert_patches_equal(want, got):
    segs_w, missed_w = want
    segs_g, missed_g = got
    assert np.array_equal(missed_w, missed_g)
    assert len(segs_w) == len(segs_g) > 0
    for a, b in zip(segs_w, segs_g):
        assert dataclasses.asdict(a.patch) == dataclasses.asdict(b.patch)
        for f in ("depth0", "depth1", "occupancy", "point_indices"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


_PARAMS = {
    "point_knn": dict(),
    "grid_refine": dict(grid_based_refine_segmentation=True),
    "grid_segmentation": dict(grid_based_segmentation=True),
}


@pytest.mark.parametrize("name", list(_PARAMS))
def test_segmentation_equal_given_the_same_normals(monkeypatch, name):
    points = ref_testdata.make_frame(0, n=8000).positions.astype(np.int32)
    kw = _PARAMS[name]
    ref_params = ref_segment.SegmenterParams(**kw)
    params = segment.SegmenterParams(**kw)

    # the PPI and the refined PPI, from the reference's normals
    k = max(params.nn_normal_estimation,
            params.max_nn_count_refine_segmentation)
    nbr = knn_indices(points, k)
    normals = ref_segment._segmentation_normals(points, ref_params, nbr)
    ppi = ref_segment.initial_segmentation(normals)
    assert np.array_equal(ppi, segment.initial_segmentation(
        normals, device="cpu"))
    if name == "grid_refine":
        want = ref_segment.refine_segmentation_grid_based(
            points, normals, ppi, ref_params)
        got = segment.refine_segmentation_grid_based(
            points, normals, ppi, params, "cpu")
    else:
        want = ref_segment.refine_segmentation(normals, ppi, nbr, ref_params)
        got = segment.refine_segmentation(normals, ppi, nbr, params, "cpu")
    assert np.array_equal(want, got)

    # the whole frame: the port is given the reference's normals call by
    # call (the voxel cloud's under grid segmentation)
    fed = []
    ref_normals = ref_segment._segmentation_normals

    def record(pts, p, nbr_idx):
        n = ref_normals(pts, p, nbr_idx)
        fed.append((pts.copy(), n))
        return n

    def feed(pts, p, nbr_idx, device):
        want_pts, n = fed.pop(0)
        assert np.array_equal(want_pts, pts)
        return n

    monkeypatch.setattr(ref_segment, "_segmentation_normals", record)
    monkeypatch.setattr(segment, "_segmentation_normals", feed)
    _assert_patches_equal(ref_segment.segment_frame(points, ref_params),
                          segment.segment_frame(points, params, device="cpu"))
    assert not fed


@pytest.mark.parametrize("maker,n", [("make_frame", 40000),
                                     ("make_scene_frame", 16000)])
def test_ppi_share_with_own_normals(maker, n):
    """Each package computes its own normals: the share of points whose
    initial and refined PPI differ, printed with -s (both decompose with
    scipy's LAPACK ``ssyevd``; the angle printed is arccos of a float32 dot,
    not 0 for equal unit normals)."""
    points = getattr(ref_testdata, maker)(0, n=n).positions.astype(np.int32)
    params = segment.SegmenterParams()
    k = max(params.nn_normal_estimation,
            params.max_nn_count_refine_segmentation)
    nbr = knn_indices(points, k)
    ref_n = ref_segment._segmentation_normals(
        points, ref_segment.SegmenterParams(), nbr)
    own_n = segment._segmentation_normals(points, params, nbr,
                                          torch.device("cpu"))
    ppi_ref = ref_segment.initial_segmentation(ref_n)
    ppi_own = segment.initial_segmentation(own_n, device="cpu")
    refined_ref = ref_segment.refine_segmentation(
        ref_n, ppi_ref, nbr, ref_segment.SegmenterParams())
    refined_own = segment.refine_segmentation(own_n, ppi_own, nbr, params,
                                              "cpu")
    share = float((ppi_ref != ppi_own).mean())
    share_refined = float((refined_ref != refined_own).mean())
    angle = np.arccos(np.clip(np.abs((ref_n * own_n).sum(1)), 0.0, 1.0))
    print(f"\n{maker}: {len(points)} points, PPI differs at "
          f"{(ppi_ref != ppi_own).sum()} ({share:.3e}), refined PPI at "
          f"{(refined_ref != refined_own).sum()} ({share_refined:.3e}); "
          f"largest normal angle {angle.max():.3e} rad")
    assert share < 0.01 and share_refined < 0.01
