"""The port's eigen-decomposition and what follows from it, against the JAX
package on the CPU, bit for bit.

The reference's CPU ``jnp.linalg.eigh`` symmetrises its input and calls
LAPACK ``ssyevd`` (jobz 'V', uplo 'L') through jaxlib, which takes the
routine from ``scipy.linalg.cython_lapack``.  The port's ``normals._eigh``
calls the same routine with the same arguments (``native/eigh3.cpp``, or a
loop over ``scipy.linalg.lapack.ssyevd`` without the native library), so on
one host values and vectors are equal, and so are the normals, the
segmentation's PPI, the encoder's bytes with its own normals and D2 with
computed normals (ROADMAP queue 3 items g.9 and g.10).  The smoothing of
``generate_normals`` adds the neighbours in index order and blends with one
fused multiply-add, as XLA's CPU code does.  The one float step left is
XLA's CPU ``sqrt`` (item g.8), which ``generate_normals``' normalisations
take: the share of its normals that are not bit-equal is printed with
``-s`` and held under ``test_torch_normals.py``'s ceilings."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rabbit_transcoding_tpu.encoder import normals as ref
from rabbit_transcoding_tpu.encoder import segment as ref_segment
from rabbit_transcoding_tpu_torch import native, testdata
from rabbit_transcoding_tpu_torch.encoder import normals as port
from rabbit_transcoding_tpu_torch.encoder import segment
from rabbit_transcoding_tpu_torch.metrics.metrics import (
    compute_sequence_metrics,
)

from test_torch_decoder import decode_port
from test_torch_encoder import KNOB_BASE, encode_both, knob_clouds
from test_torch_encoder import one_torch_thread  # noqa: F401 (autouse)
from test_torch_normals import _GEN_CASES, _voxel_sphere, assert_under_ceilings

_jax_eigh = jax.jit(jnp.linalg.eigh)


def jax_eigh(cov: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    w, v = _jax_eigh(jnp.asarray(cov))
    return np.asarray(w), np.asarray(v)


def port_eigh(cov: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    w, v = port._eigh(torch.from_numpy(cov))
    return w.numpy(), v.numpy()


def assert_bits_equal(a: np.ndarray, b: np.ndarray) -> None:
    """Equal bit for bit (NaN equals NaN, -0 differs from +0)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _random_covariances(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.integers(-20, 20, (n, 16, 3)).astype(np.float32)
    c = pts - pts.mean(axis=1, keepdims=True)
    return np.einsum("nki,nkj->nij", c, c).astype(np.float32)


def _repeated() -> np.ndarray:
    """Repeated eigenvalues: multiples of the identity (zero included), two
    equal eigenvalues on the diagonal and in an integer matrix whose
    eigenvalues are 1, 3, 3."""
    eye = np.eye(3, dtype=np.float32)
    mats = [eye * s for s in (0.0, 1.0, 2.5, 37.0, 1e-6, 4096.0)]
    mats += [np.diag(d).astype(np.float32)
             for d in ([2, 2, 5], [5, 2, 2], [2, 5, 2], [0, 0, 1], [3, 1, 1])]
    mats.append(np.float32([[2, 1, 0], [1, 2, 0], [0, 0, 3]]))
    mats.append(np.float32([[3, 0, 0], [0, 2, 1], [0, 1, 2]]))
    return np.stack(mats)


_SEEDED = {
    "random_integer_points": lambda: _random_covariances(4000, 0),
    "random_float": lambda: np.einsum(
        "nij,nkj->nik", *(2 * [np.random.default_rng(1).standard_normal(
            (2000, 3, 3)).astype(np.float32)])).astype(np.float32),
    "repeated_eigenvalues": _repeated,
    "zero_matrix": lambda: np.zeros((4, 3, 3), np.float32),
}


@pytest.mark.parametrize("case", list(_SEEDED))
def test_eigh_equals_jax_bit_for_bit(case):
    cov = _SEEDED[case]()
    w, v = port_eigh(cov)
    want_w, want_v = jax_eigh(cov)
    assert_bits_equal(w, want_w)
    assert_bits_equal(v, want_v)
    assert np.isfinite(w).all() and (np.diff(w, axis=1) >= 0).all()


def _captured_covariances(monkeypatch, run) -> list[np.ndarray]:
    """The matrices the port's ``_eigh`` is given while ``run()`` runs."""
    seen = []
    inner = port._eigh

    def spy(cov):
        seen.append(cov.numpy().copy())
        return inner(cov)
    monkeypatch.setattr(port, "_eigh", spy)
    run()
    monkeypatch.setattr(port, "_eigh", inner)
    return seen


@pytest.mark.parametrize("maker,n", [("make_frame", 20000),
                                     ("make_scene_frame", 20000)])
def test_eigh_equals_jax_on_the_real_covariances(monkeypatch, maker, n):
    """The covariances of ``_pca_normals`` and ``_pca_normals_full`` on a
    real cloud: symmetric as built (so the symmetrisation changes no bit),
    and decomposed to JAX's bits."""
    pts = getattr(testdata, maker)(0, n=n).positions.astype(np.float32)
    idx = port.knn_indices(pts, 16)
    gidx, dist = port.knn_graph(pts, 12)
    ok = dist <= 4.0
    ok[:, 0] = True
    t = torch.from_numpy
    covs = _captured_covariances(monkeypatch, lambda: (
        port._pca_normals(t(pts), t(idx).long()),
        port._pca_normals_full(t(pts), t(gidx).long(), t(ok),
                               torch.zeros(3))))
    assert len(covs) == 2
    for cov in covs:
        assert_bits_equal(cov, cov.transpose(0, 2, 1).copy())
        assert_bits_equal((cov + cov.transpose(0, 2, 1)) / np.float32(2),
                          cov)
        w, v = port_eigh(cov)
        want_w, want_v = jax_eigh(cov)
        assert_bits_equal(w, want_w)
        assert_bits_equal(v, want_v)


def test_failed_decomposition_gives_nan_as_jax_does():
    """A NaN matrix makes ``ssyevd`` report info != 0; jaxlib then returns
    NaN values and vectors, and so do the native loop and the scipy loop."""
    from scipy.linalg import lapack

    bad = np.full((3, 3), np.nan, np.float32)
    assert lapack.ssyevd(bad, compute_v=1, lower=1)[2] != 0
    cov = np.stack([bad, np.eye(3, dtype=np.float32)])
    want_w, want_v = jax_eigh(cov)
    assert np.isnan(want_w[0]).all() and np.isnan(want_v[0]).all()
    for w, v in (native.ssyevd3_batch(cov), port._ssyevd_loop(cov),
                 port_eigh(cov)):
        assert np.isnan(w[0]).all() and np.isnan(v[0]).all()
        assert_bits_equal(w[1], want_w[1])
        assert_bits_equal(v[1], want_v[1])


@pytest.mark.parametrize("case", ["random_integer_points",
                                  "repeated_eigenvalues", "zero_matrix"])
def test_native_loop_equals_the_scipy_loop(monkeypatch, case):
    """Without the native library ``_eigh`` loops over scipy's ``ssyevd``:
    the same bits.  Neither path calls ``torch.linalg.eigh``."""
    def forbidden(*a, **k):
        raise AssertionError("torch.linalg.eigh called")
    monkeypatch.setattr(torch.linalg, "eigh", forbidden)
    cov = _SEEDED[case]()
    w, v = native.ssyevd3_batch(cov)
    sw, sv = port._ssyevd_loop(cov)
    assert_bits_equal(w, sw)
    assert_bits_equal(v, sv)
    pw, pv = port_eigh(cov)

    def gone(*a, **k):
        raise RuntimeError("native library unavailable")
    monkeypatch.setattr(native, "ssyevd3_batch", gone)
    fw, fv = port_eigh(cov)
    for a, b in ((pw, w), (pv, v), (fw, w), (fv, v)):
        assert_bits_equal(a, b)


def test_native_library_has_the_ssyevd_entry():
    assert native.available()
    assert native.ssyevd_pointer() == native.ssyevd_pointer() != 0
    with pytest.raises(ValueError):
        native.ssyevd3_batch(np.zeros((2, 2, 2), np.float32))


@pytest.mark.parametrize("maker,n", [("make_frame", 20000),
                                     ("make_scene_frame", 20000),
                                     ("make_dense_frame", 40000)])
def test_compute_normals_equal_bit_for_bit(maker, n):
    pts = getattr(testdata, maker)(0, n=n).positions.astype(np.float32)
    want, want_idx = ref.compute_normals(pts)
    got, got_idx = port.compute_normals(pts, device="cpu")
    np.testing.assert_array_equal(got_idx, want_idx)
    assert_bits_equal(got, want)


class _Recorder:
    """Stands in for a function and records its arguments."""

    def __init__(self, fn, concrete_only: bool = False):
        self.fn, self.calls = fn, []
        self.concrete_only = concrete_only

    def __call__(self, *args, **kw):
        if not (self.concrete_only and isinstance(args[0], jax.core.Tracer)):
            self.calls.append(args)
        return self.fn(*args, **kw)


class _Linalg:
    def __init__(self, norm):
        self.norm = norm

    def __getattr__(self, name):
        return getattr(jnp.linalg, name)


class _Jnp:
    """``jnp`` for the reference's normals module, whose ``linalg.norm``
    records the concrete arrays it is given: ``generate_normals``'
    final normalisation is the last such call."""

    def __init__(self):
        self.norm = _Recorder(jnp.linalg.norm, concrete_only=True)
        self.linalg = _Linalg(self.norm)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("case", list(_GEN_CASES))
def test_generate_normals_stages_equal_bit_for_bit(monkeypatch, case):
    """Every orientation strategy: the estimation's normals, eigenvalues,
    barycentres and counts, and the vectors that enter the final
    normalisation (after the smoothing and the orientation), equal bit for
    bit.  The final normalisation takes XLA's ``sqrt`` (item g.8): the
    share of normals that are not bit-equal is printed and held under the
    recorded ceilings."""
    kw = _GEN_CASES[case]
    pts = np.unique(_voxel_sphere(np.array([64.0, 64.0, 64.0]), 40, 3000,
                                  21), axis=0)
    ref_pca = _Recorder(ref._pca_normals_full)
    port_pca = _Recorder(port._pca_normals_full)
    ref_jnp = _Jnp()
    port_unit = _Recorder(port._unit)
    monkeypatch.setattr(ref, "_pca_normals_full", ref_pca)
    monkeypatch.setattr(ref, "jnp", ref_jnp)
    monkeypatch.setattr(port, "_pca_normals_full", port_pca)
    monkeypatch.setattr(port, "_unit", port_unit)
    want = ref.generate_normals(pts, ref.NormalsGenParams(**kw))
    got = port.generate_normals(pts, port.NormalsGenParams(**kw),
                                device="cpu")
    monkeypatch.undo()
    [ref_args], [port_args] = ref_pca.calls, port_pca.calls
    for a, b in zip(port._pca_normals_full(*port_args),
                    ref._pca_normals_full(*ref_args)):
        assert_bits_equal(a.numpy(), np.asarray(b))
    assert_bits_equal(port_unit.calls[-1][0].numpy(),
                      np.asarray(ref_jnp.norm.calls[-1][0]))
    differ = ~(got["normals"] == want["normals"]).all(axis=1)
    print(f"generate_normals {case}: {len(pts)} normals, {differ.sum()} "
          f"not bit-equal ({differ.mean():.3e})")
    assert_under_ceilings(testdata.normals_mismatch(got["normals"],
                                                    want["normals"]))
    for key in ("eigenvalues", "centroids", "nn_counts"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("maker,n", [("make_frame", 40000),
                                     ("make_scene_frame", 16000)])
def test_ppi_equal_with_own_normals(maker, n):
    """Each package computes its own normals: the normals, the initial PPI
    and the refined PPI are equal."""
    points = getattr(testdata, maker)(0, n=n).positions.astype(np.int32)
    params = segment.SegmenterParams()
    k = max(params.nn_normal_estimation,
            params.max_nn_count_refine_segmentation)
    nbr = port.knn_indices(points, k)
    ref_params = ref_segment.SegmenterParams()
    ref_n = ref_segment._segmentation_normals(points, ref_params, nbr)
    own_n = segment._segmentation_normals(points, params, nbr,
                                          torch.device("cpu"))
    assert_bits_equal(own_n, ref_n)
    ppi_ref = ref_segment.initial_segmentation(ref_n)
    ppi_own = segment.initial_segmentation(own_n, device="cpu")
    np.testing.assert_array_equal(ppi_own, ppi_ref)
    np.testing.assert_array_equal(
        segment.refine_segmentation(own_n, ppi_own, nbr, params, "cpu"),
        ref_segment.refine_segmentation(ref_n, ppi_ref, nbr, ref_params))


def _scene_clouds():
    """Two frames of the multi-object scene, ~3,700 points each."""
    return [testdata.make_scene_frame(f, n=4000) for f in range(2)]


@pytest.mark.parametrize("clouds", [knob_clouds, _scene_clouds])
def test_encoder_with_its_own_normals_writes_the_jax_bytes(clouds):
    """No ``same_normals`` seam: the port's encoder computes its own
    normals and writes the JAX encoder's bytes and closed-loop checksums,
    at the knob files' default parameters."""
    (want, want_sums), (got, got_sums) = encode_both(
        KNOB_BASE, clouds(), own_normals=True)
    assert got == want and got_sums == want_sums


D2_FIELDS = ("d2_mse", "d2_psnr", "d2_hausdorff", "d2_hausdorff_psnr")


@pytest.mark.parametrize("name", testdata.ENCODER_STREAMS)
def test_d2_with_computed_normals_equals_the_reference(name):
    """The port's decode of each committed encoder stream, measured against
    its source with normals the port computes: every D2 field equals the
    JAX package's committed value exactly, per frame and in the summary."""
    data, sources, record = testdata.load_encoder_stream(name)
    per_frame, summary = compute_sequence_metrics(
        sources, decode_port(data), device="cpu")
    for got, want in zip([*per_frame, summary],
                         [*record["metrics_per_frame"],
                          record["metrics_summary"]]):
        for f in D2_FIELDS:
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_committed_normals_fixture_is_the_jax_packages(monkeypatch):
    """``tests/fixtures_torch/normals_ref.npz`` (``chip_smoke.py`` holds the
    card's normals against it) is what the JAX package computes now, and
    the port computes the same bits."""
    import os

    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), "..",
                                             "tools"))
    import make_torch_fixtures as tool

    with np.load(os.path.join(testdata.ENCODER_STREAM_DIR,
                              tool.NORMALS_REF + ".npz")) as z:
        want_n, want_vals = z["normals"], z["eigenvalues"]
    _, sources, _ = testdata.load_encoder_stream(tool.NORMALS_SOURCE)
    pts = sources[0].positions.astype(np.float32)
    ref_n, _ = ref.compute_normals(pts)
    assert_bits_equal(np.asarray(ref_n, np.float32), want_n)
    got_n, _ = port.compute_normals(pts, device="cpu")
    assert_bits_equal(got_n, want_n)
    idx, _ = port.knn_graph(pts, 16)
    _, vals, _, _ = port._pca_normals_full(
        torch.from_numpy(pts), torch.from_numpy(idx).long(),
        torch.ones(idx.shape, dtype=torch.bool), torch.zeros(3))
    assert_bits_equal(vals.numpy(), want_vals)
