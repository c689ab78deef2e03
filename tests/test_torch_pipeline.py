"""The port's sharded reprojection and metrics reduction
(``parallel/pipeline.py``, ``d1_psnr_sharded``) against the JAX package's on
the CPU (the sharded decode: ``test_torch_mesh_decode.py``).

The port runs on virtual meshes that list the CPU device several times;
the JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``).
Only bytes and numpy arrays pass between the packages."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from rabbit_transcoding_tpu.core.patch import Patch as RefPatch
from rabbit_transcoding_tpu.core.pointset import PointSet as RefPointSet
from rabbit_transcoding_tpu.metrics.metrics import (
    MetricsParams as RefMetricsParams,
    d1_psnr_sharded as ref_d1_psnr_sharded,
)
from rabbit_transcoding_tpu.ops import reproject as ref_repro
from rabbit_transcoding_tpu.parallel.mesh import make_mesh as ref_make_mesh
from rabbit_transcoding_tpu.utils.enums import (
    PatchOrientation as RefPatchOrientation,
)
from rabbit_transcoding_tpu.parallel.pipeline import (
    make_sharded_nn_mse as ref_make_sharded_nn_mse,
    sharded_reproject as ref_sharded_reproject,
)
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder
from rabbit_transcoding_tpu_torch.metrics.metrics import (
    MetricsParams,
    compute_metrics,
    d1_psnr_sharded,
)
from rabbit_transcoding_tpu_torch.ops import reproject as repro
from rabbit_transcoding_tpu_torch.parallel import mesh as pm
from rabbit_transcoding_tpu_torch.parallel.pipeline import (
    make_sharded_nn_mse,
    sharded_reproject,
)
from rabbit_transcoding_tpu_torch.testdata import load_encoder_stream

CPU = torch.device("cpu")
SHAPES = [(1, 1), (2, 1), (2, 2), (4, 2), (7, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    tier-1 run puts six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape) -> pm.Mesh:
    return pm.make_mesh([CPU] * (shape[0] * shape[1]), stream_axis=shape[0])


# --- sharded_reproject ---------------------------------------------------------
@pytest.fixture(scope="module")
def reproject_case():
    """5 frames of one patch each (the reference's own case): the inputs
    and the JAX package's sharded result on its 8 devices."""
    rng = np.random.default_rng(1)
    f, h, w = 5, 64, 64
    patches = []
    for k in range(f):
        p = RefPatch()
        p.u0, p.v0 = k % 2, 0
        p.size_u0, p.size_v0 = 3, 4
        p.u1, p.v1, p.d1 = 10 + k, 20, 30
        p.normal_axis, p.tangent_axis, p.bitangent_axis = 0, 1, 2
        p.orientation = RefPatchOrientation(k % 8)
        p.projection_mode = k % 2
        p.occupancy_resolution = 16
        patches.append([p])
    table, counts = ref_repro.build_patch_table(patches, 4)
    occ = (rng.random((f, h, w)) < 0.5).astype(np.uint8)
    geo = rng.integers(0, 200, (f, h, w)).astype(np.int32)
    args = (geo, occ, np.asarray(table), np.asarray(counts))
    ref = ref_sharded_reproject(ref_make_mesh(), *args, 16)
    return args, [np.asarray(x) for x in ref]


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_reproject_equals_reference(reproject_case, shape):
    args, ref = reproject_case
    got = sharded_reproject(_mesh(shape), *args, 16)
    one = repro.reproject(*(torch.from_numpy(a) for a in args), 16)
    for g, o, r in zip(got, one, ref):
        assert g.device == CPU
        np.testing.assert_array_equal(g.numpy(), r)
        assert torch.equal(g, o)
    # tensors in: the results land on their device
    tensors = [torch.from_numpy(a) for a in args]
    assert all(torch.equal(a, b) for a, b in zip(
        sharded_reproject(_mesh(shape), *tensors, 16, reverse=True),
        repro.reproject(*tensors, 16, reverse=True)))


# --- the sharded nearest-neighbour reduction ------------------------------------
@pytest.fixture(scope="module")
def nn_case():
    rng = np.random.default_rng(2)
    refs = rng.integers(200, 800, (12000, 3)).astype(np.int32)
    queries = np.clip(
        refs[rng.choice(len(refs), 7000)] + rng.integers(-3, 4, (7000, 3)),
        0, 1023).astype(np.int32)
    ref = ref_make_sharded_nn_mse(ref_make_mesh(), k_cell_bits=3,
                                  grid_dim=128, cap=64)(queries, refs)
    d, _ = cKDTree(refs).query(queries, k=1)
    return queries, refs, ref, float(np.mean(d ** 2))


@pytest.mark.parametrize("shape", SHAPES)
def test_nn_mse_equals_reference_and_kdtree(nn_case, shape):
    queries, refs, ref, exact = nn_case
    got = make_sharded_nn_mse(_mesh(shape), k_cell_bits=3, grid_dim=128,
                              cap=64)(queries, refs)
    assert got == ref  # bit for bit: every partial sum is an exact integer
    assert abs(got - exact) < 1e-4 * max(1.0, exact)


def test_unfound_raises():
    a = np.zeros((512, 3), np.int32)
    b = np.full((512, 3), 900, np.int32)
    nn_mse = make_sharded_nn_mse(_mesh((2, 1)), k_cell_bits=2, grid_dim=256)
    with pytest.raises(ValueError, match="no neighbour"):
        nn_mse(a, b)


@pytest.fixture(scope="module")
def d1_case():
    """Frame 0 of an encoder stream's decode and its source cloud, with the
    JAX package's sharded D1 and the port's ``compute_metrics`` D1."""
    data, sources, _ = load_encoder_stream("scene_lossy_occupancy_pbf")
    reader = V3CReader()
    rec = Decoder(device="cpu").decode(reader.decode(reader.read(data)[0]))[0]
    src = sources[0]
    ref = ref_d1_psnr_sharded(
        RefPointSet(positions=src.positions, colors=src.colors),
        RefPointSet(positions=rec.positions, colors=rec.colors),
        ref_make_mesh(), RefMetricsParams(resolution=1023))
    plain = compute_metrics(src, rec, MetricsParams(resolution=1023),
                            device="cpu").d1_psnr
    return src, rec, ref, plain


@pytest.mark.parametrize("shape", [(1, 1), (4, 2)])
def test_d1_psnr_sharded_equals_reference(d1_case, shape):
    src, rec, ref, plain = d1_case
    got = d1_psnr_sharded(src, rec, _mesh(shape),
                          MetricsParams(resolution=1023))
    assert abs(got - ref) <= 1e-5
    # the plain nearest-neighbour D1 against the CTC-grade one
    assert abs(got - plain) < 0.2, (got, plain)
