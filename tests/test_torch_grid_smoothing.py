"""The decoder's grid geometry smoothing (``codec/postprocess.py``'s batched
pass: the filter, the kept rows, the first of each position and the
attribute gather) against the decode cell's plain reference
(``benchmark/reference/decode.py``: ``smooth_geometry`` then
``_first_of_each``, one cloud at a time), on the CPU: the same arrays in
the same order for every cloud."""

import numpy as np
import pytest
import torch

from benchmark.reference import decode as ref_decode
from rabbit_transcoding_tpu_torch.bitstream.sei import SeiGeometrySmoothing
from rabbit_transcoding_tpu_torch.codec import postprocess as pp
from rabbit_transcoding_tpu_torch.core.pointset import PointSet
from rabbit_transcoding_tpu_torch.ops import smoothing as sm

GRID, THRESHOLD, BITS = 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(seed: int, n: int = 3000, types=(0, 1), colors=True,
           partition=True, reflectances=False,
           outliers: int = 40) -> PointSet:
    """A noisy height field inside the 8-bit grid, in shuffled order, with
    isolated outliers that the density test drops."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(20, 200, (n, 2))
    z = 100 + 30 * np.sin(xy[:, 0] / 23.0) + rng.normal(scale=2.5, size=n)
    pos = np.concatenate([
        np.column_stack([xy, z]),
        rng.integers(0, 256, (outliers, 3))]).astype(np.int32)
    m = len(pos)
    return PointSet(
        positions=pos,
        colors=rng.integers(0, 256, (m, 3)) if colors else None,
        reflectances=rng.integers(0, 1 << 16, m) if reflectances else None,
        types=None if types is None else rng.choice(types, m),
        partition=rng.integers(0, 30, m) if partition else None)


def _sparse(seed: int, n: int = 12) -> PointSet:
    """Boundary points far apart from each other (and from ``_cloud``'s
    surface): every one dropped."""
    rng = np.random.default_rng(seed)
    pos = np.column_stack([np.arange(n) * 17, np.arange(n) * 17,
                           np.full(n, 240)]) + rng.integers(0, 3, (n, 3))
    return PointSet(positions=pos.astype(np.int32),
                    colors=rng.integers(0, 256, (n, 3)),
                    types=np.ones(n, np.uint8),
                    partition=np.zeros(n, np.int32))


def _far(seed: int) -> PointSet:
    """``_cloud`` with a few points at x >= 2^15, outside the packed key of
    ``first_occurrences`` (their cells clamp to the grid's face)."""
    ps, rng = _cloud(seed), np.random.default_rng(seed)
    far = np.column_stack([40_000 + rng.integers(0, 3, 40),
                           rng.integers(90, 110, (40, 2))])
    return PointSet(
        positions=np.concatenate([ps.positions, far]).astype(np.int32),
        colors=np.concatenate([ps.colors, rng.integers(0, 256, (40, 3))]),
        types=np.concatenate([ps.types, np.ones(40, np.uint8)]),
        partition=np.concatenate([ps.partition, np.zeros(40, np.int32)]))


def _empty() -> PointSet:
    return PointSet(positions=np.zeros((0, 3), np.int32),
                    colors=np.zeros((0, 3), np.uint8),
                    types=np.zeros(0, np.uint8),
                    partition=np.zeros(0, np.int32))


def _dense_types_0_beside(sparse: PointSet) -> PointSet:
    """``sparse`` beside a dense patch of raw/EOM points (types 0 and 2),
    which the filter neither moves nor drops."""
    dense = _cloud(5, n=2000, types=(0, 2), outliers=0)
    return PointSet(
        positions=np.concatenate([sparse.positions, dense.positions]),
        colors=np.concatenate([sparse.colors, dense.colors]),
        types=np.concatenate([sparse.types, dense.types]),
        partition=np.concatenate([sparse.partition, dense.partition]))


CASES = {
    "types": lambda: [_cloud(s) for s in range(3)],
    "types_none": lambda: [_cloud(s, types=None, partition=False)
                           for s in range(3)],
    "raw_eom_beside_boundary": lambda: [_cloud(s, types=(0, 1, 1, 2),
                                               reflectances=True)
                                        for s in range(2)],
    "empty_in_the_middle": lambda: [_cloud(1), _empty(), _cloud(2)],
    "more_than_a_batch": lambda: [_cloud(s, n=600, outliers=10)
                                  for s in range(sm._BATCH_CLOUDS + 3)],
    "moves_make_duplicates": lambda: [_cloud(7, n=6000, types=(1,))],
    "boundary_all_dropped": lambda: [_sparse(3), _cloud(4),
                                     _dense_types_0_beside(_sparse(6))],
    "outside_the_packed_key": lambda: [_far(8)],
    "attribute_transfer": lambda: [_cloud(s) for s in range(2)],
}


def _reference(ps: PointSet):
    """(surviving rows, their positions) by the plain reference."""
    boundary = (torch.ones(ps.point_count, dtype=torch.bool)
                if ps.types is None else torch.from_numpy(ps.types == 1))
    if ps.point_count == 0:
        return np.zeros(0, np.int64), np.zeros((0, 3), np.int64), 0
    pos, kept, moved = ref_decode.smooth_geometry(
        torch.from_numpy(ps.positions.astype(np.int64)), boundary, GRID,
        THRESHOLD, BITS)
    rows = torch.nonzero(kept).squeeze(1)
    first = ref_decode._first_of_each(pos[rows])
    return rows[first].numpy(), pos[rows][first].numpy(), int(moved.sum())


def _before(clouds: list[PointSet], sei) -> list[PointSet]:
    """The per-cloud composition the batched pass replaced: the filter's
    masks on the host, ``_smoothed_cloud``, then ``_remove_duplicates``."""
    out = []
    for ps in clouds:
        n = ps.point_count
        pos, keep, _ = sm.grid_smooth(
            torch.from_numpy(ps.positions.astype(np.int32)),
            torch.ones(n, dtype=torch.bool),
            float(sei.gs_smoothing_threshold), float(pp.MIN_NEIGHBORS),
            torch.ones(n, dtype=torch.bool) if ps.types is None
            else torch.from_numpy(ps.types == 1), GRID, (1 << BITS) // GRID)
        out.append(pp._remove_duplicates(pp._smoothed_cloud(
            ps, pos.numpy(), keep.numpy(), 1), "cpu"))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_grid_smoothing_equals_the_reference(case):
    clouds = CASES[case]()
    sei = SeiGeometrySmoothing(gs_smoothing_method_type=1,
                               gs_smoothing_grid_size_minus2=GRID - 2,
                               gs_smoothing_threshold=THRESHOLD)
    transfer = int(case == "attribute_transfer")
    got = pp.apply_geometry_smoothing(
        clouds, sei, BITS, attr_transfer_filter_type=transfer, device="cpu")
    assert len(got) == len(clouds)
    moved = 0
    for ps, out in zip(clouds, got):
        rows, pos, n_moved = _reference(ps)
        moved += n_moved
        np.testing.assert_array_equal(out.positions, pos)
        assert out.positions.dtype == ps.positions.dtype
        for name in ("types", "partition", "reflectances") + (
                () if transfer else ("colors",)):
            want = getattr(ps, name)
            if want is None:
                assert getattr(out, name) is None, name
            else:
                np.testing.assert_array_equal(getattr(out, name), want[rows],
                                              err_msg=name)
    assert moved > 0 or case == "boundary_all_dropped"
    if case == "moves_make_duplicates":
        want_kept = ref_decode.smooth_geometry(
            torch.from_numpy(clouds[0].positions.astype(np.int64)),
            torch.ones(clouds[0].point_count, dtype=torch.bool), GRID,
            THRESHOLD, BITS)[1]
        assert got[0].point_count < int(want_kept.sum())
    if case == "boundary_all_dropped":
        assert got[0].point_count == 0
        assert got[2].point_count > 0 and not (got[2].types == 1).any()
    if transfer:
        before = _before(clouds, sei)
        changed = 0
        for old, new, ps in zip(before, got, clouds):
            np.testing.assert_array_equal(new.positions, old.positions)
            np.testing.assert_array_equal(new.colors, old.colors)
            changed += int((new.colors != ps.colors[_reference(ps)[0]]).any())
        assert changed
