"""The port's block-to-patch ownership and patch->3D reprojection against the
JAX package's on the CPU: equal integers on random patch tables and planes
(made from a numpy seed), for both precedences, contested blocks, all 8
orientations, the 3 normal axes x 2 projection modes, LOD 2 and the three
45-degree rotation axes; and the cases of the reference's own reprojection
tests through the port's ``ReconstructionEngine``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.ops import reproject as ref
from rabbit_transcoding_tpu_torch.codec.reconstruct import (
    GeneratePointCloudParameters,
    ReconstructionEngine,
)
from rabbit_transcoding_tpu_torch.core.image import Video
from rabbit_transcoding_tpu_torch.core.patch import Patch
from rabbit_transcoding_tpu_torch.ops import reproject as port
from rabbit_transcoding_tpu_torch.utils.enums import (
    ColorFormat,
    PatchOrientation,
)

_AXES = list(itertools.permutations(range(3)))


def _random_table(seed: int, f: int, max_p: int, h: int, w: int, block: int,
                  fixed: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A random patch table (F, maxP, 18) int32 and counts (F,): boxes that
    overlap each other, every orientation, axis permutation, projection
    mode, LOD and rotation axis, unless ``fixed`` pins a field."""
    rng = np.random.default_rng(seed)
    table = np.zeros((f, max_p, ref.PATCH_TABLE_FIELDS), np.int32)
    counts = rng.integers(max_p // 2, max_p + 1, f).astype(np.int32)
    counts[0] = max_p
    for fi in range(f):
        for pi in range(max_p):
            cw = int(rng.integers(1, 5)) * block - int(rng.integers(0, 3))
            ch = int(rng.integers(1, 5)) * block - int(rng.integers(0, 3))
            cx0 = int(rng.integers(0, (w - cw) // block + 1)) * block
            cy0 = int(rng.integers(0, (h - ch) // block + 1)) * block
            orient = int(rng.integers(0, 8))
            swap = orient in (1, 2, 4, 6)
            n, t, b = _AXES[int(rng.integers(0, 6))]
            row = {
                ref.F_CX0: cx0, ref.F_CY0: cy0, ref.F_CW: cw, ref.F_CH: ch,
                ref.F_W: ch if swap else cw, ref.F_H: cw if swap else ch,
                ref.F_U1: int(rng.integers(0, 900)),
                ref.F_V1: int(rng.integers(0, 900)),
                ref.F_D1: int(rng.integers(0, 1024)),
                ref.F_NORMAL: n, ref.F_TANGENT: t, ref.F_BITANGENT: b,
                ref.F_PROJ_MODE: int(rng.integers(0, 2)),
                ref.F_ORIENT: orient,
                ref.F_LODX: int(rng.integers(1, 3)),
                ref.F_LODY: int(rng.integers(1, 3)),
                ref.F_ROT: int(rng.integers(0, 4)),
                ref.F_ROT_OFFSET: 1024,
            }
            row.update(fixed or {})
            for k, v in row.items():
                table[fi, pi, k] = v
    return table, counts


def _planes(seed: int, f: int, h: int, w: int, block: int):
    rng = np.random.default_rng(seed + 1000)
    # occupancy: random blocks on, a few pixels off inside them
    blocks = rng.random((f, h // block, w // block)) < 0.7
    occ = np.repeat(np.repeat(blocks, block, 1), block, 2)
    occ = (occ & (rng.random((f, h, w)) < 0.9)).astype(np.uint8)
    geo = rng.integers(0, 1024, (f, h, w)).astype(np.int32)
    return occ, geo


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed,f,max_p,h,w,block", [
    (0, 3, 32, 128, 160, 16), (1, 2, 64, 256, 256, 16), (2, 4, 7, 64, 96, 8),
])
def test_block_to_patch_equal(seed, f, max_p, h, w, block, reverse):
    table, counts = _random_table(seed, f, max_p, h, w, block)
    occ, _ = _planes(seed, f, h, w, block)
    want = np.asarray(ref.block_to_patch(
        jnp.asarray(occ), jnp.asarray(table), jnp.asarray(counts), block,
        reverse=reverse))
    got = port.block_to_patch(_t(occ), _t(table), _t(counts), block,
                              reverse=reverse)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the boxes overlap: some blocks are contested, and the two
    # precedences disagree on them
    other = port.block_to_patch(_t(occ), _t(table), _t(counts), block,
                                reverse=not reverse).numpy()
    assert (other != want).any()
    # patches beyond a frame's count never own a block
    assert all(got[fi].max() <= counts[fi] for fi in range(f))


def _compare_reproject(table, counts, occ, geo, block, reverse):
    want = ref.reproject(jnp.asarray(geo), jnp.asarray(occ),
                         jnp.asarray(table), jnp.asarray(counts), block,
                         reverse=reverse)
    got = port.reproject(_t(geo), _t(occ), _t(table), _t(counts), block,
                         reverse=reverse)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    return got


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed,f,max_p,h,w,block", [
    (3, 2, 32, 128, 160, 16), (4, 3, 96, 256, 256, 16), (5, 2, 5, 64, 64, 8),
])
def test_reproject_equal_on_random_tables(seed, f, max_p, h, w, block,
                                          reverse):
    table, counts = _random_table(seed, f, max_p, h, w, block)
    occ, geo = _planes(seed, f, h, w, block)
    pts, valid, _ = _compare_reproject(table, counts, occ, geo, block,
                                       reverse)
    assert valid.any() and not valid.all()
    # the rotated patches reach negative sums: the shift is arithmetic
    assert (pts[valid] < 0).any()


@pytest.mark.parametrize("orient", range(8))
def test_reproject_each_orientation(orient):
    table, counts = _random_table(10 + orient, 1, 32, 128, 128, 16,
                                  {ref.F_ORIENT: orient, ref.F_ROT: 0})
    # the patch-space size follows the pinned orientation
    swap = orient in (1, 2, 4, 6)
    cw, ch = table[..., ref.F_CW].copy(), table[..., ref.F_CH].copy()
    table[..., ref.F_W] = ch if swap else cw
    table[..., ref.F_H] = cw if swap else ch
    occ, geo = _planes(orient, 1, 128, 128, 16)
    _compare_reproject(table, counts, occ, geo, 16, False)


@pytest.mark.parametrize("normal,mode", list(itertools.product(range(3),
                                                               range(2))))
def test_reproject_each_axis_and_projection_mode(normal, mode):
    t, b = [a for a in range(3) if a != normal]
    table, counts = _random_table(
        20 + 2 * normal + mode, 1, 32, 128, 128, 16,
        {ref.F_NORMAL: normal, ref.F_TANGENT: t, ref.F_BITANGENT: b,
         ref.F_PROJ_MODE: mode, ref.F_ROT: 0})
    occ, geo = _planes(normal, 1, 128, 128, 16)
    _compare_reproject(table, counts, occ, geo, 16, False)


@pytest.mark.parametrize("rot", [1, 2, 3])
def test_reproject_each_45_degree_axis_with_lod_2(rot):
    table, counts = _random_table(
        30 + rot, 2, 32, 128, 128, 16,
        {ref.F_ROT: rot, ref.F_LODX: 2, ref.F_LODY: 2})
    occ, geo = _planes(rot, 2, 128, 128, 16)
    _compare_reproject(table, counts, occ, geo, 16, True)


def test_patch_table_equal():
    from rabbit_transcoding_tpu.core.patch import Patch as RefPatch

    kw = [dict(index=i, u0=i, v0=2 * i, size_u0=3, size_v0=2, size_u=40,
               size_v=30, u1=7 * i, v1=5, d1=100 + i, normal_axis=i % 3,
               tangent_axis=(i + 1) % 3, bitangent_axis=(i + 2) % 3,
               projection_mode=i % 2, lod_x=1 + i % 2, rotation_axis=i % 4,
               rot_offset=512) for i in range(5)]
    lists = [[Patch(orientation=PatchOrientation(i), **k)
              for i, k in enumerate(kw)], []]
    from rabbit_transcoding_tpu.utils.enums import (
        PatchOrientation as RefOrientation,
    )
    ref_lists = [[RefPatch(orientation=RefOrientation(i), **k)
                  for i, k in enumerate(kw)], []]
    got = port.build_patch_table(lists, 32)
    want = ref.build_patch_table(ref_lists, 32)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)


# --- the reference's reprojection cases through the port's engine -----------
def _synthesize_atlas(patches, width=256, height=256):
    """Depth plane, occupancy and the true points of ``patches``: every
    patch pixel carries a depth and becomes one point."""
    geo = np.zeros((height, width), np.uint16)
    occ = np.zeros((height, width), np.uint8)
    all_pts = []
    rng = np.random.default_rng(0)
    for p in patches:
        v, u = np.mgrid[0:p.size_v_pix, 0:p.size_u_pix]
        depth = rng.integers(0, 60, u.shape).astype(np.int32)
        x, y = p.patch_to_canvas(u, v)
        geo[y, x] = depth
        occ[y, x] = 1
        all_pts.append(p.generate_point(u, v, depth).reshape(-1, 3))
    return geo, occ, np.concatenate(all_pts, axis=0)


def _as_set(pts):
    return set(map(tuple, pts.tolist()))


def _engine(**kw):
    return ReconstructionEngine(GeneratePointCloudParameters(**kw),
                                device="cpu")


@pytest.mark.parametrize("orientation", list(PatchOrientation))
def test_single_patch_exact(orientation):
    p = Patch(
        index=0, u0=2, v0=2, size_u0=3, size_v0=4, size_u=48, size_v=64,
        u1=100, v1=50, d1=200, normal_axis=2, tangent_axis=0,
        bitangent_axis=1, projection_mode=0, orientation=orientation,
    )
    geo, occ, truth = _synthesize_atlas([p])
    geo_v = Video(256, 256, 10, ColorFormat.YUV400, [geo[None]])
    clouds = _engine(remove_duplicate_points=False).generate_point_clouds(
        [[p]], occ[None], geo_v, None)
    assert _as_set(clouds[0].positions) == _as_set(truth)


def test_multi_patch_multi_axis():
    patches = [
        Patch(index=0, u0=0, v0=0, size_u0=2, size_v0=2, size_u=32,
              size_v=32, u1=0, v1=0, d1=10, normal_axis=0, tangent_axis=2,
              bitangent_axis=1, projection_mode=0),
        Patch(index=1, u0=4, v0=0, size_u0=2, size_v0=2, size_u=32,
              size_v=32, u1=64, v1=0, d1=300, normal_axis=1,
              tangent_axis=2, bitangent_axis=0, projection_mode=1,
              orientation=PatchOrientation.ROT90),
        Patch(index=2, u0=0, v0=4, size_u0=3, size_v0=2, size_u=48,
              size_v=32, u1=10, v1=20, d1=30, normal_axis=2,
              tangent_axis=0, bitangent_axis=1, projection_mode=0,
              orientation=PatchOrientation.SWAP),
    ]
    geo, occ, truth = _synthesize_atlas(patches)
    geo_v = Video(256, 256, 10, ColorFormat.YUV400, [geo[None]])
    clouds = _engine(remove_duplicate_points=False).generate_point_clouds(
        [patches], occ[None], geo_v, None)
    assert _as_set(clouds[0].positions) == _as_set(truth)


@pytest.mark.parametrize("precedence,owner", [(True, 1), (False, 2)])
def test_block_to_patch_precedence(precedence, owner):
    p0 = Patch(index=0, u0=0, v0=0, size_u0=2, size_v0=2, size_u=32,
               size_v=32)
    p1 = Patch(index=1, u0=1, v0=0, size_u0=2, size_v0=2, size_u=32,
               size_v=32)
    occ = np.zeros((1, 64, 64), np.uint8)
    occ[0, :32, :48] = 1
    b2p = _engine(patch_precedence=precedence).block_to_patch_maps(
        [[p0, p1]], occ, block_size=16)
    assert b2p[0, 0, 0] == 1      # patch 0 owns
    assert b2p[0, 0, 1] == owner  # contested
    assert b2p[0, 0, 2] == 2      # patch 1 only
    assert b2p[0, 2, 0] == 0      # unoccupied


def test_colors_gathered():
    p = Patch(index=0, u0=0, v0=0, size_u0=2, size_v0=2, size_u=32,
              size_v=32, d1=5)
    geo, occ, _ = _synthesize_atlas([p], width=64, height=64)
    geo_v = Video(64, 64, 10, ColorFormat.YUV400, [geo[None]])
    # constant mid-gray attribute -> every point mid-gray
    attr = Video.zeros(1, 64, 64, 8, ColorFormat.YUV420)
    attr.planes[0][...] = 120
    attr.planes[1][...] = 128
    attr.planes[2][...] = 128
    clouds = _engine().generate_point_clouds([[p]], occ[None], geo_v, attr)
    assert clouds[0].has_colors
    assert np.abs(clouds[0].colors.astype(int) - 120).max() <= 2
