"""The port's own copies of the reference's host layers against the
originals on the CPU: the V3C reader and writer, the hash SEI and the rANS
library give the reference's bytes; the point-cloud containers, the raw and
EOM point helpers and the conformance tracer give the reference's arrays,
checksums and files.  The entry points of the port run on the
card unless the caller asks for the CPU, and raise when there is none."""

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu import native as ref_native
from rabbit_transcoding_tpu.codec.hash import create_hash_sei as ref_hash_sei
from rabbit_transcoding_tpu.codec.patch_frame import (
    decode_patch_frames as ref_patch_frames,
)
from rabbit_transcoding_tpu.core.gof import GroupOfFrames
from rabbit_transcoding_tpu.encoder.encoder import Encoder
from rabbit_transcoding_tpu.encoder.params import EncoderParameters
from rabbit_transcoding_tpu_torch import bitstream, native
from rabbit_transcoding_tpu_torch.bitstream.bitio import BitWriter
from rabbit_transcoding_tpu_torch.bitstream.sei import write_sei_rbsp
from rabbit_transcoding_tpu_torch.codec.hash import create_hash_sei
from rabbit_transcoding_tpu_torch.codec.patch_frame import decode_patch_frames
from rabbit_transcoding_tpu_torch.parallel import multistream as ms
from rabbit_transcoding_tpu_torch.testdata import make_stream
from rabbit_transcoding_tpu_torch.transcoder import (
    MultiStreamTranscoder,
    Transcoder,
)
from rabbit_transcoding_tpu_torch.utils.enums import CodecId
from rabbit_transcoding_tpu_torch.video import VideoDecoder, VideoEncoder, rbv

from rabbit_transcoding_tpu.codec import eom as ref_eom
from rabbit_transcoding_tpu.codec import raw_points as ref_raw
from rabbit_transcoding_tpu.codec.trace import (
    emit_conformance_traces as ref_emit_traces,
)
from rabbit_transcoding_tpu.core.patch import Patch as RefPatch
from rabbit_transcoding_tpu.core.pointset import PointSet as RefPointSet
from rabbit_transcoding_tpu.utils import tracing as ref_tracing
from rabbit_transcoding_tpu_torch.codec import eom, raw_points
from rabbit_transcoding_tpu_torch.codec.trace import emit_conformance_traces
from rabbit_transcoding_tpu_torch.core import GroupOfFrames as PortGof
from rabbit_transcoding_tpu_torch.core import Patch, PointSet
from rabbit_transcoding_tpu_torch.codec.reconstruct import (
    ReconstructionEngine,
)
from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder
from rabbit_transcoding_tpu_torch.ops.smoothing import (
    smooth_cloud,
    smooth_colors,
)
from rabbit_transcoding_tpu_torch.utils import tracing

from test_e2e_codec import make_sphere_cloud
from test_torch_transcoder import _bench_make_stream


def _encoder_stream(**kw) -> bytes:
    """A stream of the reference's V-PCC encoder: patches, SEI, per-map
    sub-streams where asked."""
    params = dict(minimumImageWidth=256, minimumImageHeight=64,
                  geometryQP=12, attributeQP=20, occupancyPrecision=2,
                  flagGeometrySmoothing=False, frameCount=1,
                  groupOfFramesSize=1)
    params.update(kw)
    context, _ = Encoder(EncoderParameters(**params)).encode(
        GroupOfFrames([make_sphere_cloud(seed=7)]))
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


_STREAMS = {
    "bench": lambda: _bench_make_stream(2, 64, 64),
    "plain": lambda: make_stream(2, 64, 64),
    "mc_intra": lambda: make_stream(2, 64, 64, motion=True, intra=True),
    "map_pair": lambda: make_stream(2, 64, 64, map_pair=True),
    "lossless": lambda: make_stream(2, 64, 64, lossless=True),
    "encoder": lambda: _encoder_stream(decodedAtlasInformationHash=1),
    "encoder_pairs": lambda: _encoder_stream(
        multipleStreams=True, absoluteD1=False, absoluteT1=False),
}


def _round_trip(data: bytes, bs) -> list[bytes]:
    """Every GOF of ``data`` parsed and written back by ``bs``'s reader and
    writer."""
    reader, writer = bs.V3CReader(), bs.V3CWriter()
    return [writer.write(writer.encode(reader.decode(gof)))
            for gof in reader.read(data)]


@pytest.mark.parametrize("name", list(_STREAMS))
def test_reader_writer_bytes_identical(name):
    data = _STREAMS[name]()
    got = _round_trip(data, bitstream)
    assert got == _round_trip(data, ref_bitstream)
    assert b"".join(got) == data


def _hash_sei_bytes(sei) -> bytes:
    bw = BitWriter()
    write_sei_rbsp(bw, [sei])
    return bw.data()


@pytest.mark.parametrize("name", ["encoder", "encoder_pairs", "plain"])
def test_hash_sei_equal(name):
    data = _STREAMS[name]()
    ref_reader = ref_bitstream.V3CReader()
    ref_atlas = ref_reader.decode(ref_reader.read(data)[0]).atlas(0)
    reader = bitstream.V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    want = ref_hash_sei(ref_atlas, ref_patch_frames(ref_atlas))
    got = create_hash_sei(atlas, decode_patch_frames(atlas))
    assert (got.high_level_md5, got.atlas_md5) == (want.high_level_md5,
                                                   want.atlas_md5)
    assert _hash_sei_bytes(got) == _hash_sei_bytes(want)


def _slab(seed: int, n: int) -> np.ndarray:
    """Coefficient-like int16 data: mostly zeros, a Laplacian tail."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.laplace(scale=3.0, size=n)).astype(np.int16)
    x[rng.random(n) < 0.6] = 0
    return x


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 4096), (2, 100_003)])
def test_rans_bytes_identical(seed, n):
    assert native.available() and ref_native.available()
    x = _slab(seed, n)
    blob = native.compress_i16(x)
    assert blob == ref_native.compress_i16(x)
    np.testing.assert_array_equal(native.decompress_i16(blob, n), x)


@pytest.mark.parametrize("n_bands", [1, 3, 5])
def test_rans_bands_bytes_identical(n_bands):
    x = _slab(10 + n_bands, 64 * 257)
    bounds = np.linspace(0, len(x), 4 * n_bands + 1).astype(int)
    segments = [(int(a), int(b - a), i % n_bands)
                for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]
    blob = native.compress_i16_bands(x, segments, n_bands)
    assert blob == ref_native.compress_i16_bands(x, segments, n_bands)
    np.testing.assert_array_equal(
        native.decompress_i16_bands(blob, len(x), segments, n_bands), x)


def test_native_builds_outside_the_reference_package():
    assert native.available()
    assert "build" in native._LIB and "rabbit_transcoding_tpu" not in (
        native._LIB.split("build")[-1])
    assert native._LIB != ref_native._LIB


# --- the native KNN and the spanning-tree orientation -------------------------
def _int_cloud(seed: int, n: int, span: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, span, size=(n, 3)).astype(np.int32)


@pytest.mark.parametrize("seed,n,nq,span,k", [
    (0, 4000, 1500, 64, 1), (1, 4000, 1500, 64, 5), (2, 9000, 3000, 300, 16),
    (3, 7, 20, 8, 16)])
def test_knn_grid_equal_to_the_reference_library(seed, n, nq, span, k):
    """The same C++ source in two libraries: squared distances equal (never
    compare indices across backends; here they are equal too, ties go to
    the smaller index), and equal to an exact KD-tree's (tolerance 0)."""
    from scipy.spatial import cKDTree

    data = _int_cloud(seed, n, span)
    query = _int_cloud(seed + 100, nq, span)
    idx, d2 = native.knn_grid(query, data, k)
    ref_idx, ref_d2 = ref_native.knn_grid(query, data, k)
    np.testing.assert_array_equal(d2, ref_d2)
    np.testing.assert_array_equal(idx, ref_idx)
    kk = min(k, n)
    want, _ = cKDTree(data).query(query, k=kk)
    np.testing.assert_array_equal(
        d2[:, :kk].astype(np.float64),
        np.round(want.reshape(nq, kk) ** 2))
    assert np.isinf(d2[:, kk:]).all() and (idx[:, kk:] == -1).all()


def test_knn_grid_on_a_surface_matches_the_kdtree():
    """tests/test_knn.py::TestGridKnn's cases through the native KNN: a
    voxelised sphere, shifted queries, self first, a far outlier found."""
    from scipy.spatial import cKDTree

    pts = make_sphere_cloud(n_theta=100).positions
    queries = pts[::7] + np.array([1, 0, 0], np.int32)
    idx, d2 = native.knn_grid(queries, pts, 4)
    want, _ = cKDTree(pts).query(queries, k=4)
    np.testing.assert_array_equal(d2.astype(np.float64), np.round(want ** 2))
    idx, d2 = native.knn_grid(pts, pts, 1)
    assert (d2[:, 0] == 0).all()
    np.testing.assert_array_equal(idx[:, 0], np.arange(len(pts)))
    # exact, so a far query still finds its neighbour
    idx, d2 = native.knn_grid(np.array([[900, 900, 900]], np.int32),
                              np.zeros((10, 3), np.int32), 1)
    assert d2[0, 0] == 3 * 900.0 ** 2 and idx[0, 0] == 0
    with pytest.raises(ValueError):
        native.knn_grid(np.zeros((3, 2), np.int32), pts, 1)


@pytest.mark.parametrize("seed,gated", [(0, False), (1, True)])
def test_orient_normals_tree_equal_to_the_reference_library(seed, gated):
    """Same input arrays -> the same oriented normals and component count,
    bit for bit (two bodies far apart, random unit normals)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([_int_cloud(seed, 3000, 40),
                          _int_cloud(seed + 1, 800, 20) + 500])
    idx, d2 = native.knn_grid(pts, pts, 12)
    normals = rng.standard_normal((len(pts), 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    ok = (d2 <= 9.0 if gated else np.ones(idx.shape, bool)).astype(np.uint8)
    ok[:, 0] = 1
    vp = np.array([10.0, -20.0, 300.0], np.float32)
    got, want = normals.copy(), normals.copy()
    comps = native.orient_normals_tree(got, pts, idx, ok, vp)
    ref_comps = ref_native.orient_normals_tree(want, pts, idx, ok, vp)
    assert comps == ref_comps >= 2
    np.testing.assert_array_equal(got, want)
    assert (got != normals).any()
    with pytest.raises(ValueError):
        native.orient_normals_tree(normals.astype(np.float64), pts, idx, ok,
                                   vp)


# --- the decoder's host copies -----------------------------------------------
def _cloud_arrays(seed: int, n: int = 5000) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        positions=rng.integers(0, 40, (n, 3)).astype(np.int32),
        colors=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        reflectances=rng.integers(0, 60000, n).astype(np.uint16),
        types=rng.integers(0, 2, n).astype(np.uint8),
        partition=rng.integers(-1, 9, n).astype(np.int32),
    )


@pytest.mark.parametrize("mode", [1, 2])
def test_pointset_duplicates_and_checksum_equal(mode):
    arrays = _cloud_arrays(mode)
    got = PointSet(**arrays).remove_duplicates(mode)
    want = RefPointSet(**arrays).remove_duplicates(mode)
    assert 0 < got.point_count < len(arrays["positions"])
    for name in arrays:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.compute_checksum() == want.compute_checksum()
    assert (PointSet(**arrays).compute_checksum()
            == RefPointSet(**arrays).compute_checksum())


@pytest.mark.parametrize("binary", [True, False])
def test_ply_files_equal(tmp_path, binary):
    arrays = _cloud_arrays(3, 300)
    PointSet(**arrays).write_ply(str(tmp_path / "a.ply"), binary=binary)
    RefPointSet(**arrays).write_ply(str(tmp_path / "b.ply"), binary=binary)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    back = PointSet.read_ply(str(tmp_path / "b.ply"))
    np.testing.assert_array_equal(back.positions, arrays["positions"])
    np.testing.assert_array_equal(back.colors, arrays["colors"])


def test_group_of_frames_files_equal(tmp_path):
    clouds = [_cloud_arrays(s, 200) for s in range(3)]
    PortGof([PointSet(**c) for c in clouds]).write(
        str(tmp_path / "p_%04d.ply"), 5)
    GroupOfFrames([RefPointSet(**c) for c in clouds]).write(
        str(tmp_path / "r_%04d.ply"), 5)
    for i in range(5, 8):
        assert ((tmp_path / f"p_{i:04d}.ply").read_bytes()
                == (tmp_path / f"r_{i:04d}.ply").read_bytes())
    loaded = PortGof.load(str(tmp_path / "r_%04d.ply"), 5, 3)
    assert [ps.compute_checksum() for ps in loaded] == [
        RefPointSet(**c).compute_checksum() for c in clouds]


def test_raw_point_helpers_equal():
    rng = np.random.default_rng(4)
    pts = [rng.integers(0, 1024, (n, 3)).astype(np.int32) for n in (700, 0)]
    cols = [rng.integers(0, 256, (len(p), 3)).astype(np.uint8) for p in pts]
    extra = [rng.integers(0, 256, (40, 3)).astype(np.uint8), None]
    got = raw_points.build_raw_videos(pts, cols, 10, extra)
    want = ref_raw.build_raw_videos(pts, cols, 10, extra)
    for g, w in zip(got, want):
        assert (g.width, g.height, g.bitdepth) == (w.width, w.height,
                                                   w.bitdepth)
        for a, b in zip(g.planes, w.planes):
            np.testing.assert_array_equal(a, b)
    unit = raw_points.make_raw_patch_unit(700)
    ref_unit = ref_raw.make_raw_patch_unit(700)
    assert vars(unit) == vars(ref_unit)
    attr = np.stack([pl[0] for pl in got[1].planes], axis=-1)
    rec = raw_points.recover_raw_points([unit], got[0].planes[0][0], attr,
                                        coord_max=1000)
    ref_rec = ref_raw.recover_raw_points([ref_unit], want[0].planes[0][0],
                                         attr, coord_max=1000)
    for a, b in zip(rec, ref_rec):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rec[0], np.clip(pts[0], 0, 1000))
    np.testing.assert_array_equal(raw_points.morton_order(pts[0]),
                                  ref_raw.morton_order(pts[0]))
    np.testing.assert_array_equal(
        raw_points.prune_isolated_raw_points(pts[0] // 64),
        ref_raw.prune_isolated_raw_points(pts[0] // 64))


def test_eom_helpers_equal():
    rng = np.random.default_rng(6)
    kw = dict(index=0, u0=0, v0=0, size_u0=2, size_v0=2, size_u=32,
              size_v=32, u1=10, v1=20, d1=30, normal_axis=2, tangent_axis=0,
              bitangent_axis=1)
    eom_plane = (rng.integers(0, 8, (32, 32))
                 * (rng.random((32, 32)) < 0.2)).astype(np.uint8)
    geo = rng.integers(0, 50, (32, 32)).astype(np.int32)
    owner = np.ones((32, 32), np.int32)
    got = eom.enumerate_frame_eom_points([Patch(**kw)], eom_plane, geo, owner)
    want = ref_eom.enumerate_frame_eom_points([RefPatch(**kw)], eom_plane,
                                              geo, owner)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    assert vars(eom.make_eom_patch_unit(17)) == vars(
        ref_eom.make_eom_patch_unit(17))


def test_conformance_trace_files_equal(tmp_path):
    data = make_stream(2, 128, 128, patches=True)
    reader = bitstream.V3CReader()
    context = reader.decode(reader.read(data)[0])
    atlas = context.atlas(0)
    clouds = Decoder(device="cpu").decode(context)
    ref_reader = ref_bitstream.V3CReader()
    ref_atlas = ref_reader.decode(ref_reader.read(data)[0]).atlas(0)
    ref_clouds = [RefPointSet(positions=ps.positions, colors=ps.colors)
                  for ps in clouds]
    tr = tracing.Tracer(prefix=str(tmp_path / "p_")).enable(
        *tracing.TraceCategory)
    emit_conformance_traces(tr, atlas, decode_patch_frames(atlas), clouds,
                            gof=2, atlas_id=0)
    tr.close()
    ref_tr = ref_tracing.Tracer(prefix=str(tmp_path / "r_")).enable(
        *ref_tracing.TraceCategory)
    ref_emit_traces(ref_tr, ref_atlas, ref_patch_frames(ref_atlas),
                    ref_clouds, gof=2, atlas_id=0)
    ref_tr.close()
    names = sorted(p.name[2:] for p in tmp_path.glob("r_*.txt"))
    assert "pcframe.txt" in names and "hls.txt" in names
    for name in names:
        assert ((tmp_path / f"p_{name}").read_bytes()
                == (tmp_path / f"r_{name}").read_bytes()), name


# --- the entry points' device ------------------------------------------------
def _default_devices() -> dict:
    """The device each entry point picks when given none."""
    seen = []
    real = ms.resolve
    ms.resolve = lambda device="cuda": seen.append(real(device)) or seen[-1]
    try:
        assert ms.transcode_payloads([], 30) == []
    finally:
        ms.resolve = real
    return {
        "Transcoder": Transcoder().device,
        "MultiStreamTranscoder": MultiStreamTranscoder().device,
        "transcode_payloads": seen[0],
        "VideoEncoder": VideoEncoder.create(CodecId.RBV).device,
        "VideoDecoder": VideoDecoder.create(CodecId.RBV).device,
        "Decoder": Decoder().device,
        "ReconstructionEngine": ReconstructionEngine().device,
    }


def test_entry_points_default_to_the_card():
    # decided here, not at collection: a card present or not
    if torch.cuda.is_available():
        assert set(_default_devices().values()) == {torch.device("cuda")}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _default_devices()


@pytest.mark.parametrize("card", [False, True])
def test_entry_points_pick_cuda_or_raise(monkeypatch, card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    if card:
        assert set(_default_devices().values()) == {torch.device("cuda")}
        return
    for make in (Transcoder, MultiStreamTranscoder, Decoder,
                 ReconstructionEngine,
                 lambda: smooth_cloud(np.zeros((1, 3), np.int32)),
                 lambda: smooth_colors(np.zeros((1, 3), np.int32),
                                       np.zeros((1, 3), np.uint8)),
                 lambda: ms.transcode_payloads([], 30),
                 lambda: VideoEncoder.create(CodecId.RBV),
                 lambda: VideoDecoder.create(CodecId.RBV),
                 lambda: rbv.decode(b""),
                 lambda: rbv.transcode_payload(b"", 30)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # asked for, the CPU needs no card
    assert Transcoder(device="cpu").device == torch.device("cpu")
