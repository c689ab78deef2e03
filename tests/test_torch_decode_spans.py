"""The port's spans on the decode path (``utils/timing``): one ``decode``
root a GOF whose stage spans cover it, the plane spans of ``rbv.decode``,
the smoothing stages' children and the counts the benchmark's decode
readers take; and the transcode path's spans as they were."""

import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import cells, gen, harness
from benchmark.program_spans import intersect, length, union
from benchmark.reference import decode as ref_decode
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder
from rabbit_transcoding_tpu_torch.ops import smoothing as sm
from rabbit_transcoding_tpu_torch.testdata import make_stream
from rabbit_transcoding_tpu_torch.transcoder import (
    Transcoder, TranscoderParameters)
from rabbit_transcoding_tpu_torch.utils import timing
from rabbit_transcoding_tpu_torch.video import rbv

CPU = torch.device("cpu")
STAGES_WITH_POINTS = ("smoothPointCloudPostprocess", "colorSmoothing")
NEW_READERS = ("point_cloud_ms_per_gof", "geometry_smoothing_ms_per_gof",
               "color_smoothing_ms_per_gof", "smoothing_ns_per_point")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_recorder():
    timing.RECORDER.clear()
    yield
    timing.RECORDER.clear()


@pytest.fixture(scope="module")
def stream() -> bytes:
    return make_stream(4, 128, 128, motion=True, intra=True, map_pair=True,
                       patches=True, smoothing=True,
                       planes=gen.planes(2147483659, 4, 128, 128, CPU))


def _profiled_decode(data: bytes, device="cpu"):
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    decoder = Decoder(device=device)
    with profile(activities=[ProfilerActivity.CPU]):
        clouds = decoder.decode(context)
    return clouds, list(timing.RECORDER.spans)


def test_a_decode_is_one_root_covered_by_its_stages(stream):
    _, spans = _profiled_decode(stream)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "decode" and root.root == "decode"
    assert all(s.call == root.call for s in spans)
    stages = [s for s in spans if s.parent == root.id]
    assert {s.name for s in stages} >= {
        "decodeOccupancyVideo", "decodeGeometryVideo",
        "decodeAttributeVideo", "generatePointCloud", *STAGES_WITH_POINTS}
    covered = length(intersect(union((s.t0, s.t1) for s in stages),
                               [(root.t0, root.t1)]))
    assert covered >= 0.95 * (root.t1 - root.t0)


def test_the_stage_counts_are_the_clouds_sizes(stream):
    clouds, spans = _profiled_decode(stream)
    want = ref_decode.decode(stream, CPU)
    by_name = {s.name: s for s in spans if s.name in (
        "generatePointCloud",) + STAGES_WITH_POINTS}
    assert by_name["generatePointCloud"].counts == {"points": want.points}
    assert by_name["smoothPointCloudPostprocess"].counts == {
        "points": want.points, "moved": want.moved}
    assert by_name["colorSmoothing"].counts == {
        "points": sum(ps.point_count for ps in clouds),
        "recolored": want.recolored}
    assert want.moved > 0
    # the smoothing stage's children: per batch of clouds one grid, the
    # filter (the plain grid's own and the attribute gather) and one dedup
    stage = by_name["smoothPointCloudPostprocess"]
    kids = Counter(s.name for s in spans if s.parent == stage.id)
    assert 0 < len(clouds) <= sm._BATCH_CLOUDS
    assert kids["smooth_grid"] == 1 and kids["smooth_filter"] >= 2
    assert kids["dedup"] == 1


@pytest.mark.cuda
def test_on_a_card_the_grid_filter_is_the_kernel(stream):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = sm.GRID_LAUNCHES
    clouds, spans = _profiled_decode(stream, "cuda")
    stage = next(s for s in spans if s.name == "smoothPointCloudPostprocess")
    grids = [s for s in spans if s.name == "smooth_grid"]
    assert [s.parent for s in grids] == [stage.id]
    assert [s.counts for s in grids] == [{"kernel": "grid_smooth"}]
    assert sm.GRID_LAUNCHES == before + 1
    want = ref_decode.decode(stream, CPU)
    assert stage.counts == {"points": want.points, "moved": want.moved}
    assert len(clouds) == len(want.clouds)
    for got, ref in zip(clouds, want.clouds):
        assert sorted(map(tuple, got.positions)) == sorted(
            map(tuple, ref.positions))


def test_rbv_decode_records_each_planes_entropy_and_submit(stream):
    reader = V3CReader()
    atlas = reader.decode(reader.read(stream)[0]).atlas(0)
    for vb in atlas.video_bitstreams.values():
        lossless = rbv.probe(vb.data)["lossless"]
        timing.RECORDER.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            video = rbv.decode(vb.data, "cpu")
        names = Counter(s.name for s in timing.RECORDER.spans)
        planes = len(video.planes)
        assert names["entropy_decode"] == planes
        assert names["submit"] == (0 if lossless else planes)
        entropy = [s for s in timing.RECORDER.spans
                   if s.name == "entropy_decode"]
        assert sorted(s.plane for s in entropy) == list(range(planes))
        assert all(s.cpu0 is not None for s in entropy)


@pytest.mark.parametrize("kind,want", [
    ("mcintra", [("createHashSEI", 1), ("download", 12),
                 ("entropy_decode", 4), ("entropy_encode", 4), ("race", 8),
                 ("submit", 4), ("transcode", 1), ("transcodeAttribute", 1),
                 ("transcodeGeometry", 1), ("transcodeOccupancy", 1),
                 ("upload", 144)]),
    # the map pair's transcode decodes map 0 through rbv.decode: those
    # decodes add no plane spans of their own to the transcode's
    ("map_pair", [("createHashSEI", 1), ("download", 40), ("race", 16),
                  ("transcode", 1), ("transcodeAttribute", 1),
                  ("transcodeGeometry", 1), ("transcodeOccupancy", 1),
                  ("upload", 192)]),
])
def test_the_transcode_records_the_spans_it_did(kind, want):
    data = (make_stream(4, 64, 64, motion=True, intra=True)
            if kind == "mcintra" else make_stream(2, 64, 64, map_pair=True))
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    params = TranscoderParameters(geometryQP=32, attributeQP=42,
                                  mode="reencode")
    with profile(activities=[ProfilerActivity.CPU]):
        Transcoder(params, "cpu").transcode(context)
    assert sorted(Counter(s.name for s in timing.RECORDER.spans).items()) == (
        want)


def test_the_decode_readers_read_a_profiled_decode(stream, monkeypatch):
    t0 = time.perf_counter()
    _, spans = _profiled_decode(stream)
    t1 = time.perf_counter()
    monkeypatch.setattr(timing.RECORDER, "spans", spans)
    r = harness.Reading(cells.load("decode-patch"), [],
                        [harness.Gof(0, t0, t1, 4)], t0, t1, [])
    got = {name: harness.read_metric(name, r) for name in NEW_READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    stage = {s.name: s for s in spans}
    smoothing = sum(stage[n].t1 - stage[n].t0 for n in STAGES_WITH_POINTS)
    points = sum(stage[n].counts["points"] for n in STAGES_WITH_POINTS)
    assert got["smoothing_ns_per_point"] == pytest.approx(
        1e9 * smoothing / points)
    assert got["geometry_smoothing_ms_per_gof"] == pytest.approx(1e3 * (
        stage["smoothPointCloudPostprocess"].t1
        - stage["smoothPointCloudPostprocess"].t0))
    # the stage spans' self time: their copies taken out
    assert got["point_cloud_ms_per_gof"] < 1e3 * sum(
        stage[n].t1 - stage[n].t0
        for n in ("generateOccupancyMaps", "generatePointCloud"))


def test_the_decode_readers_read_nothing_without_spans(monkeypatch):
    monkeypatch.setattr(timing.RECORDER, "spans", [])
    r = harness.Reading(cells.load("decode-patch"), [],
                        [harness.Gof(0, 0.0, 1.0, 32)], 0.0, 1.0, [])
    assert all(harness.read_metric(name, r) is None
               for name in NEW_READERS)
