"""The port's quality metrics against the JAX package's on the CPU.

The metrics are host float64 on integer inputs, a copy of the reference's:
every ``QualityMetrics`` field that passes through no normal is equal exactly
(``d1_*``, the colour and reflectance PSNRs, the point counts), and with
``source_normals`` passed in the D2 fields are equal exactly too.  When the
port computes the normals itself (``torch.linalg.eigh`` instead of the
reference's ``eigh``), the D2 fields are held within ``D2_BOUND_DB`` (PSNRs)
and ``D2_BOUND_REL`` (mse, Hausdorff): measured <= 6e-7 dB and <= 1.4e-7.
Only bytes and numpy arrays pass between the packages."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.core.pointset import PointSet as RefPointSet
from rabbit_transcoding_tpu.metrics import metrics as ref
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefTranscoderParameters,
)
from rabbit_transcoding_tpu.transcoder.transcoder import (
    Transcoder as RefTranscoder,
)
from rabbit_transcoding_tpu_torch.bitstream import V3CReader, V3CWriter
from rabbit_transcoding_tpu_torch.core.pointset import PointSet
from rabbit_transcoding_tpu_torch.metrics import metrics as port
from rabbit_transcoding_tpu_torch.testdata import (
    ENCODER_STREAMS,
    load_encoder_stream,
    make_frame,
)
from rabbit_transcoding_tpu_torch.transcoder import (
    Transcoder,
    TranscoderParameters,
)

from test_torch_decoder import decode_port


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


D2_FIELDS = ("d2_mse", "d2_psnr", "d2_hausdorff", "d2_hausdorff_psnr")
EXACT_FIELDS = tuple(
    f.name for f in dataclasses.fields(port.QualityMetrics)
    if f.name not in D2_FIELDS)
D2_BOUND_DB = 1e-5     # |port - reference| of d2_psnr, d2_hausdorff_psnr
D2_BOUND_REL = 1e-6    # relative, of d2_mse and d2_hausdorff


def _same(a, b) -> bool:
    """Exactly equal floats or tuples of floats (inf equals inf)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def assert_metrics(got, want, d2_exact: bool) -> dict:
    """Every exact field equal; D2 equal, or within the bound.  Returns the
    D2 deltas."""
    assert type(got).__name__ == type(want).__name__ == "QualityMetrics"
    for name in EXACT_FIELDS:
        assert _same(getattr(got, name), getattr(want, name)), (
            name, getattr(got, name), getattr(want, name))
    deltas = {}
    for name in D2_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if d2_exact or a == b:
            assert a == b, (name, a, b)
            deltas[name] = 0.0
        elif name.endswith("psnr"):
            deltas[name] = abs(a - b)
            assert deltas[name] <= D2_BOUND_DB, (name, a, b)
        else:
            deltas[name] = abs(a - b) / abs(b)
            assert deltas[name] <= D2_BOUND_REL, (name, a, b)
    return deltas


def _pair(pos, colors=None, refl=None, dtype=np.float64):
    kw = dict(
        positions=np.asarray(pos, dtype),
        colors=None if colors is None else np.asarray(colors, np.uint8))
    a, b = PointSet(**kw), RefPointSet(**kw)
    if refl is not None:
        a.reflectances = np.asarray(refl, np.uint16)
        b.reflectances = np.asarray(refl, np.uint16)
    return a, b


def _both(src, rec, params: dict, normals):
    got = port.compute_metrics(
        src[0], rec[0], port.MetricsParams(**params),
        source_normals=normals, device="cpu")
    want = ref.compute_metrics(
        src[1], rec[1], ref.MetricsParams(**params), source_normals=normals)
    return got, want


_X = np.array([[1.0, 0.0, 0.0]])
_rng = np.random.default_rng(7)
_RANDOM = dict(
    a_pos=_rng.integers(0, 6, size=(40, 3)).astype(np.float64),
    b_pos=_rng.integers(0, 6, size=(50, 3)).astype(np.float64),
    a_col=_rng.integers(0, 256, size=(40, 3)).astype(np.uint8),
    b_col=_rng.integers(0, 256, size=(50, 3)).astype(np.uint8),
)
_n = _rng.normal(size=(40, 3))
_RANDOM["normals"] = _n / np.linalg.norm(_n, axis=1, keepdims=True)

# tests/test_metrics_parity.py's cases: name -> (source, reconstruction,
# MetricsParams arguments, source normals, {field: hand-computed value})
_CASES = {
    "d2_hand_computed_average": (
        ([[0, 0, 0]],), ([[1, 0, 0], [0, 1, 0]],),
        dict(drop_duplicates=0), _X, dict(d2_mse=0.5, d1_mse=1.0)),
    "d2_single_nn_knob": (
        ([[0, 0, 0]],), ([[2, 0, 0], [0, 3, 0]],),
        dict(drop_duplicates=0, neighbors_d2=1), _X, dict(d2_mse=4.0)),
    "d2_extension_beyond_first_batch": (
        ([[0, 0, 0]],),
        ([[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
          [0, np.sqrt(0.5), np.sqrt(0.5)], [1, 0, 0]],),
        dict(drop_duplicates=0), _X, dict(d2_mse=1.0 / 6.0)),
    "proc_average": (
        ([[0, 0, 0]], [[100, 100, 100]]),
        ([[1, 0, 0], [0, 1, 0]], [[90, 90, 90], [110, 112, 110]]),
        dict(drop_duplicates=0, neighbors_proc=1), _X, {}),
    "proc_first": (
        ([[0, 0, 0]], [[100, 100, 100]]),
        ([[1, 0, 0], [0, 1, 0]], [[90, 90, 90], [110, 112, 110]]),
        dict(drop_duplicates=0, neighbors_proc=0), _X, {}),
    "proc_min": (
        ([[0, 0, 0]], [[100, 100, 100]]),
        ([[1, 0, 0], [0, 1, 0]], [[98, 98, 98], [180, 180, 180]]),
        dict(drop_duplicates=0, neighbors_proc=3), _X, {}),
    "proc_max": (
        ([[0, 0, 0]], [[100, 100, 100]]),
        ([[1, 0, 0], [0, 1, 0]], [[98, 98, 98], [180, 180, 180]]),
        dict(drop_duplicates=0, neighbors_proc=4), _X, {}),
    "random_clouds_average_mode": (
        (_RANDOM["a_pos"], _RANDOM["a_col"]),
        (_RANDOM["b_pos"], _RANDOM["b_col"]),
        dict(drop_duplicates=0, neighbors_proc=1), _RANDOM["normals"], {}),
    "random_clouds_drop_duplicates_2": (
        (_RANDOM["a_pos"], _RANDOM["a_col"]),
        (_RANDOM["b_pos"], _RANDOM["b_col"]),
        dict(drop_duplicates=2, neighbors_proc=2, resolution=511), None, {}),
    "mode_zero_keeps_all": (
        ([[0, 0, 0], [0, 0, 0]], [[1, 1, 1], [3, 3, 3]]),
        ([[0, 0, 0], [0, 0, 0]], [[1, 1, 1], [3, 3, 3]]),
        dict(drop_duplicates=0), np.array([[1.0, 0, 0], [1.0, 0, 0]]),
        dict(point_count_source=2)),
    "duplicates_averaged_on_both_clouds": (
        ([[0, 0, 0], [0, 0, 0], [4, 4, 4], [9, 1, 1], [2, 7, 3]],
         [[0, 0, 0], [255, 255, 255], [9, 9, 9], [1, 2, 3], [4, 5, 6]]),
        ([[0, 0, 0], [0, 0, 0], [4, 4, 4], [9, 1, 1], [2, 7, 3]],
         [[0, 0, 0], [255, 255, 255], [9, 9, 9], [1, 2, 3], [4, 5, 6]]),
        dict(drop_duplicates=2), np.tile(_X, (4, 1)),
        dict(color_psnr=(math.inf,) * 3, point_count_source=4)),
    "colour_hausdorff": (
        ([[0, 0, 0], [5, 0, 0]], [[100, 100, 100], [100, 100, 100]]),
        ([[0, 0, 0], [5, 0, 0]], [[100, 100, 100], [110, 100, 100]]),
        dict(drop_duplicates=0), np.array([[1.0, 0, 0], [1.0, 0, 0]]), {}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_metrics_parity_cases_equal(case):
    """Given normals (or, for the drop-duplicates case, an integer cloud of
    a few dozen points whose normals each package computes): all fields
    equal exactly."""
    src, rec, params, normals, hand = _CASES[case]
    got, want = _both(_pair(*src), _pair(*rec), params, normals)
    assert_metrics(got, want, d2_exact=normals is not None)
    for name, value in hand.items():
        assert getattr(got, name) == pytest.approx(value), name
    assert got.print() == want.print()
    assert got.csv_line() == want.csv_line()


def test_reflectance_psnr_equal():
    rng = np.random.default_rng(3)
    pos = np.unique(rng.integers(0, 12, size=(300, 3)), axis=0)
    refl = rng.integers(0, 60000, size=len(pos))
    src = _pair(pos, refl=refl, dtype=np.int32)
    rec = _pair(pos + (rng.random(pos.shape) < 0.1), refl=refl // 2 * 2,
                dtype=np.int32)
    normals = np.tile(_X, (len(pos), 1))
    got, want = _both(src, rec, dict(drop_duplicates=0), normals)
    assert_metrics(got, want, d2_exact=True)
    assert 0 < got.reflectance_psnr < math.inf
    assert "Reflectance PSNR" in got.print()


def test_float_clouds_take_the_kdtree_in_both():
    """Non-integral positions: the native KNN does not apply, both packages
    go to the KD-tree.  All fields equal."""
    rng = np.random.default_rng(5)
    a = rng.random((200, 3)) * 20
    b = a + rng.normal(size=a.shape) * 0.3
    col = rng.integers(0, 256, size=(200, 3))
    normals = rng.normal(size=(200, 3))
    got, want = _both(_pair(a, col), _pair(b, col), dict(drop_duplicates=0),
                      normals)
    assert_metrics(got, want, d2_exact=True)


def _ref_clouds(clouds):
    return [RefPointSet(positions=ps.positions, colors=ps.colors)
            for ps in clouds]


@pytest.fixture(scope="module")
def sphere_stream():
    """Fixture (a): the reference encoder's stream of two sphere frames, its
    source clouds and the reference's values, and the port's decode."""
    data, sources, record = load_encoder_stream("sphere_default")
    return data, sources, record, decode_port(data)


def test_port_computes_the_normals_d2_within_the_bound(sphere_stream):
    """A real decode against its source, normals computed by each package:
    exact fields equal, D2 within the bound; the deltas are printed."""
    _, sources, _, clouds = sphere_stream
    got = port.compute_metrics(sources[0], clouds[0], device="cpu")
    want = ref.compute_metrics(_ref_clouds(sources)[0],
                               _ref_clouds(clouds)[0])
    deltas = assert_metrics(got, want, d2_exact=False)
    print("D2 deltas, port minus reference:", deltas,
          "d2_psnr", got.d2_psnr, want.d2_psnr)
    assert 40 < got.d1_psnr < 80 and 40 < got.d2_psnr < 90


def test_source_normals_on_the_cloud_are_used(sphere_stream):
    _, sources, _, clouds = sphere_stream
    rng = np.random.default_rng(0)
    n = rng.normal(size=sources[1].positions.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    src = PointSet(positions=sources[1].positions, colors=sources[1].colors,
                   normals=n)
    rsrc = RefPointSet(positions=sources[1].positions,
                       colors=sources[1].colors, normals=n)
    got = port.compute_metrics(src, clouds[1], device="cpu")
    want = ref.compute_metrics(rsrc, _ref_clouds(clouds)[1])
    assert_metrics(got, want, d2_exact=True)
    # no device is touched when the normals are given: "cuda" without a card
    # would raise in compute_normals
    assert port.compute_metrics(src, clouds[1], device="meta") == got


@pytest.mark.parametrize("name", list(ENCODER_STREAMS))
def test_sequence_metrics_equal_the_committed_reference_values(name):
    """Each committed encoder stream: the port's decode has the reference
    decoder's checksums, and ``compute_sequence_metrics`` of it against the
    committed source clouds has the reference's values (exact fields equal,
    D2 within the bound), per frame and in the summary."""
    data, sources, record = load_encoder_stream(name)
    clouds = decode_port(data)
    assert [ps.compute_checksum().hex() for ps in clouds] == (
        record["checksums"])
    assert [ps.point_count for ps in clouds] == record["point_counts"]
    per_frame, summary = port.compute_sequence_metrics(sources, clouds,
                                                       device="cpu")
    assert len(per_frame) == len(record["metrics_per_frame"])
    for got, want in zip(per_frame + [summary],
                         record["metrics_per_frame"]
                         + [record["metrics_summary"]]):
        deltas = assert_metrics(got, want, d2_exact=False)
    print(name, "summary D2 deltas:", deltas)


def test_sequence_metrics_against_the_reference_call():
    """A sequence with an identical frame (infinite PSNRs are left out of
    the averages), other parameters, and given normals on one source."""
    frames = [make_frame(f, n=3000) for f in range(3)]
    recs = [PointSet(positions=ps.positions + (i > 0) * (
                np.arange(ps.point_count)[:, None] % 3 == 0),
                colors=ps.colors // (1 + i)) for i, ps in enumerate(frames)]
    params = dict(resolution=255, drop_duplicates=1, neighbors_proc=3)
    got_pf, got = port.compute_sequence_metrics(
        frames, recs, port.MetricsParams(**params), device="cpu")
    want_pf, want = ref.compute_sequence_metrics(
        _ref_clouds(frames), _ref_clouds(recs), ref.MetricsParams(**params))
    assert math.isinf(got_pf[0].d1_psnr) and math.isfinite(got.d1_psnr)
    for a, b in zip(got_pf + [got], want_pf + [want]):
        assert_metrics(a, b, d2_exact=False)


def test_quality_of_the_transcode_equal_in_both_packages(sphere_stream):
    """The stand-in for the quality probe: the encoder's stream is
    transcoded by both packages (bytes equal), decoded by the port, and
    measured against the source by both packages' metrics: the deltas of the
    exact fields are 0, D2 within the bound; the transcode costs quality."""
    data, sources, record, _ = sphere_stream
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    Transcoder(TranscoderParameters(geometryQP=32, attributeQP=42),
               "cpu").transcode(context)
    writer = V3CWriter()
    out = writer.write(writer.encode(context))
    rreader = ref_bitstream.V3CReader()
    rcontext = rreader.decode(rreader.read(data)[0])
    RefTranscoder(RefTranscoderParameters(
        geometryQP=32, attributeQP=42)).transcode(rcontext)
    rwriter = ref_bitstream.V3CWriter()
    assert out == rwriter.write(rwriter.encode(rcontext)) != data
    clouds = decode_port(out)
    _, got = port.compute_sequence_metrics(sources, clouds, device="cpu")
    _, want = ref.compute_sequence_metrics(_ref_clouds(sources),
                                           _ref_clouds(clouds))
    assert_metrics(got, want, d2_exact=False)
    hq = record["metrics_summary"]
    print(f"HQ D1 {hq.d1_psnr:.4f} D2 {hq.d2_psnr:.4f} Y "
          f"{hq.color_psnr[0]:.4f}; transcoded D1 {got.d1_psnr:.4f} D2 "
          f"{got.d2_psnr:.4f} Y {got.color_psnr[0]:.4f}")
    assert got.color_psnr[0] < hq.color_psnr[0]
    assert got.d1_psnr <= hq.d1_psnr + 0.5


def test_metrics_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = PointSet(positions=np.arange(60).reshape(20, 3).astype(np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compute_metrics(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compute_sequence_metrics([a], [a])
    assert not hasattr(port, "d1_psnr_sharded")     # the mesh is not ported
