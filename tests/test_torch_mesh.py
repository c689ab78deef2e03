"""The port's device mesh against the JAX package's on the CPU: the mesh
factorisation, the sharded all-intra step, the sharded multi-stream
transcode (``transcode_payloads(mesh=...)``), ``MultiStreamTranscoder`` and
``rabbit-stream --sharded=1`` over a mesh.

The port runs on virtual meshes that list the CPU device several times;
the JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``).
Bytes are compared with the port's one-device path and with the JAX
package's sequential and sharded paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.apps import stream as ref_app
from rabbit_transcoding_tpu.parallel.mesh import (
    make_mesh as ref_make_mesh,
    make_sharded_transcode_step as ref_sharded_step,
    transcode_compute_step as ref_compute_step,
)
from rabbit_transcoding_tpu.parallel.multistream import (
    transcode_payloads as ref_transcode_payloads,
)
from rabbit_transcoding_tpu.video import rbv as ref_rbv
from rabbit_transcoding_tpu_torch.apps import stream as app
from rabbit_transcoding_tpu_torch.parallel import mesh as pm
from rabbit_transcoding_tpu_torch.parallel.multistream import (
    transcode_payloads,
)
from rabbit_transcoding_tpu_torch.testdata import make_stream, with_input_qps
from rabbit_transcoding_tpu_torch.transcoder.multistream import (
    MultiStreamTranscoder,
)
from rabbit_transcoding_tpu_torch.transcoder.params import TranscoderParameters
from rabbit_transcoding_tpu_torch.transcoder.transcoder import Transcoder

from test_torch_multistream import _CASES, _contexts, _payload, _write

CPU = torch.device("cpu")
# (stream, space) shapes of the virtual CPU meshes; 7 is prime
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


def _qs(qp: int) -> float:
    return float(np.float32(ref_rbv.qstep_of(qp)))


# --- the mesh -----------------------------------------------------------------
@pytest.mark.parametrize("n", range(1, 9))
def test_factorisation_equals_reference(n):
    ref = ref_make_mesh(jax.devices()[:n])
    got = pm.make_mesh([CPU] * n)
    assert got.shape == ref.devices.shape
    assert got.axis_names == ref.axis_names == ("stream", "space")
    assert got.size == n and got.flat == [CPU] * n
    assert pm.make_mesh([CPU] * 6, stream_axis=3).shape == (3, 2)


def test_mesh_of_and_no_card(monkeypatch):
    assert pm.mesh_of("cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="mesh rows"):
        pm.make_mesh([CPU] * 6, stream_axis=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (pm.make_mesh, lambda: pm.mesh_of("cuda"),
                 lambda: pm.make_mesh([CPU, torch.device("cuda", 1)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_scatter_and_gather_uneven():
    x = torch.arange(5 * 3).reshape(5, 3)
    chunks = pm.scatter(x, [CPU] * 8)
    assert [None if c is None else c.shape[0] for c in chunks] == [
        1, 1, 1, 1, 1, None, None, None]
    assert torch.equal(pm.gather(chunks, CPU), x)
    # a chunk is its own memory: shards never share a buffer
    chunks[0][0, 0] = 99
    assert x[0, 0] == 0
    assert pm.shard_bounds(7, 3) == [(0, 3), (3, 5), (5, 7)]


# --- the sharded all-intra step ------------------------------------------------
@pytest.fixture(scope="module")
def step_case():
    rng = np.random.default_rng(0)
    coeffs = rng.integers(-40, 40, size=(8, 4, 4, 2, 16, 16)).astype(
        np.int32)
    args = (jnp.float32(_qs(16)), jnp.float32(_qs(32)), jnp.float32(1023.0))
    ref = ref_compute_step(jnp.asarray(coeffs), *args)
    sharded = ref_sharded_step(ref_make_mesh())(jnp.asarray(coeffs), *args)
    return coeffs, [np.asarray(x) for x in ref], [np.asarray(x)
                                                 for x in sharded]


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_equals_reference(step_case, shape):
    coeffs, ref, ref_sharded = step_case
    q2, recon, mse = pm.make_sharded_transcode_step(_mesh(shape))(
        torch.from_numpy(coeffs), _qs(16), _qs(32), 1023.0)
    for want in (ref, ref_sharded):
        np.testing.assert_array_equal(q2.numpy(), want[0])
        np.testing.assert_array_equal(recon.numpy(), want[1])
        assert abs(float(mse) - float(want[2])) <= 1e-6 * float(want[2])
    one = pm.transcode_compute_step(torch.from_numpy(coeffs), _qs(16),
                                    _qs(32), 1023.0)
    assert torch.equal(one[0], q2) and torch.equal(one[1], recon)


def test_step_rejects_coefficients_beyond_int16():
    c = torch.zeros((1, 1, 1, 1, 16, 16), dtype=torch.int32)
    c[..., 0, 0] = 40000
    for step in (pm.transcode_compute_step,
                 pm.make_sharded_transcode_step(_mesh((2, 1)))):
        with pytest.raises(ValueError, match="int16"):
            step(c, 1.0, 2.0, 1023.0)


# --- transcode_payloads over a mesh --------------------------------------------
@pytest.fixture(scope="module")
def payload_cases():
    """Each case's payloads, the port's one-device bytes and the JAX
    package's sequential bytes."""
    out = {}
    for case, (make, qp, kw) in _CASES.items():
        pays = make()
        qps = [qp] * len(pays) if isinstance(qp, int) else qp
        if kw.get("mode") == "requant":
            seq = [ref_rbv.requantize(p, q) for p, q in zip(pays, qps)]
        else:
            seq = [ref_rbv.transcode_payload(
                p, q, new_gop=kw.get("new_gop"),
                coeff_threshold=kw.get("coeff_threshold", 0))
                for p, q in zip(pays, qps)]
        out[case] = (pays, seq, transcode_payloads(pays, qp, "cpu", **kw))
    return out


@pytest.mark.parametrize("case", list(_CASES))
def test_transcode_payloads_over_every_mesh(payload_cases, case):
    # mixed and per-stream QPs, MC, intra, MC + intra, both requant
    # branches, a GOP change, rows that do not divide, mixed shapes,
    # lossless, a threshold
    _, qp, kw = _CASES[case]
    pays, seq, one = payload_cases[case]
    assert one == seq
    for shape in SHAPES:
        assert transcode_payloads(pays, qp, mesh=_mesh(shape), **kw) == seq, (
            shape)


def test_transcode_payloads_equals_reference_sharded():
    # the JAX package's sharded path on its 8-device mesh, one small case
    # with an MC stream beside two plain ones
    pays = [_payload(16, f=2, h=32, w=48), _payload(22, f=2, h=32, w=48),
            _payload(18, f=2, h=32, w=48, mc=True)]
    ref = ref_transcode_payloads(pays, [30, 34, 32], mesh=ref_make_mesh())
    for shape in ((4, 2), (7, 1)):
        assert transcode_payloads(pays, [30, 34, 32],
                                  mesh=_mesh(shape)) == ref


def test_empty_shards_launch_nothing(monkeypatch):
    # 2 streams of the kernel's branch on a (4, 2) mesh: 2 of the 8 shards
    # hold a stream, the others never reach the kernel's wrapper
    from rabbit_transcoding_tpu_torch.parallel import multistream as ms

    pays = [_payload(16, f=2, h=48, w=48), _payload(20, f=2, h=48, w=48)]
    want = transcode_payloads(pays, 30, "cpu")
    calls = []
    real = ms.transcode_coeffs_batched

    def spy(q, *args):
        calls.append(tuple(q.shape))
        return real(q, *args)

    monkeypatch.setattr(ms, "transcode_coeffs_batched", spy)
    assert transcode_payloads(pays, 30, mesh=_mesh((4, 2))) == want
    # one stream per shard, its 3 block rows whole: no row split
    assert calls == [(1, 2, 3, 3, 16, 16)] * 2


# --- MultiStreamTranscoder and the stream app over a mesh ----------------------
@pytest.fixture(scope="module")
def streams():
    base = make_stream(2, 64, 64)
    mc_intra = make_stream(2, 64, 64, motion=True, intra=True)
    return [base, with_input_qps(base, 20, 26), mc_intra,
            with_input_qps(base, 24, 30), with_input_qps(mc_intra, 22, 28)]


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_multistream_transcoder_over_mesh(streams, shape):
    params = TranscoderParameters(geometryQP=28, attributeQP=38)
    contexts = _contexts(streams)
    mesh = _mesh(shape)
    mst = MultiStreamTranscoder(params, mesh=mesh)
    mst.transcode_many(contexts)
    assert mst.mesh is mesh and mst.device == CPU
    want = _contexts(streams)
    for ctx in want:
        Transcoder(params, "cpu").transcode(ctx)
    assert _write(contexts) == _write(want)


def test_multistream_transcoder_devices():
    # stream i's own Transcoder sits on the first device of mesh row
    # i % rows; the CPU device gives a one-device mesh
    cpu0 = torch.device("cpu", 0)
    mst = MultiStreamTranscoder(mesh=pm.Mesh([[CPU, cpu0], [cpu0, CPU]]))
    assert [mst.single(i).device for i in range(4)] == [CPU, cpu0, CPU,
                                                        cpu0]
    assert MultiStreamTranscoder(device="cpu").mesh.flat == [CPU]


@pytest.mark.parametrize("entry", ["transcoder", "payloads", "stream_app"])
def test_device_and_mesh_together_raise(entry):
    # one placement argument: a device beside a mesh is refused, not dropped
    mesh = _mesh((2, 1))
    with pytest.raises(ValueError, match="not both"):
        if entry == "transcoder":
            MultiStreamTranscoder(device="cpu", mesh=mesh)
        elif entry == "payloads":
            transcode_payloads([_payload(16)], 30, "cpu", mesh=mesh)
        else:
            app.transcode_streams_sharded([], [], app.StreamParams(), "cpu",
                                          mesh=mesh)


def _write_gofs(path, datas) -> str:
    from rabbit_transcoding_tpu_torch.bitstream import V3CReader, V3CWriter

    reader, writer = V3CReader(), V3CWriter()
    units = []
    for data in datas:
        units.extend(writer.encode(reader.decode(reader.read(data)[0])))
    writer.write_file(units, str(path))
    return str(path)


def test_stream_app_sharded_over_mesh(streams, tmp_path):
    qps = dict(geometryQP=28, attributeQP=38)
    params = app.StreamParams(**qps)
    paths = [_write_gofs(tmp_path / "a.bin", streams[:2]),
             _write_gofs(tmp_path / "b.bin", streams[2:4]),
             _write_gofs(tmp_path / "c.bin", [streams[4]])]
    plain = [str(tmp_path / f"plain{i}.bin") for i in range(3)]
    shard = [str(tmp_path / f"shard{i}.bin") for i in range(3)]
    for path, out in zip(paths, plain):
        app.transcode_stream(path, out, params, "cpu")
    results = app.transcode_streams_sharded(paths, shard, params,
                                            mesh=_mesh((4, 2)))
    assert all(r["failures"] == 0 and r["batched_failures"] == 0
               for r in results)
    ref_params = ref_app.StreamParams(**qps)
    for i, (path, p, s) in enumerate(zip(paths, plain, shard)):
        got = open(s, "rb").read()
        assert got == open(p, "rb").read()
        ref_out = str(tmp_path / f"ref{i}.bin")
        ref_app.transcode_stream(path, ref_out, ref_params)
        assert got == open(ref_out, "rb").read()
