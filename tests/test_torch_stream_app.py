"""The port's rabbit-stream app against the JAX package's on the CPU:
checkpointed GOFs, resume, failure containment and the batched multi-stream
mode, with output bytes equal to the reference app's.  The streams are
built and inspected with the port's own V3C reader and writer; the reference
app reads and writes files."""

import json
import os

import pytest
import torch

from rabbit_transcoding_tpu.apps import stream as ref_app
from rabbit_transcoding_tpu_torch.apps import stream as app
from rabbit_transcoding_tpu_torch.bitstream import V3CReader, V3CWriter
from rabbit_transcoding_tpu_torch.bitstream.v3c import (
    sample_stream_header,
    write_sample_stream_units,
)
from rabbit_transcoding_tpu_torch.bitstream.video_bitstream import VideoBitstream
from rabbit_transcoding_tpu_torch.testdata import make_stream, with_input_qps
from rabbit_transcoding_tpu_torch.utils.enums import V3CUnitType, VideoType

QPS = dict(geometryQP=28, attributeQP=38)


def _write_gofs(path, datas) -> str:
    """A multi-GOF stream file: the first GOF of each V3C byte string."""
    reader, writer = V3CReader(), V3CWriter()
    units = []
    for data in datas:
        units.extend(writer.encode(reader.decode(reader.read(data)[0])))
    writer.write_file(units, str(path))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("streams")
    base = make_stream(2, 64, 64)
    mc_intra = make_stream(2, 64, 64, motion=True, intra=True)
    pair = make_stream(2, 64, 64, map_pair=True)
    return {
        # 3 GOFs: the content at three input QPs
        "three_gofs": _write_gofs(d / "three.bin", [
            base, with_input_qps(base, 20, 26),
            with_input_qps(base, 24, 30)]),
        # two different 2-GOF streams
        "a": _write_gofs(d / "a.bin", [base, with_input_qps(base, 18, 24)]),
        "b": _write_gofs(d / "b.bin", [with_input_qps(base, 22, 28), base]),
        "mc_intra": _write_gofs(d / "mc.bin", [mc_intra]),
        "pair": _write_gofs(d / "pair.bin", [pair]),
    }


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _reference(path_in, tmp_path, name, params) -> bytes:
    out = str(tmp_path / f"ref_{name}.bin")
    ref_app.transcode_stream(path_in, out, ref_app.StreamParams(
        **{k: getattr(params, k) for k in ("geometryQP", "attributeQP",
                                           "onError", "mode")}))
    return _read(out)


def test_full_run_matches_reference_app(inputs, tmp_path):
    out = str(tmp_path / "out.bin")
    params = app.StreamParams(**QPS)
    res = app.transcode_stream(inputs["three_gofs"], out, params, "cpu")
    assert res["gofs"] == 3 and res["failures"] == 0
    assert res["batched_failures"] == 0
    assert _read(out) == _reference(inputs["three_gofs"], tmp_path, "full",
                                    params)
    state = json.load(open(out + ".state.json"))
    assert state["gofs_done"] == 3
    assert state["out_bytes"] == os.path.getsize(out)


def test_resume_continues_not_restarts(inputs, tmp_path, monkeypatch):
    out = str(tmp_path / "out.bin")
    params = app.StreamParams(resume=True, **QPS)
    app.transcode_stream(inputs["three_gofs"], out, params, "cpu")
    full = _read(out)
    # a crash after GOF 0: keep the header and the first GOF's units
    state = json.load(open(out + ".state.json"))
    first = sample_stream_header(4) + write_sample_stream_units(
        V3CReader().read(full)[0], 4)
    open(out, "wb").write(full[:len(first)])
    state["gofs_done"], state["out_bytes"] = 1, len(first)
    json.dump(state, open(out + ".state.json", "w"))

    done = []
    real = app._StreamIO.write_gof

    def spy(self, blob):
        done.append(self.done)
        return real(self, blob)

    monkeypatch.setattr(app._StreamIO, "write_gof", spy)
    res = app.transcode_stream(inputs["three_gofs"], out, params, "cpu")
    assert done == [1, 2]  # GOF 0 was not transcoded again
    assert res["gofs"] == 3
    assert _read(out) == full
    assert json.load(open(out + ".state.json"))["gofs_done"] == 3


def test_stale_state_restarts(inputs, tmp_path, capsys):
    out = str(tmp_path / "out.bin")
    app.transcode_stream(inputs["three_gofs"], out,
                         app.StreamParams(resume=True, **QPS), "cpu")
    # other parameters: the state is stale and the run starts over
    params2 = app.StreamParams(resume=True, geometryQP=32, attributeQP=42)
    res = app.transcode_stream(inputs["three_gofs"], out, params2, "cpu")
    assert "stale state" in capsys.readouterr().err
    assert res["gofs"] == 3
    assert json.load(open(out + ".state.json"))["gofs_done"] == 3
    assert _read(out) == _reference(inputs["three_gofs"], tmp_path, "stale",
                                    params2)


def _poisoned(inputs, tmp_path) -> str:
    """The 3-GOF stream with the middle GOF's geometry unit corrupted."""
    gofs = V3CReader().read_file(inputs["three_gofs"])
    for u in gofs[1]:
        if u.header.unit_type == V3CUnitType.V3C_GVD:
            u.payload = b"CORRUPT!" + u.payload[8:]
    path = str(tmp_path / "broken.bin")
    open(path, "wb").write(sample_stream_header(4) + b"".join(
        write_sample_stream_units(g, 4) for g in gofs))
    return path


def test_on_error_skip_keeps_going(inputs, tmp_path):
    broken = _poisoned(inputs, tmp_path)
    out = str(tmp_path / "out.bin")
    params = app.StreamParams(onError="skip", **QPS)
    res = app.transcode_stream(broken, out, params, "cpu")
    assert res["failures"] == 1
    assert len(V3CReader().read_file(out)) == 2
    assert _read(out) == _reference(broken, tmp_path, "skip", params)
    with pytest.raises(Exception):
        app.transcode_stream(broken, str(tmp_path / "out2.bin"),
                             app.StreamParams(onError="abort", **QPS), "cpu")


@pytest.mark.parametrize("pair", [("a", "b"), ("mc_intra", "pair")])
def test_sharded_matches_unsharded_and_reference(inputs, tmp_path, pair):
    # ("mc_intra", "pair"): a plain MC + intra stream and a predicted-map
    # stream in one round, the pair transcoded jointly
    params = app.StreamParams(**QPS)
    paths = [inputs[k] for k in pair]
    plain = [str(tmp_path / f"plain{i}.bin") for i in range(2)]
    shard = [str(tmp_path / f"shard{i}.bin") for i in range(2)]
    for path, out in zip(paths, plain):
        app.transcode_stream(path, out, params, "cpu")
    results = app.transcode_streams_sharded(paths, shard, params, "cpu")
    assert all(r["failures"] == 0 and r["batched_failures"] == 0
               for r in results)
    for i, (p, s) in enumerate(zip(plain, shard)):
        assert _read(s) == _read(p)
        assert _read(s) == _reference(paths[i], tmp_path, f"r{i}", params)
        state = json.load(open(s + ".state.json"))
        assert state["gofs_done"] == state["gofs_total"]


def test_sharded_failure_containment(inputs, tmp_path, capsys):
    # a payload that is neither RBV nor Annex-B in GOF 1 of one stream: the
    # batched round fails, is reported and counted, and falls back to one
    # stream at a time; the other stream is not affected
    reader, writer = V3CReader(), V3CWriter()
    gofs = reader.read_file(inputs["a"])
    units = list(writer.encode(reader.decode(gofs[0])))
    bad_ctx = reader.decode(gofs[1])
    bad_ctx.atlas(0).set_video_bitstream(
        VideoBitstream(VideoType.GEOMETRY, b"GARBAGE" * 64))
    units.extend(writer.encode(bad_ctx))
    bad_path = str(tmp_path / "bad.bin")
    writer.write_file(units, bad_path)

    params = app.StreamParams(onError="skip", **QPS)
    outs = [str(tmp_path / f"o{i}.bin") for i in range(2)]
    results = app.transcode_streams_sharded([bad_path, inputs["b"]], outs,
                                            params, "cpu")
    assert "batched round failed" in capsys.readouterr().err
    assert [r["batched_failures"] for r in results] == [1, 1]
    assert results[0]["failures"] == 1 and results[1]["failures"] == 0
    assert len(V3CReader().read_file(outs[0])) == 1
    assert len(V3CReader().read_file(outs[1])) == 2
    ref_outs = [str(tmp_path / f"ref{i}.bin") for i in range(2)]
    ref_app.transcode_streams_sharded(
        [bad_path, inputs["b"]], ref_outs,
        ref_app.StreamParams(onError="skip", **QPS))
    assert [_read(o) for o in outs] == [_read(o) for o in ref_outs]


def test_main_sharded_cli(inputs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rc = app.main([f"--compressedStreamPath={inputs['a']},{inputs['b']}",
                   "--outStreamPath=o.bin", "--sharded=1", "--device=cpu",
                   "--geometryQP=28", "--attributeQP=38"])
    assert rc == 0
    assert "0 batched-round failures" in capsys.readouterr().out
    for i, key in enumerate(("a", "b")):
        assert _read(tmp_path / f"o_{i}.bin") == _reference(
            inputs[key], tmp_path, key, app.StreamParams(**QPS))


def test_main_trace_raises_and_cuda_needs_a_gpu(inputs, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    # --trace no longer raises: it decodes each transcoded GOF and writes
    # the enc_* logs (held against the reference app's in
    # test_torch_decode_app.py)
    assert app.main([f"--compressedStreamPath={inputs['a']}", "--trace",
                     "--outStreamPath=t.bin", "--device=cpu"]) == 0
    assert "gof_1_atlas_0_hls_md5" in (tmp_path / "enc_hls.txt").read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([f"--compressedStreamPath={inputs['a']}",
                  "--outStreamPath=o.bin"])
