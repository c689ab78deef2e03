"""The seven branch streams that the JAX encoder wrote
(``tests/fixtures_torch/``, ``testdata.BRANCH_STREAMS``: point local
reconstruction, pixel interleaving, 45-degree projection, level of detail,
reflectance, per-map streams, lossless raw points), on the CPU:

* each carries its branch;
* the port's encoder, with its own normals, writes the committed bytes from
  the committed source, and its closed loop has the reference decoder's
  checksums;
* the port's decode gives the committed checksums and point counts, and
  metrics equal to the committed reference values (D2 within 1e-5 dB);
* the port's ``reencode`` transcode decodes in the JAX package to the
  port's clouds, arrays in order.

``chip_smoke.py`` phase ``branch_fixtures`` holds the same on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu_torch import bitstream, testdata
from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames
from rabbit_transcoding_tpu_torch.encoder.encoder import Encoder
from rabbit_transcoding_tpu_torch.encoder.params import EncoderParameters
from rabbit_transcoding_tpu_torch.metrics.metrics import (
    compute_sequence_metrics,
)
from rabbit_transcoding_tpu_torch.transcoder import (
    Transcoder,
    TranscoderParameters,
)

from test_torch_decoder import assert_clouds_equal, decode_port, decode_ref


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


CPU = torch.device("cpu")
# D2 with normals computed against the committed values: equal on the CPU
# since the port's eigh is the reference's LAPACK ssyevd (ROADMAP queue 3
# item g.9, closed; held exactly by test_torch_eigh.py); the bound allows a
# host whose LAPACK picks other kernels than the one that wrote the fixtures
D2_BOUND_DB = 1e-5
D2_FIELDS = ("d2_mse", "d2_psnr", "d2_hausdorff", "d2_hausdorff_psnr")


def _write(context) -> bytes:
    writer = bitstream.V3CWriter()
    return writer.write(writer.encode(context))


@pytest.mark.parametrize("name", testdata.BRANCH_STREAMS)
def test_port_encoder_writes_the_committed_stream(name):
    data, sources, record = testdata.load_encoder_stream(name)
    assert testdata.branch_carried(name, data)
    context, recon = Encoder(
        EncoderParameters(**record["encoder_parameters"]), "cpu"
    ).encode(GroupOfFrames(sources))
    assert _write(context) == data
    assert [ps.compute_checksum().hex() for ps in recon] == \
        record["checksums"]


@pytest.mark.parametrize("name", testdata.BRANCH_STREAMS)
def test_port_decode_has_the_reference_checksums_and_metrics(name):
    data, sources, record = testdata.load_encoder_stream(name)
    clouds = decode_port(data)
    assert [ps.compute_checksum().hex() for ps in clouds] == \
        record["checksums"]
    assert [ps.point_count for ps in clouds] == record["point_counts"]
    if name == "reflectance":
        assert sources[0].reflectances is not None
        assert clouds[0].reflectances is not None
    per_frame, summary = compute_sequence_metrics(sources, clouds,
                                                  device=CPU)
    for got, want in zip([*per_frame, summary],
                         [*record["metrics_per_frame"],
                          record["metrics_summary"]]):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name in D2_FIELDS and np.isfinite(b) and f.name.endswith(
                    "psnr"):
                assert abs(a - b) <= D2_BOUND_DB, (name, f.name, a, b)
            elif f.name in D2_FIELDS and np.isfinite(b):
                assert abs(a - b) <= 1e-6 * max(abs(b), 1e-30), (f.name, a, b)
            else:
                assert a == b, (name, f.name, a, b)
    if name == "reflectance":
        assert summary.reflectance_psnr > 0


@pytest.mark.parametrize("name", testdata.BRANCH_STREAMS)
def test_port_transcode_decodes_in_the_reference(name):
    data, _, _ = testdata.load_encoder_stream(name)
    reader = bitstream.V3CReader()
    context = reader.decode(reader.read(data)[0])
    Transcoder(TranscoderParameters(geometryQP=24, attributeQP=34,
                                    mode="reencode"), CPU).transcode(context)
    out = _write(context)
    assert out != data and testdata.branch_carried(name, out)
    assert_clouds_equal(decode_ref(out), decode_port(out))
