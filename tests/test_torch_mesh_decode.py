"""The port's decode with its reconstruction sharded over a mesh
(``DecoderParameters.shardingMesh``) against the port's one-device decode
(arrays in order) and the JAX package's sharded decode on its 8 virtual CPU
devices (checksums).  The port runs on virtual meshes that list the CPU
device several times.  Only bytes pass between the packages."""

import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.decoder.decoder import (
    Decoder as RefDecoder,
    DecoderParameters as RefDecoderParameters,
)
from rabbit_transcoding_tpu.parallel.mesh import make_mesh as ref_make_mesh
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.decoder.decoder import (
    Decoder,
    DecoderParameters,
)
from rabbit_transcoding_tpu_torch.parallel import mesh as pm
from rabbit_transcoding_tpu_torch.testdata import (
    load_encoder_stream,
    make_stream,
)

from test_torch_decoder import assert_clouds_equal

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


# --- the sharded decode --------------------------------------------------------
@pytest.fixture(scope="module")
def decode_streams():
    """Streams with the port's one-device decode and the JAX package's
    sharded decode checksums: an encoder stream with lossy occupancy and the
    patch border filter (2 frames), and a 3-frame patch stream with
    smoothing."""
    out = {}
    for name, data in (
            ("pbf", load_encoder_stream("scene_lossy_occupancy_pbf")[0]),
            ("patches", make_stream(3, 128, 128, patches=True,
                                    smoothing=True))):
        reader = V3CReader()
        one = Decoder(device="cpu").decode(reader.decode(reader.read(data)[0]))
        ref_reader = ref_bitstream.V3CReader()
        ref = RefDecoder(RefDecoderParameters(
            shardingMesh=ref_make_mesh())).decode(
                ref_reader.decode(ref_reader.read(data)[0]))
        out[name] = (data, one, [ps.compute_checksum() for ps in ref])
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["pbf", "patches"])
def test_sharded_decode_equals_one_device_and_reference(decode_streams,
                                                        name, shape):
    data, one, ref_checksums = decode_streams[name]
    reader = V3CReader()
    got = Decoder(DecoderParameters(shardingMesh=_mesh(shape)),
                  device="cpu").decode(reader.decode(reader.read(data)[0]))
    assert_clouds_equal(got, one)
    assert [ps.compute_checksum() for ps in got] == ref_checksums
