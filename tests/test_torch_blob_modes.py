"""The port's RBV wire formats against the JAX package's, on the CPU:

* coefficient blobs of modes 0 (dense zlib), 1 (global sparse) and 2
  (per-frame sparse), which both decoders read and no encoder writes, with
  an index beyond the tensor dropped;
* V3C streams whose RBV payloads are rewritten to each of those modes:
  equal videos, and equal ``reencode`` and ``requant`` transcodes, in both
  packages;
* the int8 AC slab upload (``_from_freq_slab_split``) and the switch that
  turns it on (``RBV_SLAB8``, else a measured link rate under 100 MB/s);
* ``RBV_BANDS=0``, which takes the band-rANS candidate out of the
  encoder's size race.

Only bytes and numpy arrays pass between the packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefParameters,
)
from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder as RefTranscoder
from rabbit_transcoding_tpu.video import rbv as ref
from rabbit_transcoding_tpu_torch import testdata
from rabbit_transcoding_tpu_torch.bitstream import V3CReader, V3CWriter
from rabbit_transcoding_tpu_torch.transcoder.params import TranscoderParameters
from rabbit_transcoding_tpu_torch.transcoder.transcoder import Transcoder
from rabbit_transcoding_tpu_torch.video import rbv

from test_torch_rbv import _coeffs


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
SHAPE = (3, 2, 3, 16, 16)


# --- blobs of modes 0-2 ------------------------------------------------------
@pytest.mark.parametrize("mode,drop", [(0, False), (1, False), (1, True),
                                       (2, False), (2, True)])
def test_old_mode_blobs_decode_as_in_the_reference(mode, drop):
    c = _coeffs(mode + 3 * drop, shape=SHAPE)
    c[1, 0, 2, 0, 0] = -700     # a DC the DPCM must carry
    blob = testdata.coeff_blob(c, mode, drop=drop)
    if mode == 0:
        assert blob == ref._encode_dense_blob(c, 6)
    assert blob[0] == mode
    want = np.asarray(ref._decode_coeff_blob(blob, *SHAPE[:4]))
    got = rbv._decode_coeff_blob(blob, *SHAPE[:4], CPU)
    assert got.dtype == torch.int16 and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.numpy(), want)
    # the out-of-range index is dropped; every other value lands
    np.testing.assert_array_equal(want, c)


def test_densify_drops_out_of_range_indices():
    idx = np.array([0, 5, 6 * 16, 6 * 256 + 3, 1 << 33], np.int64)
    vals = np.array([1, -2, 3, 4, 5], np.int16)
    got = rbv._densify(idx, vals, (1, 2, 3, 16, 16), CPU).numpy()
    want = np.zeros(6 * 256, np.int16)
    want[[0, 5, 96]] = [1, -2, 3]
    np.testing.assert_array_equal(got.reshape(-1), want)


def _ref_transcode(data: bytes, mode: str) -> bytes:
    reader = ref_bitstream.V3CReader()
    context = reader.decode(reader.read(data)[0])
    RefTranscoder(RefParameters(geometryQP=24, attributeQP=34, mode=mode)
                  ).transcode(context)
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


def _port_transcode(data: bytes, mode: str) -> bytes:
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    Transcoder(TranscoderParameters(geometryQP=24, attributeQP=34,
                                    mode=mode), CPU).transcode(context)
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def _lossy_videos(data: bytes) -> dict:
    reader = V3CReader()
    atlas = reader.decode(reader.read(data)[0]).atlas(0)
    return {vt.name: vb.data for vt, vb in atlas.video_bitstreams.items()
            if not rbv.probe(vb.data)["lossless"]}


@pytest.fixture(scope="module")
def streams():
    """A stream of the kernel's branch (no MC, no intra) and one coded as
    the encoder codes by default (MC + intra side sections)."""
    return {"plain": testdata.make_stream(2, 64, 64),
            "mc_intra": testdata.make_stream(4, 64, 64, motion=True,
                                             intra=True)}


@pytest.mark.parametrize("kind", ["plain", "mc_intra"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_rewritten_streams_decode_and_transcode_in_both(streams, kind,
                                                        mode):
    data = streams[kind]
    rewritten = testdata.with_blob_mode(data, mode, drop=mode > 0)
    videos = _lossy_videos(rewritten)
    assert videos and all(_lossy_videos(data)[k] != v
                          for k, v in videos.items())
    for name, payload in videos.items():
        want = ref.decode(payload)
        got = rbv.decode(payload, CPU)
        original = rbv.decode(_lossy_videos(data)[name], CPU)
        for a, b, o in zip(got.planes, want.planes, original.planes):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, o)
    for transcode_mode in ("reencode", "requant"):
        got = _port_transcode(rewritten, transcode_mode)
        assert got == _ref_transcode(rewritten, transcode_mode)
        # the transcoders write mode 3: the same bytes as from the original
        assert got == _port_transcode(data, transcode_mode)


def test_unknown_blob_mode_raises():
    with pytest.raises(ValueError, match="unknown RBV coefficient blob mode"):
        rbv._decode_coeff_blob(b"\x04" + b"\0" * 16, 1, 1, 1, 16, CPU)


# --- the int8 AC slab upload -------------------------------------------------
@pytest.mark.parametrize("kmax", [4, 48, 256])
def test_from_freq_slab_split_equals_from_freq_slab(kmax):
    rng = np.random.default_rng(kmax)
    slab = rng.integers(-127, 128, size=(3, kmax, 2, 3)).astype(np.int16)
    slab[:, 0] = rng.integers(-3000, 3000, size=(3, 2, 3))
    dc, ac8 = slab[:, 0].copy(), slab[:, 1:].astype(np.int8)
    want = np.asarray(ref._from_freq_slab_split(
        jnp.asarray(dc), jnp.asarray(ac8), 16, kmax))
    got = rbv._from_freq_slab_split(torch.from_numpy(dc),
                                    torch.from_numpy(ac8), 16, kmax)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), rbv._from_freq_slab(torch.from_numpy(slab), 16,
                                         kmax).numpy())


@pytest.mark.parametrize("rate", [None, 20.0, 99.9, 100.0, 2000.0])
@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
def test_slab8_switch_has_the_reference_truth_table(monkeypatch, env, rate):
    if env is None:
        monkeypatch.delenv("RBV_SLAB8", raising=False)
    else:
        monkeypatch.setenv("RBV_SLAB8", env)
    monkeypatch.setattr(ref, "_LINK_RATE_MBPS", rate)
    monkeypatch.setattr(rbv, "_LINK_RATE_MBPS", rate)
    assert rbv._slab8_enabled() == ref._slab8_enabled()
    assert rbv._slab8_enabled() == (
        env == "1" if env is not None else rate is not None and rate < 100.0)


@pytest.mark.parametrize("scale", [6.0, 400.0])
def test_slab8_decode_takes_the_split_only_where_ac_fits(monkeypatch, scale):
    """With ``RBV_SLAB8=1`` a mode-3 blob whose AC fits int8 goes through the
    split upload; one with a larger AC takes the int16 slab.  The tensors
    are the default path's either way."""
    c = _coeffs(11, shape=SHAPE, scale=scale, decay=0.05)
    blob = rbv._encode_coeff_blob(torch.from_numpy(c))
    monkeypatch.delenv("RBV_SLAB8", raising=False)
    monkeypatch.setattr(rbv, "_LINK_RATE_MBPS", None)
    default = rbv._decode_coeff_blob(blob, *SHAPE[:4], CPU)
    calls = []
    split = rbv._from_freq_slab_split

    def spy(*args):
        calls.append(args[1].dtype)
        return split(*args)

    monkeypatch.setattr(rbv, "_from_freq_slab_split", spy)
    monkeypatch.setenv("RBV_SLAB8", "1")
    got = rbv._decode_coeff_blob(blob, *SHAPE[:4], CPU)
    np.testing.assert_array_equal(got.numpy(), default.numpy())
    np.testing.assert_array_equal(got.numpy(), c)
    fits = int(np.abs(c.reshape(-1, 256)[:, 1:]).max()) <= 127
    assert calls == ([torch.int8] if fits else [])
    assert fits == (scale < 100)


def test_measure_link_rate_records_and_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(rbv, "_LINK_RATE_MBPS", None)
    rate = rbv.measure_link_rate(1 << 20, device=CPU)
    assert rate > 0 and rbv._LINK_RATE_MBPS == rate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rbv.measure_link_rate(1 << 20)


# --- RBV_BANDS ---------------------------------------------------------------
def _dense_slab_coeffs():
    """Coefficients whose zigzag slab is 4 x 128 x 16 x 32 int16 = 512 KiB,
    above the 64 KiB where the band candidate enters the race, with bands
    of distinct statistics (a wide DC, AC falling with the frequency), so
    that the band candidate wins it."""
    rng = np.random.default_rng(5)
    k = np.arange(128)[None, :, None, None]
    slab = np.round(rng.laplace(size=(4, 128, 16, 32))
                    * 30.0 * np.exp(-k / 12.0)).astype(np.int16)
    slab[:, 0] = rng.integers(0, 2000, size=(4, 16, 32))
    slab[:, 100:] = 0
    slab[:, 99] = 1
    return rbv._from_freq_slab(torch.from_numpy(slab), 16, 128).numpy()


@pytest.mark.parametrize("bands", [None, "1", "0"])
def test_rbv_bands_switch_gives_the_reference_blobs(monkeypatch, bands):
    if bands is None:
        monkeypatch.delenv("RBV_BANDS", raising=False)
    else:
        monkeypatch.setenv("RBV_BANDS", bands)
    q = _dense_slab_coeffs()
    got = rbv._encode_coeff_blob(torch.from_numpy(q))
    assert got == ref._encode_coeff_blob(jnp.asarray(q))
    assert int.from_bytes(got[1:3], "little") == 128
    assert (got[3:4] == b"B") == (bands != "0")
    np.testing.assert_array_equal(
        rbv._decode_coeff_blob(got, 4, 16, 32, 16, CPU).numpy(), q)

