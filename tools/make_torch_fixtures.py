"""Write the encoder-stream fixtures of the PyTorch port's tests and of
``chip_smoke.py`` into ``tests/fixtures_torch/``.

The machine with the GPU has no JAX.  So the JAX package's V-PCC encoder
writes a few small V3C streams here, on the CPU, and they are committed: the
port encodes them again from their sources, and decodes, transcodes and
measures them, on the card.  Three carry the encoder's defaults and the
decoder's lossy-occupancy and EOM branches (``testdata.ENCODER_STREAMS``);
seven more carry one encoder branch each (``testdata.BRANCH_STREAMS``: point
local reconstruction, pixel interleaving, 45-degree projection, level of
detail, reflectance, per-map streams, lossless raw points).  Beside each
stream ``<name>.bin`` lie

* ``<name>_source.npz``: the source clouds the encoder was given, frame by
  frame (``positions_<i>`` uint16, ``colors_<i>`` uint8, and
  ``reflectances_<i>`` uint16 where the clouds carry them), so that nobody
  has to rebuild them from ``sin``/``cos`` on another numpy build;
* ``<name>.json``: the encoder parameters that differ from the defaults, the
  reference decoder's per-frame checksums (``PointSet.compute_checksum``),
  its point counts, and the reference's ``compute_sequence_metrics`` of the
  decode against the source (per frame and the summary), every float as
  ``float.hex`` so that it reads back bit for bit.

Run it from the root of the repo with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [--only NAME ...]

Beside them, ``normals_ref.npz`` holds the JAX package's normals of frame 0
of ``scene_lossy_occupancy_pbf_source.npz``: ``normals``, what
``compute_normals`` returns, and ``eigenvalues``, those of
``_pca_normals_full`` on ``knn_graph(points, 16)`` with no radius cap (what
``generate_normals`` computes at its defaults).  ``chip_smoke.py`` holds
the port's, computed on the card, against them (``--only normals_ref``
writes it alone).

``tests/test_torch_fill.py`` re-encodes the first stream with the JAX
encoder and ``tests/test_torch_encoder.py`` and
``tests/test_torch_branch_fixtures.py`` encode every stream with the port,
each holding the bytes against the committed file, so a stale fixture fails
a test.  The cloud makers are the port's ``testdata`` copies of the JAX
package's (the same arrays), with ``make_reflective_frame`` the port's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "fixtures_torch")

# the branch streams' common parameters (tests/test_torch_decoder_streams.py)
# and their cloud: a 7-bit sphere of ~5,300 points
_BRANCH_BASE = dict(minimumImageWidth=256, minimumImageHeight=64,
                    geometryQP=8, attributeQP=16, occupancyPrecision=2,
                    frameCount=1, groupOfFramesSize=1)
_BRANCH_CLOUD = dict(n=6000, radius=40.0, center=64.0, vox_bits=7)
_BRANCHES = {
    "plr": dict(pointLocalReconstruction=True, mapCountMinus1=0,
                flagGeometrySmoothing=False, constrainedPack=False),
    "pixel_interleaving": dict(singleMapPixelInterleaving=True,
                               mapCountMinus1=1),
    "projection_45": dict(additionalProjectionPlaneMode=3,
                          flagGeometrySmoothing=False, constrainedPack=False,
                          rawPointsPatch=False),
    "lod": dict(levelOfDetailX=2, levelOfDetailY=2, rawPointsPatch=False),
    "reflectance": dict(),
    "map_streams": dict(multipleStreams=True, absoluteD1=False,
                        absoluteT1=False),
    "raw_points": dict(rawPointsPatch=True, losslessGeo=True,
                       flagGeometrySmoothing=False),
}

# name -> (cloud maker in rabbit_transcoding_tpu_torch.testdata, its
# arguments per frame, encoder parameters that differ from
# EncoderParameters' defaults)
FIXTURES = {
    # lossy RBV with MC and intra, as the encoder codes by default
    "sphere_default": ("make_frame", dict(n=40000),
                       dict(frameCount=2, groupOfFramesSize=2)),
    # the decoder's other branches on a textured multi-object scene: lossy
    # occupancy with the patch border filter
    "scene_lossy_occupancy_pbf": (
        "make_scene_frame", dict(n=12000),
        dict(frameCount=2, groupOfFramesSize=2, minimumImageWidth=512,
             occupancyPrecision=4, lossyOccupancyMap=True,
             pbfEnableFlag=True)),
    # lossless geometry with the enhanced occupancy map: EOM points, and the
    # missed points in raw patches
    "sphere_eom_lossless": (
        "make_frame", dict(n=6000, radius=40.0, center=64.0, vox_bits=7),
        dict(frameCount=1, groupOfFramesSize=1, minimumImageWidth=256,
             enhancedOccupancyMapCode=True, losslessGeo=True,
             occupancyPrecision=1, flagGeometrySmoothing=False)),
    **{name: ("make_reflective_frame" if name == "reflectance"
              else "make_frame", _BRANCH_CLOUD, {**_BRANCH_BASE, **enc})
       for name, enc in _BRANCHES.items()},
}


def source_clouds(name: str):
    """The clouds the JAX encoder is given for fixture ``name``."""
    sys.path.insert(0, ROOT)
    from rabbit_transcoding_tpu.core.pointset import PointSet
    from rabbit_transcoding_tpu_torch import testdata

    maker, kwargs, enc = FIXTURES[name]
    clouds = [getattr(testdata, maker)(f, **kwargs)
              for f in range(enc["frameCount"])]
    return [PointSet(positions=c.positions, colors=c.colors,
                     reflectances=c.reflectances) for c in clouds]


def encode(name: str) -> bytes:
    """The V3C bytes of fixture ``name``, encoded afresh."""
    sys.path.insert(0, ROOT)
    from rabbit_transcoding_tpu import bitstream
    from rabbit_transcoding_tpu.core.gof import GroupOfFrames
    from rabbit_transcoding_tpu.encoder.encoder import Encoder
    from rabbit_transcoding_tpu.encoder.params import EncoderParameters

    context, _ = Encoder(EncoderParameters(**FIXTURES[name][2])).encode(
        GroupOfFrames(source_clouds(name)))
    writer = bitstream.V3CWriter()
    return writer.write(writer.encode(context))


def _hex(v):
    if isinstance(v, (tuple, list)):
        return [_hex(x) for x in v]
    if isinstance(v, float):
        return float(v).hex()
    return v


def metrics_record(m) -> dict:
    """A ``QualityMetrics`` as JSON: floats as ``float.hex``."""
    return {k: _hex(v) for k, v in dataclasses.asdict(m).items()}


def write_fixture(name: str) -> None:
    sys.path.insert(0, ROOT)
    from rabbit_transcoding_tpu import bitstream
    from rabbit_transcoding_tpu.decoder.decoder import Decoder
    from rabbit_transcoding_tpu.metrics.metrics import compute_sequence_metrics

    data = encode(name)
    sources = source_clouds(name)
    reader = bitstream.V3CReader()
    clouds = []
    for gof in reader.read(data):
        clouds.extend(Decoder().decode(reader.decode(gof)))
    per_frame, summary = compute_sequence_metrics(sources, clouds)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name + ".bin"), "wb") as f:
        f.write(data)
    arrays = {}
    for i, ps in enumerate(sources):
        assert ps.positions.min() >= 0 and ps.positions.max() < 65536
        arrays[f"positions_{i}"] = ps.positions.astype(np.uint16)
        arrays[f"colors_{i}"] = ps.colors.astype(np.uint8)
        if ps.reflectances is not None:
            arrays[f"reflectances_{i}"] = ps.reflectances.astype(np.uint16)
    np.savez_compressed(os.path.join(OUT_DIR, name + "_source.npz"), **arrays)
    record = {
        "cloud_maker": FIXTURES[name][0],
        "cloud_arguments": FIXTURES[name][1],
        "encoder_parameters": FIXTURES[name][2],
        "stream_bytes": len(data),
        "checksums": [ps.compute_checksum().hex() for ps in clouds],
        "point_counts": [int(ps.point_count) for ps in clouds],
        "metrics_per_frame": [metrics_record(m) for m in per_frame],
        "metrics_summary": metrics_record(summary),
    }
    with open(os.path.join(OUT_DIR, name + ".json"), "w",
              encoding="utf-8") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(data)} bytes, {record['point_counts']} points, "
          f"D1 {summary.d1_psnr:.4f} dB, D2 {summary.d2_psnr:.4f} dB, "
          f"Y {summary.color_psnr[0]:.4f} dB")


NORMALS_REF = "normals_ref"
NORMALS_SOURCE = "scene_lossy_occupancy_pbf"


def write_normals_ref() -> None:
    """``normals_ref.npz``: the JAX normals of the source's frame 0."""
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp

    from rabbit_transcoding_tpu.encoder import normals
    from rabbit_transcoding_tpu_torch import testdata

    _, sources, _ = testdata.load_encoder_stream(NORMALS_SOURCE)
    pts = sources[0].positions.astype(np.float32)
    got, _ = normals.compute_normals(pts)
    idx, _ = normals.knn_graph(pts, 16)
    _, vals, _, _ = normals._pca_normals_full(
        jnp.asarray(pts), jnp.asarray(idx),
        jnp.ones(idx.shape, bool), jnp.zeros(3, jnp.float32))
    np.savez(os.path.join(OUT_DIR, NORMALS_REF + ".npz"),
             normals=np.asarray(got, np.float32),
             eigenvalues=np.asarray(vals, np.float32))
    print(f"{NORMALS_REF}: {len(pts)} points of {NORMALS_SOURCE} frame 0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    names = sorted(FIXTURES) + [NORMALS_REF]
    ap.add_argument("--only", nargs="+", choices=names, default=names,
                    metavar="NAME")
    args = ap.parse_args(argv)
    for name in FIXTURES:
        if name in args.only:
            write_fixture(name)
    if NORMALS_REF in args.only:
        write_normals_ref()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
