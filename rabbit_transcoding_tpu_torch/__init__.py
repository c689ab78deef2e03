"""rabbit_transcoding_tpu_torch — the PyTorch + CUDA port of the live transcoder.

The JAX package ``rabbit_transcoding_tpu`` is the reference; this package
runs the same RBV live transcode in PyTorch on an NVIDIA Hopper card, with
its device kernels written by hand in CUDA C++: the fused GOP transcode
(``csrc/transcode_gops.cu``) and the transcode of streams with motion
compensation and intra prediction (``csrc/transcode_mc_intra.cu``).  Module
names follow the reference so each counterpart is easy to find:

  apps/        CLI entry points (``python -m rabbit_transcoding_tpu_torch.apps.transcode``,
               ``...apps.stream`` for several resumable streams)
  transcoder/  the live V3C transcoder on RBV streams, single and multi-stream
  parallel/    the batched multi-stream transcode of RBV payloads
  video/       the RBV codec (entropy on the host, transforms on the device)
  ops/         DCT, coding tools, push-pull fill, the kernel's wrappers and build
  csrc/        CUDA sources, compiled with nvcc at first use
  testdata.py  the benchmark's synthetic V3C stream and its variants
  device.py    the entry points' device: the card unless the caller asks for
               the CPU (no card raises)

The host layers are the port's own copies of the reference's, under the same
relative paths and changed only in their imports: ``bitstream/`` (V3C reader,
writer, SEI), ``core/`` (``Video``, ``Patch``), ``codec/`` (map-pair deltas,
patch frames, hash SEI), ``utils/`` (enums, options, timing),
``transcoder/params.py`` and ``native/`` (the rANS library, built with g++
into ``build/native/``).  Nothing here imports the reference package,
``jax`` or ``triton``, and no CUDA library is loaded at import time.  The
package itself imports no torch either (``ops/dct.py``, the one user of
``torch.matmul``, turns TF32 off), so that host-only children such as the
stand-in codec (``mock_hevc.py``) start quickly.
"""

__version__ = "0.1.0"
