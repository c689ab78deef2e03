"""rabbit_transcoding_tpu_torch — the PyTorch + CUDA port of the live transcoder.

The JAX package ``rabbit_transcoding_tpu`` is the reference; this package
runs the same RBV live transcode in PyTorch on an NVIDIA Hopper card, with
its one device kernel (the fused GOP transcode) written by hand in CUDA C++
(``csrc/transcode_gops.cu``).  Module names follow the reference so each
counterpart is easy to find:

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
``jax`` or ``triton``, and no CUDA library is loaded at import time.
"""

import torch

# fp32 everywhere: TF32 keeps ~10 mantissa bits, far too coarse for 10-bit
# planes in a closed codec loop (the reference pins Precision.HIGHEST for the
# same reason).  Set before the package's first CUDA op.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
