"""Measure the float mismatch of the sharded all-intra transcode step: the
PyTorch port's (``rabbit_transcoding_tpu_torch/parallel/mesh.py``) against
the JAX package's one-device and sharded steps, on the CPU, at the bench's
luma shape (4, 32, 64, 64, 16, 16): the geometry luma of the bench stream
requantised to input QPs 16/18/20/22, the stacks ``chip_smoke.py`` phase 32
gives the step.

Run it from the root of the repo with the JAX package on the CPU (8 virtual
devices for its sharded step; ~2 minutes, a few GB of memory):

    python tools/step_mse_mismatch.py

Prints whether q2 and recon are equal and the MSE of each step with the
port's relative difference from the JAX steps'.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rabbit_transcoding_tpu.parallel import mesh as ref_mesh  # noqa: E402
from rabbit_transcoding_tpu.video.rbv import qstep_of  # noqa: E402
from rabbit_transcoding_tpu_torch.parallel import mesh as pm  # noqa: E402
from rabbit_transcoding_tpu_torch.testdata import (  # noqa: E402
    make_stream, stream_coeffs, with_input_qps,
)

STREAM_QPS = (16, 18, 20, 22)


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    data = make_stream(32, 1024, 1024)
    luma = torch.stack([
        stream_coeffs(with_input_qps(data, q, q + 6))[("GEOMETRY", 0)]
        for q in STREAM_QPS]).to(torch.int32)
    qs_in, qs_out = float(np.float32(qstep_of(16))), float(np.float32(
        qstep_of(32)))
    print(f"luma {tuple(luma.shape)}", flush=True)
    args = (jnp.float32(qs_in), jnp.float32(qs_out), jnp.float32(1023.0))
    coeffs = jnp.asarray(luma.numpy())
    ref_one = [np.asarray(x)
               for x in ref_mesh.transcode_compute_step(coeffs, *args)]
    ref_sharded = [np.asarray(x) for x in ref_mesh.make_sharded_transcode_step(
        ref_mesh.make_mesh())(coeffs, *args)]
    del coeffs
    one = pm.transcode_compute_step(luma, qs_in, qs_out, 1023.0)
    sharded = pm.make_sharded_transcode_step(
        pm.make_mesh([torch.device("cpu")] * 8))(luma, qs_in, qs_out, 1023.0)
    for name, ours in (("port one-device", one), ("port (4, 2) mesh",
                                                  sharded)):
        for ref_name, ref in (("JAX one-device", ref_one),
                              ("JAX sharded", ref_sharded)):
            mse, want = float(ours[2]), float(ref[2])
            print(f"{name} vs {ref_name}: q2 equal "
                  f"{np.array_equal(ours[0].numpy(), ref[0])}, recon equal "
                  f"{np.array_equal(ours[1].numpy(), ref[1])}, MSE {mse!r} "
                  f"vs {want!r}, relative {(mse - want) / want:+.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
