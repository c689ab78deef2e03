"""The port's CUDA kernel against its plain PyTorch version, on the GPU.

Marked ``cuda``: skipped where there is no CUDA device (the kernel has no
CPU mode).  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu_torch.ops import transcode as tc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qs(qp: int) -> float:
    return float(np.float32(2.0 ** ((qp - 4.0) / 6.0)))


@pytest.mark.parametrize("gop_in,gop_out", [(1, 1), (2, 2), (4, 4), (2, 1),
                                            (1, 2), (3, 2)])
def test_kernel_matches_plain_version(cuda, gop_in, gop_out):
    rng = np.random.default_rng(0)
    c = torch.from_numpy(
        rng.integers(-60, 60, size=(5, 3, 4, 16, 16)).astype(np.int16)
    ).to(cuda)
    args = (c, _qs(16), _qs(32), 1023.0, gop_in, gop_out)
    before = tc.LAUNCHES
    got = tc.transcode_coeffs(*args)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == before + 1
    want = tc.transcode_coeffs_ref(*args)
    # both sum in the same order: exact, as on the CPU
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tc.transcode_coeffs_ref(c.cpu(), *args[1:]))


def test_kernel_rejects_bad_input(cuda):
    c = torch.zeros((2, 1, 1, 8, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        tc.transcode_coeffs(c, 1.0, 2.0, 255.0, 1, 1)
    with pytest.raises(TypeError):
        tc.transcode_coeffs(c.to(torch.int32), 1.0, 2.0, 255.0, 1, 1)


def test_kernel_on_every_device_while_device_0_is_current(cuda):
    # the kernel library links its own CUDA runtime: it must launch on the
    # tensor's card, not on its own current device, and leave the caller's
    # current device as it found it
    rng = np.random.default_rng(1)
    c = rng.integers(-60, 60, size=(4, 2, 3, 16, 16)).astype(np.int16)
    want = tc.transcode_coeffs_ref(torch.from_numpy(c), _qs(16), _qs(32),
                                   1023.0, 2, 2)
    torch.cuda.set_device(0)
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        got = tc.transcode_coeffs(torch.from_numpy(c).to(dev), _qs(16),
                                  _qs(32), 1023.0, 2, 2)
        torch.cuda.synchronize(dev)
        assert got.device == dev
        assert torch.equal(got.cpu(), want)
    assert torch.cuda.current_device() == 0
