"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve(device: torch.device | str = "cuda") -> torch.device:
    """``device`` as a ``torch.device``: the card unless the caller asks for
    the CPU.  Raises ``RuntimeError`` when a CUDA device is asked for (the
    default) and none is available; never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for but no CUDA device is available (pass "
            f"device='cpu' for the plain PyTorch versions)")
    return dev
