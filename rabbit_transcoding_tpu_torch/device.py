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


def card_name_and_power() -> str:
    """Card 0's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]
