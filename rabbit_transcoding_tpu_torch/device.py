"""The device an entry point of the port runs on, and the host-blocking
copies between it and the host."""

from __future__ import annotations

import numpy as np
import torch

from .utils import timing


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


def to_device(data: np.ndarray | torch.Tensor,
              device: torch.device | str) -> torch.Tensor:
    """``data`` (a numpy array, or a tensor in host memory) as a tensor on
    ``device``: ``.to(device)``, which from host memory to a card returns
    only after the card's stream has drained.  While spans are recorded it
    is an ``upload`` span counting its ``bytes``.  The port pins no host
    memory, so every upload is from pageable memory and the span does not
    ask (``is_pinned`` is a dispatch that lets go of the interpreter
    lock); a copy from pinned memory would note ``pinned``."""
    t = torch.from_numpy(data) if isinstance(data, np.ndarray) else data
    if not timing.recording():
        return t.to(device)
    with timing.span("upload") as sp:
        sp.note("bytes", t.nbytes)
        return t.to(device)


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array in (pageable) host memory: ``.cpu()``, which
    from a card waits for the card's stream.  While spans are recorded it
    is a ``download`` span counting its ``bytes``."""
    if not timing.recording():
        return x.cpu().numpy()
    with timing.span("download") as sp:
        sp.note("bytes", x.nbytes)
        return x.cpu().numpy()


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
