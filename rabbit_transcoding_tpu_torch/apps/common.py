"""Shared CLI plumbing for the apps (program-options-lite-style UX), as in
``rabbit_transcoding_tpu/apps/common.py`` without its JAX backend pinning."""

from __future__ import annotations

import contextlib
import os
import sys

from ..utils.config import OptionRegistry


def build_registry(params, extra: dict[str, tuple] | None = None) -> OptionRegistry:
    """Registry bound to a params dataclass; `extra` adds (default, help)."""
    reg = OptionRegistry()
    reg.add("help", False, "print help and exit")
    reg.add("configurationFolder", "", "base folder prepended to -c paths")
    reg.declare_dataclass(params)
    for name, (default, help_) in (extra or {}).items():
        reg.add(name, default, help_)
    return reg


def parse_or_help(reg: OptionRegistry, argv, params, title: str):
    reg.parse_args(list(argv))
    if reg["help"]:
        print(reg.help_text(title))
        return None
    for w in reg.warnings:
        print(f"warning: {w}", file=sys.stderr)
    reg.apply_to_dataclass(params)
    return params


@contextlib.contextmanager
def profile_to(profile_dir: str, device, name: str):
    """``--profileDir``: a ``torch.profiler`` trace of the block (host
    operators, and the card's kernels when ``device`` is a CUDA device),
    written as ``<profile_dir>/<name>.pt.trace.json`` (Chrome trace format)
    where the reference writes a ``jax.profiler`` trace.  An empty
    ``profile_dir`` profiles nothing."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"{name}.pt.trace.json"))
    print(f"profiler trace written to {profile_dir}")
