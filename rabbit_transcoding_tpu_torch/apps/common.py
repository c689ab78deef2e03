"""Shared CLI plumbing for the apps (program-options-lite-style UX), as in
``rabbit_transcoding_tpu/apps/common.py`` without its JAX backend pinning."""

from __future__ import annotations

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
