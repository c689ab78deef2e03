"""Conformance checking.

Capability parity with PCCConformance (source/lib/
PccLibConformance/source/PCCConformance.cpp:49-120): compare encoder-side vs
decoder-side trace logs key-by-key (hls/atlas/tile/pcframe categories written
by utils.tracing.Tracer) and check atlas-level limits.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class ConformanceParams:
    path: str = "."            # directory holding the trace logs
    trace_prefix_enc: str = "enc_"
    trace_prefix_dec: str = "dec_"
    level: float = 30          # ptl_level_idc / 10 style limit selector
    fps: int = 30


# atlas level limits: level -> (max patches/frame, max atlas size)
_LEVEL_LIMITS = {
    10: (256, 2048 * 2048),
    20: (1024, 2048 * 2048),
    30: (2048, 4096 * 4096),
    40: (4096, 8192 * 8192),
}


@dataclasses.dataclass
class ConformanceResult:
    compared_files: int = 0
    mismatched_keys: list[str] = dataclasses.field(default_factory=list)
    missing_files: list[str] = dataclasses.field(default_factory=list)
    level_violations: list[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.mismatched_keys or self.missing_files
                    or self.level_violations)

    def report(self) -> str:
        lines = [f"conformance: {'PASS' if self.ok else 'FAIL'} "
                 f"({self.compared_files} log pairs compared)"]
        for m in self.missing_files:
            lines.append(f"  missing: {m}")
        for m in self.mismatched_keys[:50]:
            lines.append(f"  mismatch: {m}")
        for m in self.level_violations:
            lines.append(f"  level: {m}")
        return "\n".join(lines)


def _parse_kv(path: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for line in open(path, encoding="utf-8"):
        if "=" in line:
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


CATEGORIES = ("hls", "atlas", "tile", "pcframe", "bitstream_md5")


def check(params: ConformanceParams) -> ConformanceResult:
    res = ConformanceResult()
    for cat in CATEGORIES:
        enc_path = os.path.join(params.path, f"{params.trace_prefix_enc}{cat}.txt")
        dec_path = os.path.join(params.path, f"{params.trace_prefix_dec}{cat}.txt")
        if not os.path.exists(enc_path) and not os.path.exists(dec_path):
            continue
        if not os.path.exists(enc_path) or not os.path.exists(dec_path):
            res.missing_files.append(
                enc_path if not os.path.exists(enc_path) else dec_path
            )
            continue
        enc_kv = _parse_kv(enc_path)
        dec_kv = _parse_kv(dec_path)
        res.compared_files += 1
        for k in sorted(set(enc_kv) | set(dec_kv)):
            ev, dv = enc_kv.get(k), dec_kv.get(k)
            if ev != dv:
                res.mismatched_keys.append(f"{cat}:{k} enc={ev} dec={dv}")
        # level limits from the atlas log
        if cat == "atlas":
            limits = _LEVEL_LIMITS.get(int(params.level), _LEVEL_LIMITS[30])
            for k, v in dec_kv.items():
                if k.endswith("patch_count") and int(v) > limits[0]:
                    res.level_violations.append(
                        f"{k}={v} exceeds level {params.level} max {limits[0]}"
                    )
                if k.endswith("atlas_pixels") and int(v) > limits[1]:
                    res.level_violations.append(
                        f"{k}={v} exceeds level {params.level} max {limits[1]}"
                    )
    return res
