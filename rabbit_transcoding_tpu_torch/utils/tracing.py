"""Per-category trace logging (PCCLogger analog).

The reference compiles trace macros (TRACE_BITSTREAM/CODEC/PATCH/SEI/HLS/
ATLAS/TILE/PCFRAME/...) into per-category files (PCCLogger.h:226-260) and the
conformance checker diffs those files key-by-key (SURVEY.md §4.3, §5.1).
Here tracing is a runtime switch: each enabled category streams to
``<prefix>_<category>.txt``.  The atlas/tile/pcframe/hls categories emit the
``key = value`` lines the conformance comparator consumes.
"""

from __future__ import annotations

import enum
import os
from typing import IO


class TraceCategory(enum.Enum):
    BITSTREAM = "bitstream"
    HLS = "hls"
    ATLAS = "atlas"
    TILE = "tile"
    PCFRAME = "pcframe"
    RECFRAME = "recframe"
    PICTURE = "picture"
    PATCH = "patch"
    SEI = "sei"
    CODEC = "codec"
    BITSTREAM_MD5 = "bitstream_md5"


class Tracer:
    """Routes trace lines to per-category files; disabled categories are no-ops."""

    def __init__(self, prefix: str = "", enabled: set[TraceCategory] | None = None,
                 append: bool = False):
        self.prefix = prefix
        self.enabled: set[TraceCategory] = set(enabled or ())
        self._files: dict[TraceCategory, IO[str]] = {}
        # append=True keeps prior runs' lines (resumed rabbit-stream runs
        # re-open the enc_* logs without truncating the GOFs already traced)
        self._mode = "a" if append else "w"

    def enable(self, *cats: TraceCategory) -> "Tracer":
        self.enabled.update(cats)
        return self

    def is_enabled(self, cat: TraceCategory) -> bool:
        return cat in self.enabled

    def _file(self, cat: TraceCategory) -> IO[str]:
        f = self._files.get(cat)
        if f is None:
            d = os.path.dirname(self.prefix)
            if d:
                os.makedirs(d, exist_ok=True)
            f = open(f"{self.prefix}{cat.value}.txt", self._mode,
                     encoding="utf-8")
            self._files[cat] = f
        return f

    def trace(self, cat: TraceCategory, fmt: str, *args) -> None:
        if cat not in self.enabled:
            return
        f = self._file(cat)
        f.write((fmt % args if args else fmt) + "\n")
        # lines are per-GOF/frame granularity (cheap); flushing each keeps
        # the logs crash-consistent so a resumed run's appended logs cover
        # every GOF the crashed run completed
        f.flush()

    def kv(self, cat: TraceCategory, key: str, value) -> None:
        """Conformance-comparable 'key = value' line."""
        self.trace(cat, f"{key} = {value}")

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


# A module-level disabled tracer that pipelines use by default.
NULL_TRACER = Tracer()
