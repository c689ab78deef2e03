"""rabbit-conformance of the PyTorch port — PccAppConformance analog: drive the trace-log
conformance comparator (PCCConformance::check)."""

from __future__ import annotations

import sys

from ..conformance.conformance import ConformanceParams, check
from .common import build_registry, parse_or_help


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = ConformanceParams()
    reg = build_registry(params)
    if parse_or_help(reg, argv, params, "rabbit-conformance") is None:
        return 0
    result = check(params)
    print(result.report())
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
