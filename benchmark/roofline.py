"""The least time an H100 needs for the fused GOP transcode's work.

A frozen copy of the program's count (``ops/transcode.py``:
``transcode_bound_ms`` with ``row_flops``), kept here so that the yardstick
does not move with the program: the work is counted from the coefficient
shapes and the GOPs alone, whatever implements it.  Peaks: NVIDIA's data
sheet for the H100 SXM at its 700 W limit, float32 outside the tensor cores
and HBM bandwidth; a card set below 700 W reaches less.
"""

from __future__ import annotations

import functools
import math

import numpy as np

PEAKS = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


@functools.lru_cache(maxsize=None)
def _dct16() -> np.ndarray:
    k = np.arange(16)[:, None]
    i = np.arange(16)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / 32) * np.sqrt(2.0 / 16)
    d[0] /= np.sqrt(2.0)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def row_flops() -> tuple[int, int]:
    """FLOPs of one 16-value row of a 16-term product as the codec computes
    it bit for bit: (a product with D^T, as in the IDCT; with D, as in the
    DCT).  Every output is (s0 + s1) + (s2 + s3), s_r a chain of 4 FMAs over
    the inputs k = r (mod 4); chains whose coefficient prefixes are equal up
    to sign give equal or opposite values, so each distinct prefix counts
    once: 1 FLOP for a first product, 2 for each later FMA, 1 for each
    distinct pair sum and total."""
    d = _dct16()

    def canon(seq) -> tuple:
        s = tuple(float(c) for c in seq)
        return min(s, tuple(-c for c in s))

    def count(coef) -> int:
        prods, sums = set(), set()
        for x in range(16):
            chains = [[coef(x, k) for k in range(r, 16, 4)]
                      for r in range(4)]
            for r, chain in enumerate(chains):
                prods.update((r, canon(chain[:j])) for j in range(1, 5))
            sums.update({("01", canon(chains[0] + chains[1])),
                         ("23", canon(chains[2] + chains[3])),
                         ("all", canon(sum(chains, [])))})
        firsts = sum(1 for _, p in prods if len(p) == 1)
        return 2 * len(prods) - firsts + len(sums)

    return count(lambda x, k: d[k, x]), count(lambda x, k: d[x, k])


def bound_ms(shape: tuple, gop_out: int) -> tuple[float, str]:
    """Least time for the fused transcode of int16 coefficients of
    ``shape`` ((S,) F, nby, nbx, 16, 16) -> (ms, "operations" or "bytes").
    Operations: one IDCT and one DCT per frame and one closed-loop IDCT per
    frame that a later frame of its output GOP predicts from, rows counted
    by ``row_flops``; bytes: each coefficient read once and written once."""
    f, nby, nbx = shape[-5:-2]
    blocks = math.prod(shape[:-5]) * nby * nbx
    recons = sum(1 for i in range(f - 1) if (i + 1) % gop_out)
    idct_row, dct_row = row_flops()
    flops = blocks * 2 * 16 * ((f + recons) * idct_row + f * dct_row)
    byte_ms = 2 * 2 * math.prod(shape) / PEAKS["hbm_bytes_per_s"] * 1e3
    flop_ms = flops / PEAKS["fp32_flops"] * 1e3
    return (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms,
                                                               "bytes")
