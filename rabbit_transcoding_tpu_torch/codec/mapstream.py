"""Per-map video sub-streams (reference: multipleStreams + absoluteD1 /
absoluteT1, the ctc-*-D1-from-rec-D0 / T1-from-rec-T0 conditions).

When vps_multiple_map_streams_present_flag is set, each map rides its own
GVD/AVD unit (vuh_map_index).  With vps_map_absolute_coding_enabled_flag[1]
clear, the map-1 stream codes a BIASED DELTA against the reconstructed
map 0 — the reference realises the same prediction inside its patched HM
(D1 refs the D0 recon, hm-modification PCC_ME_EXT); RBV streams carry the
residual explicitly, with identical closed-loop semantics on both sides.

Bias constants (both sides must agree; not bitstream-coded):
  geometry: 1 << (bitdepth - 4)  — depth deltas are bounded by the surface
            thickness plus quantisation error, tiny vs the depth range
  attribute: 1 << (bitdepth - 1) — color deltas are symmetric around zero
"""

from __future__ import annotations

import numpy as np


def geo_bias(bitdepth: int) -> int:
    return 1 << (bitdepth - 4)


def attr_bias(bitdepth: int) -> int:
    return 1 << (bitdepth - 1)


def make_delta(
    map1: np.ndarray, rec0: np.ndarray, bias: int, maxval: int
) -> np.ndarray:
    """map-1 content -> biased delta plane vs the reconstructed map 0."""
    return np.clip(
        map1.astype(np.int32) - rec0.astype(np.int32) + bias, 0, maxval
    ).astype(map1.dtype)


def combine_map1(
    delta: np.ndarray, rec0: np.ndarray, bias: int, maxval: int
) -> np.ndarray:
    """Reconstruct map 1 from its decoded delta plane + reconstructed map 0."""
    return np.clip(
        delta.astype(np.int32) + rec0.astype(np.int32) - bias, 0, maxval
    ).astype(delta.dtype)


def interleave_maps_np(m0: np.ndarray, m1: np.ndarray) -> np.ndarray:
    """(F, ...) x2 -> (2F, ...) frame-interleaved [m0_0, m1_0, m0_1, ...]."""
    out = np.empty((m0.shape[0] * 2,) + m0.shape[1:], m0.dtype)
    out[0::2] = m0
    out[1::2] = m1
    return out
