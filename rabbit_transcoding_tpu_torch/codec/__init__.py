"""Host codec helpers, copied from the reference package: map-pair deltas,
patch-frame decoding and the decoded-atlas hash SEI."""
