"""Conformance trace emission, shared by encoder and decoder.

The reference compiles TRACE_* macros into per-category logs that the
conformance checker diffs key-by-key (SURVEY.md §4.3, §5.1).  Here both
pipelines call ``emit_conformance_traces`` with their decoded state; a run
with ``--trace`` produces ``<prefix>atlas.txt`` / ``tile.txt`` /
``pcframe.txt`` / ``hls.txt`` that ``rabbit-conformance`` compares.
"""

from __future__ import annotations

from ..bitstream.hls import AtlasHLS
from ..codec.hash import atlas_patch_hash, high_level_hash
from ..core.pointset import PointSet
from ..utils.tracing import TraceCategory, Tracer


def emit_conformance_traces(
    tracer: Tracer,
    atlas: AtlasHLS,
    patch_frames: list[list],
    clouds: list[PointSet] | None = None,
    gof: int | None = None,
    atlas_id: int | None = None,
) -> None:
    """Emit the key=value conformance logs for one GOF.

    ``gof`` namespaces every key (``gof_{g}_...``) so multi-GOF runs keep a
    distinct, comparable entry per GOF — without it, the comparator's
    key=value parse keeps only the LAST GOF's values (dict overwrite) and a
    mid-sequence divergence is invisible.  Both sides of a pair must pass
    the same numbering (all apps do).  ``atlas_id`` extends the namespace
    (``gof_{g}_atlas_{a}_...``) so multi-atlas streams keep one comparable
    entry per atlas instead of the last atlas silently winning.
    """
    if not tracer.enabled:
        return
    g = "" if gof is None else f"gof_{gof}_"
    if atlas_id is not None:
        g = f"{g}atlas_{atlas_id}_"
    tracer.kv(TraceCategory.HLS, f"{g}hls_md5", high_level_hash(atlas).hex())
    tracer.kv(
        TraceCategory.HLS, f"{g}atlas_md5", atlas_patch_hash(patch_frames).hex()
    )
    asps = atlas.asps_list[0] if atlas.asps_list else None
    if asps is not None:
        tracer.kv(
            TraceCategory.ATLAS, f"{g}atlas_pixels",
            asps.asps_frame_width * asps.asps_frame_height,
        )
        tracer.kv(TraceCategory.ATLAS, f"{g}frame_width", asps.asps_frame_width)
        tracer.kv(
            TraceCategory.ATLAS, f"{g}frame_height", asps.asps_frame_height
        )
    for fi, patches in enumerate(patch_frames):
        tracer.kv(TraceCategory.ATLAS, f"{g}frame_{fi}_patch_count", len(patches))
        tiles: dict[int, int] = {}
        for p in patches:
            tiles[p.tile_index] = tiles.get(p.tile_index, 0) + 1
        for t, c in sorted(tiles.items()):
            tracer.kv(
                TraceCategory.TILE, f"{g}frame_{fi}_tile_{t}_patch_count", c
            )
    if clouds is not None:
        for fi, ps in enumerate(clouds):
            tracer.kv(
                TraceCategory.PCFRAME, f"{g}frame_{fi}_point_count",
                ps.point_count,
            )
            tracer.kv(
                TraceCategory.PCFRAME, f"{g}frame_{fi}_checksum",
                ps.compute_checksum().hex(),
            )
