"""The share of the window's ``submit`` spans (one per plane, and per shard
of a batched round) whose device work ran in a hand-written kernel: those
that carry a ``kernel`` count (``ops/transcode.py:note_kernel``, naming
``gops`` or ``mc_intra``), in %.  The rest ran as plain PyTorch ops.  A
program that names no kernel on its spans (before ``note_kernel``) gives
nothing to read."""

from benchmark.program_spans import spans


def read(r):
    from rabbit_transcoding_tpu_torch.ops import transcode

    if not hasattr(transcode, "note_kernel"):
        return None
    submits = [s for s in spans(r) or () if s.name == "submit"]
    if not submits:
        return None
    return 100.0 * sum("kernel" in s.counts for s in submits) / len(submits)
