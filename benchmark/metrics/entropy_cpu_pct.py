"""The host entropy threads' CPU time over their wall time inside the
program's ``entropy_decode`` and ``entropy_encode`` spans (their copies
taken out of both), in %.  Under 100, those threads waited for the
interpreter lock or for a core."""

from benchmark.program_spans import ENTROPY, self_wall_cpu, spans


def read(r):
    got = spans(r)
    if not got:
        return None
    wall = cpu = 0.0
    for name in ENTROPY:
        w, c = self_wall_cpu(got, name, keep=("race",))
        wall, cpu = wall + w, cpu + c
    return 100.0 * cpu / wall if wall > 0 else None
