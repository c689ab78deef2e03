"""Work the coefficient blob's backend race throws away: the time of the
program's ``race`` spans whose candidate lost over the time of all of them,
in %."""

from benchmark.program_spans import spans


def read(r):
    races = [s for s in spans(r) or () if s.name == "race"]
    total = sum(s.t1 - s.t0 for s in races)
    if total <= 0:
        return None
    lost = sum(s.t1 - s.t0 for s in races if not s.counts.get("won"))
    return 100.0 * lost / total
