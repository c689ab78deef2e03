"""Device time of host-to-device copies (pageable and pinned) in the traced
window, in ms per GOF written in the window."""


def read(r):
    copies = [e for e in r.events
              if e.name.startswith("Memcpy HtoD") and r.t0 <= e.start < r.t1]
    if not copies or not r.gofs:
        return None
    return 1e3 * sum(e.end - e.start for e in copies) / len(r.gofs)
