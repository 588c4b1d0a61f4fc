"""Device-idle time between one traced chunk's last port kernel and the
next chunk's first, in milliseconds, averaged over those boundaries:
what the run loop's host work between two chunk calls (statistics, the
time step, the next call's statics and launch) leaves the card idle."""


def read(run):
    t = run.trace
    if t is None or not t.complete() or len(t.chunk_steps) < 2:
        return None
    gaps = t.gaps()
    return sum((b - a) - t.busy(a, b) for a, b in gaps) / len(gaps) * 1e-3
