"""The median interval between two chunk calls of the window on the
host's clock, in milliseconds: one chunk's sweeps and the run loop's work
around them (statistics, time step, the next call's statics and launch),
steadier than the window's rate, whose end holds the run's host tail."""

import statistics


def read(run):
    if len(run.calls) < 3:
        return None
    return 1e3 * statistics.median(b - a for a, b in
                                   zip(run.calls, run.calls[1:]))
