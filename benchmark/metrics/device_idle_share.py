"""1 - (union of all device ops' intervals) / (traced window), in
percent; the window runs from the first to the last port kernel of the
traced chunks."""


def read(run):
    t = run.trace
    if t is None or not t.complete():
        return None
    a, b = t.window()
    return 100. * (1. - t.busy(a, b) / (b - a))
