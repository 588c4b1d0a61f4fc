"""Interior cells times the steps completed in the window, over the
window's wall time: from the call of ``Problem.run()`` to its return,
the last chunk, the copy to the host and the field refresh included."""


def read(run):
    return (run.counters["cells"] * run.counters["steps"]
            / run.spans["window"])
