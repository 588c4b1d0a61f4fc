"""The observation of ``Problem.run_compiled_fast``'s chunks.

Its run loop makes one loop with
``gapflow_torch.problem.make_pallas_loop`` and calls it once a chunk,
``loop(q, topo, extra, dt, n)``, which returns the chunk's end state.
:func:`install` wraps that factory: the wrapper passes every call
through :meth:`harness.Recorder.call`, which times, counts, traces and
keeps it.
"""

import gapflow_torch.problem as gp_problem


def install(rec):
    """Observe the chunks of the runs that follow with ``rec``; returns
    the uninstaller."""
    real = gp_problem.make_pallas_loop

    def make(*args, **kwargs):
        loop = real(*args, **kwargs)

        def chunk(q, topo, extra, dt, n, *rest):
            return rec.call(lambda: loop(q, topo, extra, dt, n, *rest),
                            q, dt, n)

        return chunk

    def uninstall():
        gp_problem.make_pallas_loop = real

    gp_problem.make_pallas_loop = make
    return uninstall
