"""The observation of the frozen-surrogate GP route's chunks
(``gp_fast``), for the CPU test of a cell added as files alone; a cell of
this route copies it to ``routes/gp_fast.py``.

``Problem._run_device_multiscale`` advances each chunk through
``run_steps_gp_fast``, which on an elastic problem makes a loop with
``gapflow_torch.problem.make_gp_ehl_loop`` and calls it once,
``loop(q, u_prev, topo, dt, step, n, gp_state)``; the loop returns the
end state first, then the deformation.
"""

import gapflow_torch.problem as gp_problem


def install(rec):
    """Observe the chunks of the runs that follow with ``rec``; returns
    the uninstaller."""
    real = gp_problem.make_gp_ehl_loop

    def make(*args, **kwargs):
        loop = real(*args, **kwargs)

        def chunk(q, u_prev, topo, dt, step, n, *rest):
            return rec.call(
                lambda: loop(q, u_prev, topo, dt, step, n, *rest), q, dt, n,
                state=lambda out: out[0])

        return chunk

    def uninstall():
        gp_problem.make_gp_ehl_loop = real

    gp_problem.make_gp_ehl_loop = make
    return uninstall
