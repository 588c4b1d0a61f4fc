"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (:mod:`reference.fv`), number by number, each
held to the limit in ``limits/<workload>.json``.

The numbers, each the worst over its parts:

- ``start_err``: the gap ``(h, dh/dx, dh/dy)`` and the initial state the
  program set up from the configuration and the seed, against the
  reference's, relative to each field's largest magnitude;
- ``dt_err``: the program's time step against the reference's CFL step,
  relative: the first one from the initial state, and that of the checked
  chunk from the state it started from (the run loop's refresh, 0.9 CFL);
- ``chunk_err``: one chunk of the run, drawn from the seed, against the
  reference's steps from the same start with its own time step: the
  largest difference on the interior, relative to the largest change the
  reference made over the chunk, the worse of the density and the mass
  flux (both components together, as one vector field).  A chunk that
  leaves its state as it was reads 1;
- ``end_residual``: the run's end state judged by the reference: the
  largest change of the density over the reference's ``residual_steps``
  steps (its own CFL step) from the state ``Problem.run()`` left on the
  host, in float32 units of the largest density (``2**-24`` of it).
  Near the steady state the window's later chunks approach, it is
  small; a run whose later chunks went astray, or that left its state
  where it began, reads far more;
- ``final_err``: the state ``Problem.run()`` left on the host against the
  last chunk's output (exact);
- ``pressure_err``: the pressure field the run refreshed at its end
  against the reference's equation of state on that state, relative to
  the largest pressure.

Chunk 0 is the warm-up chunk of the set-up, which starts from the initial
state: there the reference starts from its own state and time step.  Any
later chunk starts from the program's own state (the reference cannot
follow a whole run in the time of a run), whose start is checked by the
same numbers in the chunks before it and by ``start_err``.
"""

import sys

import numpy as np
import torch

from reference.fv import Solver, pressure

NAMES = ("start_err", "dt_err", "chunk_err", "end_residual", "final_err",
         "pressure_err")
F32_UNIT = 2. ** -24


def _rel(a, b):
    """max |a - b| / max |b|; 0 where both are 0."""
    a, b = _host(a), _host(b)
    diff = float(np.max(np.abs(a - b)))
    scale = float(np.max(np.abs(b)))
    if diff == 0.:
        return 0.
    return diff / scale if scale > 0. else float("inf")


def _host(t):
    return t.detach().to("cpu", torch.float64).numpy() \
        if torch.is_tensor(t) else np.asarray(t, np.float64)


def residual(ref, q, steps):
    """The largest change of the density over ``steps`` of the reference
    from ``q`` (ghost-inclusive, host), with its own CFL step (the run
    loop's 0.9 of it), in float32 units of the largest density."""
    q = _host(q)
    moved = _host(ref.run(q, ref.dt(ref.tensor(q), factor=0.9), steps)[0])
    inner = (slice(1, -1), slice(1, -1))
    return float(np.max(np.abs(moved[inner] - q[0][inner]))
                 / (F32_UNIT * np.max(np.abs(q[0][inner]))))


def numbers(cfg, traffic, rho0, prog, device="cpu"):
    """The compared numbers of one run.

    ``rho0``: the initial density handed to both sides; ``cfg``: the
    configuration with the run's grid and surface seed (the program's
    input sections); ``prog``: what the program produced: ``topo`` (3
    channels), ``q0``, ``dt0``, ``chunk`` = ``(index, q_in, q_out, dt,
    n)``, ``final`` (host state after the run), ``last`` (the last
    chunk's output), ``pressure``.  The reference runs in float64 on
    ``device``."""
    nx, ny = traffic["Nx"], traffic["Ny"]
    ref = Solver(cfg, nx, ny, device=device)
    topo = ref.gap()
    q0 = ref.initial_state(rho0)
    out = {}
    out["start_err"] = max(
        max(_rel(p, r) for p, r in zip(_host(prog["topo"]), topo)),
        max(_rel(p, r) for p, r in zip(_host(prog["q0"]), q0)))

    ref.set_gap(topo)
    index, q_in, q_out, dt, n = prog["chunk"]
    dt0 = ref.dt(ref.tensor(q0))
    if index == 0:
        start, dt_ref = q0, dt0
    else:
        start = _host(q_in)
        dt_ref = ref.dt(ref.tensor(start), factor=0.9)
    out["dt_err"] = max(abs(prog["dt0"] - dt0) / dt0,
                        abs(dt - dt_ref) / dt_ref)

    if n < 1:
        out["chunk_err"] = float("inf")
    else:
        q_ref = _host(ref.run(start, dt_ref, n))
        q_prog = _host(q_out)
        inner = (slice(None), slice(1, -1), slice(1, -1))
        start, q_ref, q_prog = start[inner], q_ref[inner], q_prog[inner]
        parts = [_rel(q_prog[g] - start[g], q_ref[g] - start[g])
                 for g in (slice(0, 1), slice(1, 3))]
        out["chunk_err"] = max(parts)
        print(f"check: chunk {index} ({n} steps): density {parts[0]!r}, "
              f"mass flux {parts[1]!r}", file=sys.stderr)

    final = _host(prog["final"])
    out["end_residual"] = residual(ref, final, traffic["residual_steps"])
    out["final_err"] = float(np.max(np.abs(final - _host(prog["last"]))))
    p_ref = _host(pressure(ref.tensor(final[0]), cfg["properties"]))
    out["pressure_err"] = _rel(prog["pressure"], p_ref)
    return out


def verdict(values, limits):
    """``(correct, checks)``: every number finite and at or below its
    limit; ``checks`` maps each name to ``{"value", "limit"}``."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
