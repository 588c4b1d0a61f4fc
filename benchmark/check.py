"""The comparison that decides ``correct``: what the timed path produced
against the configuration's plain reference, number by number, each held
to the limit in ``limits/<workload>.json``.

A configuration's ``reference`` names the reference's file; the numbers
come from the file beside it named ``<reference>_check.py`` (for
``reference/fv.py``, :mod:`reference.fv_check`), which gives ``NAMES``
and ``numbers(cfg, traffic, rho0, prog, device)``.  :func:`verdict`
holds the numbers that the limits file lists.  What is shared by the
comparisons is here: the relative gap, the copy to the host and the
reference's residual.
"""

from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
F32_UNIT = 2. ** -24


def rel(a, b):
    """max |a - b| / max |b|; 0 where both are 0."""
    a, b = host(a), host(b)
    diff = float(np.max(np.abs(a - b)))
    scale = float(np.max(np.abs(b)))
    if diff == 0.:
        return 0.
    return diff / scale if scale > 0. else float("inf")


def host(t):
    return t.detach().to("cpu", torch.float64).numpy() \
        if torch.is_tensor(t) else np.asarray(t, np.float64)


def residual(ref, q, steps):
    """The largest change of the density over ``steps`` of the reference
    ``ref`` from ``q`` (ghost-inclusive, host), with its own CFL step (the
    run loop's 0.9 of it), in float32 units of the largest density."""
    q = host(q)
    moved = host(ref.run(q, ref.dt(ref.tensor(q), factor=0.9), steps)[0])
    inner = (slice(1, -1), slice(1, -1))
    return float(np.max(np.abs(moved[inner] - q[0][inner]))
                 / (F32_UNIT * np.max(np.abs(q[0][inner]))))


def comparison(cfg, root=ROOT):
    """The comparison module of the configuration's ``reference``."""
    from harness import load_module
    ref = root / cfg["reference"]
    return load_module(ref.with_name(f"{ref.stem}_check.py"),
                       f"check_{ref.stem}")


def numbers(cfg, traffic, rho0, prog, device="cpu", root=ROOT):
    """The compared numbers of one run, by the comparison of the
    configuration's reference (its ``numbers``; ``prog`` is what the
    program produced, see :func:`harness.measure`)."""
    return comparison(cfg, root).numbers(cfg, traffic, rho0, prog,
                                         device=device)


def verdict(values, limits):
    """``(correct, checks)``: every number the limits list finite and at
    or below its limit; ``checks`` maps each of them, in the limits'
    order, to ``{"value", "limit"}``.  A number the limits do not list is
    an error of the cell's files."""
    extra = sorted(set(values) - set(limits))
    if extra:
        raise KeyError(f"no limit for {', '.join(extra)}")
    checks = {k: {"value": values.get(k, float("nan")), "limit": v}
              for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
