"""The least time the card needs for a step's work, over the device time
the port's kernels took for it (``sweep_us_per_step``), in percent.

The least time is the larger of the step's operations over the float32
peak and its bytes over the HBM peak (``peaks.json``), both counted from
the equations and the shapes, not from a kernel's source, so that the
count does not depend on how a kernel does the work:

- operations: :func:`least_ops`, per interior cell and step, each add,
  multiply, divide, minimum, square root and exponential one operation
  and a multiply-add two (as the peak counts them), common factors
  formed once.  The Kahan two-sum of the compensated sweeps is not
  counted: it compensates the rounding of float32 increments, the
  equations have no such term, and a float64 program would need none.
  The ghost fills (a copy, or one operation a Dirichlet edge cell) are
  left out: a few thousand edge cells against 4 million;
- bytes: per chunk call, the state ``(rho, jx, jy)`` and the statics
  ``(h, dh/dx, dh/dy)`` read once and the state written once, float32:
  36 bytes a cell for the whole chunk.
"""

# Operations of one MacCormack pass per cell, with no slip, no bulk
# viscosity and a constant viscosity (Newtonian wall and gap-averaged
# stresses, all proportional to a = eta / (h rho)):
PASS_OPS = {
    # a = eta / (h rho): 2; U rho, V rho: 2; hx jx, hy jy, hx jy, hy jx,
    # U rho hx, V rho hy, U rho hy, V rho hx: 8
    "closure factors": 12,
    # gap-averaged xx = 4/3 a (hx jx - hy jy / 2), yy likewise: 4 + 4;
    # xy = a (hx jy + hy jx): 2
    "gap-averaged stress": 10,
    # top wall xx = -8 a (U rho hx / 3 - V rho hy / 6 - hx jx + hy jy / 2)
    # and yy likewise: 8 + 8; xy = -2 a (U rho hy + V rho hx
    # - 3 (hx jy + hy jx)): 5
    "top wall stress": 21,
    # top minus bottom wall shear, xz = 6 a (U rho - 2 jx), yz likewise
    "wall shear difference": 8,
    # p + tau_xx, p + tau_yy
    "fluxes": 2,
    # one-sided differences of 3 components along x and y, times 1/dx,
    # 1/dy
    "flux differences": 12,
    # 1/h: 1; -(hx jx + hy jy) / h: 2; the two momentum sources: 7 + 6
    "source": 16,
    # per component: sum of the two directions, minus the source, times
    # dt, subtracted from q
    "update": 12,
}

# Operations of the equation of state p(rho) per cell.
EOS_OPS = {
    # min(rho, 0.99 C2 rho0), r = rho / rho0, r - 1, C2 - r, C1 (r - 1),
    # the division, + P0
    "DH": 7,
    # sum_0^8 c_k rho^(k+1) by Horner: 8 multiply-adds and a multiply
    # (17); rho^2 (1); sum_0^5 d_k rho^(2k) by Horner (10); rho^3 (1);
    # exp(-gamma rho^2) (2); the two products (2); the sum (1)
    "BWR": 34,
}

# (q + q_start) / 2 of the three components
AVERAGE_OPS = 6

BYTES_PER_CELL_CHUNK = 4 * (3 + 3 + 3)


def least_ops(prop):
    """Float32 operations per interior cell and step of the configuration
    ``prop`` (its ``properties`` section)."""
    for key in ("piezo", "thinning", "elastic"):
        if prop.get(key) and prop[key].get("enabled", True):
            raise NotImplementedError(f"no count for properties: {key}")
    if prop.get("bulk", 0.) != 0.:
        raise NotImplementedError("no count for a bulk viscosity")
    return 2 * (EOS_OPS[prop["EOS"]] + sum(PASS_OPS.values())) + AVERAGE_OPS


def least_seconds_per_step(prop, cells, steps_per_chunk, peak):
    """The least time a step needs on a card of ``peak`` (a
    ``peaks.json`` entry): (seconds, "operations" or "bytes")."""
    t_ops = least_ops(prop) * cells / peak["fp32_flops_per_s"]
    t_bytes = (BYTES_PER_CELL_CHUNK * cells / steps_per_chunk
               / peak["hbm_bytes_per_s"])
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_peak(run):
    for key, peak in run.peaks["cards"].items():
        if key in run.device_kind:
            return peak
    return None


def read(run):
    t = run.trace
    peak = card_peak(run)
    if t is None or not t.complete() or peak is None:
        return None
    steps = sum(t.chunk_steps)
    kernel_s = sum(op["dur"] for op in t.chunk_kernels()) * 1e-6 / steps
    least, _ = least_seconds_per_step(
        run.config["properties"], run.counters["cells"],
        steps / len(t.chunk_steps), peak)
    return 100. * least / kernel_s
