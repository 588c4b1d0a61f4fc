"""Mixed per-component P/D/N edges: ghost-line bands, kernel K4, driver.

Counterpart of :mod:`gapflow_tpu.ops.mixed_bc`, whose docstring has the
design.  In short: the reference ghost fill overwrites only the
Dirichlet/Neumann components of an edge, so the periodic component of a
mixed edge keeps whatever the pass arithmetic (``torch.roll`` over the
ghost-inclusive array) produced.  Those ghosts are state, and the driver
carries the full ghost-inclusive field.

Per step:

- the ghost lines evolve in plain torch on narrow bands (six full-width
  rows / six full-height columns) that reproduce the reference's
  roll-wrap arithmetic exactly (:func:`_band_step`, O(perimeter));
- the interior update is kernel K4, :func:`mixed_step` (CUDA,
  ``gf_mixed_step`` in ``csrc/stencil_bc.cu``: the boundary kernel's
  body reading the ghost-inclusive input, whose between-pass refill puts
  the bands' pass-1 lines on the mixed edges' periodic components).

Shear thinning is excluded, as in the JAX package: its viscosity couples
interior cells to the evolved ghost lines through the one-sided gradient.
"""

import numpy as np
import torch

from . import _build
from .stencil import (LAUNCHES, _bc_params, _check_tensors, _edge_mixed,
                      _kernel_params, _on_cpu, ghost_statics,
                      step_ghosted_ref)
from ..core.integrate import diffusiveFlux, hyperbolicFlux, source
from ..core.step import _edge_fill, apply_bcs, det_closures, mc_directions
from ..models.eos import true_div

# band-local neighbour tables for lines [g, e0, e1, t2, t1, g'] taken from
# indices [0, 1, 2, n-1, n, n+1] of an (n+2)-long periodic axis: prev =
# index-1 (wraps g <- g'), next = index+1; -1 marks a neighbour outside
# the band (that line's flux difference is garbage and never consumed)
_PREV = (5, 0, 1, -1, 3, 4)
_NEXT = (1, 2, -1, 4, 5, 0)


def mixed_supported(cfg, ny, nx=None):
    """Kernel coverage for mixed per-component P/D/N edges: a static pass
    order, at least one mixed edge and no shear thinning.  The band lines
    must stay distinct (``nx``, ``ny`` >= 6); no width alignment is
    needed.  The config sanitizer guarantees P masks match on opposite
    edges."""
    if cfg.MC_order == 0 or cfg.thinning is not None:
        return False
    if not (_edge_mixed(cfg, 0) or _edge_mixed(cfg, 2)):
        return False
    return ny >= 6 and (nx is None or nx >= 6)


# ---------------------------------------------------------------------------
# Ghost-line bands (plain torch, reference-exact)
# ---------------------------------------------------------------------------

def _fill_vals(bc, adj, ghost):
    """Per-component ghost fill: D/N formulas, P keeps ``ghost``."""
    rows = []
    for c in range(3):
        if bc["D"][c]:
            rows.append(2. * bc["val"] - adj[c])
        elif bc["N"][c]:
            rows.append(adj[c])
        else:
            rows.append(ghost[c])
    return torch.stack(rows)


def _refill_band(cfg, qb, axis):
    """apply_bcs restricted to a band (x edges first, then y)."""
    qb = qb.clone()
    bc_xE, bc_xW = cfg.bc_edge(0), cfg.bc_edge(1)
    bc_yS, bc_yN = cfg.bc_edge(2), cfg.bc_edge(3)
    if axis == 1:
        # x band (3, 6, ny+2): x ghosts are band rows 0/5, adj rows 1/4
        if all(bc_xE["P"]):
            qb[:, 0] = qb[:, 4]
            qb[:, 5] = qb[:, 1]
        else:
            qb[:, 0] = _fill_vals(bc_xE, qb[:, 1], qb[:, 0])
            qb[:, 5] = _fill_vals(bc_xW, qb[:, 4], qb[:, 5])
        # y ghosts are the full-width edge columns
        if all(bc_yS["P"]):
            qb[:, :, 0] = qb[:, :, -2]
            qb[:, :, -1] = qb[:, :, 1]
        else:
            qb[:, :, 0] = _fill_vals(bc_yS, qb[:, :, 1], qb[:, :, 0])
            qb[:, :, -1] = _fill_vals(bc_yN, qb[:, :, -2], qb[:, :, -1])
    else:
        # y band (3, nx+2, 6): x ghosts are the full-height edge rows
        if all(bc_xE["P"]):
            qb[:, 0] = qb[:, -2]
            qb[:, -1] = qb[:, 1]
        else:
            qb[:, 0] = _fill_vals(bc_xE, qb[:, 1], qb[:, 0])
            qb[:, -1] = _fill_vals(bc_xW, qb[:, -2], qb[:, -1])
        # y ghosts are band cols 0/5, adj cols 1/4
        if all(bc_yS["P"]):
            qb[:, :, 0] = qb[:, :, 4]
            qb[:, :, 5] = qb[:, :, 1]
        else:
            qb[:, :, 0] = _fill_vals(bc_yS, qb[:, :, 1], qb[:, :, 0])
            qb[:, :, 5] = _fill_vals(bc_yN, qb[:, :, 4], qb[:, :, 5])
    return qb


def _pass_band(cfg, qb, tb, eb, dt, d, axis):
    """One MacCormack pass of the reference step on a band.

    ``axis`` = 1: x band, the neighbour table along the band rows and
    ``torch.roll`` (reference-exact, wraps the array edge) along the full
    width.  ``axis`` = 2: y band, roles transposed.  Lines whose table
    neighbour is outside the band (-1) come out garbage and are never
    consumed.
    """
    p, tau, s_lo, s_up = det_closures(cfg, qb, tb, eb)
    FxH, FyH = hyperbolicFlux(qb, p)
    FxD, FyD = diffusiveFlux(qb, tau)
    Fx, Fy = FxH + FxD, FyH + FyD

    nbr = _PREV if d == 1 else _NEXT
    if axis == 1:
        Fn = torch.stack([Fx[:, (j if j >= 0 else r)]
                          for r, j in enumerate(nbr)], dim=1)
        flux_x = -d * (Fn - Fx)
        flux_y = -d * (torch.roll(Fy, d, dims=2) - Fy)
    else:
        Fn = torch.stack([Fy[:, :, (j if j >= 0 else r)]
                          for r, j in enumerate(nbr)], dim=2)
        flux_y = -d * (Fn - Fy)
        flux_x = -d * (torch.roll(Fx, d, dims=1) - Fx)

    src = source(qb, tb, tau, s_lo, s_up)
    return qb - dt * (true_div(flux_x, cfg.dx) + true_div(flux_y, cfg.dy)
                      - src)


def _band_step(cfg, qb, tb, eb, dt, axis):
    """Both passes with refills; returns (pass-1 band, pass-2 band)."""
    d0, d1 = mc_directions(cfg.MC_order)
    qb1 = _refill_band(cfg, _pass_band(cfg, qb, tb, eb, dt, d0, axis), axis)
    qb2 = _refill_band(cfg, _pass_band(cfg, qb1, tb, eb, dt, d1, axis), axis)
    return qb1, qb2


def _band_idx(n):
    return [0, 1, 2, n - 1, n, n + 1]


# ---------------------------------------------------------------------------
# Kernel K4 and its twin
# ---------------------------------------------------------------------------

def _refill_mixed(q, cfg, gx, gy):
    """apply_bcs, except that a mixed edge's periodic components take the
    given pass-1 ghost lines (``gx`` (3, 2, ny+2): xE/xW rows; ``gy``
    (3, 2, nx+2): yS/yN columns), in the same fill order."""
    q = q.clone()
    for e, (axis, side) in enumerate(((1, "lo"), (1, "hi"),
                                      (2, "lo"), (2, "hi"))):
        _edge_fill(q, cfg, e, axis, side)
        if not _edge_mixed(cfg, e):
            continue
        idx = 0 if side == "lo" else -1
        for c in range(3):
            if cfg.bc_edge(e)["P"][c]:
                if axis == 1:
                    q[c, idx, :] = gx[c, e]
                else:
                    q[c, :, idx] = gy[c, e - 2]
    return q


def mixed_step_ref(q_g, statics_g, gx, gy, dt, cfg, emit_delta=False):
    """Plain torch twin of :func:`mixed_step`."""
    return step_ghosted_ref(q_g, statics_g, dt, cfg,
                            lambda q: _refill_mixed(q, cfg, gx, gy),
                            emit_delta)


def mixed_step(q_g, statics_g, gx, gy, dt, cfg, emit_delta=False):
    """Interior update of one mixed-edge step (kernel K4).

    ``q_g``: (3, nx+2, ny+2) carried state, ghosts included (pass 1 reads
    them as given); ``statics_g``: (8, nx+2, ny+2); ``gx`` (3, 2, ny+2)
    and ``gy`` (3, 2, nx+2): the bands' pass-1 ghost lines, read for the
    periodic components of mixed edges.  Returns the interior (3, nx, ny)
    new state or, with ``emit_delta``, its increment.  CUDA tensors
    (float32) launch the kernel; CPU tensors run :func:`mixed_step_ref`.
    """
    if _on_cpu(q_g):
        return mixed_step_ref(q_g, statics_g, gx, gy, dt, cfg, emit_delta)
    nx, ny = q_g.shape[1] - 2, q_g.shape[2] - 2
    if not mixed_supported(cfg, ny, nx):
        raise ValueError("the mixed-edge kernel does not cover this "
                         "configuration (see mixed_supported)")
    _check_tensors(q_g, (q_g, (3, nx + 2, ny + 2)),
                   (statics_g, (8, nx + 2, ny + 2)), (gx, (3, 2, ny + 2)),
                   (gy, (3, 2, nx + 2)))
    iprm, fprm = _kernel_params(cfg)
    bprm, bfprm = _bc_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty((3, nx, ny), dtype=q_g.dtype, device=q_g.device)
    lib = _build.load()
    with torch.cuda.device(q_g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_mixed_step(q_g.data_ptr(), statics_g.data_ptr(),
                               gx.data_ptr(), gy.data_ptr(), out.data_ptr(),
                               nx, ny, d0, int(emit_delta), iprm.ctypes.data,
                               fprm.ctypes.data, bprm.ctypes.data,
                               bfprm.ctypes.data, float(dt), stream)
    _build.check(lib, rc, "gf_mixed_step")
    LAUNCHES["mixed_step"] += 1
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _lo_mask(cfg, nx, ny):
    """Positions whose value survives apply_bcs un-overwritten, where a
    compensation term accumulates across steps."""
    P_x = cfg.bc_edge(0)["P"]
    P_y = cfg.bc_edge(2)["P"]
    x_mixed, y_mixed = _edge_mixed(cfg, 0), _edge_mixed(cfg, 2)
    m = np.zeros((3, nx + 2, ny + 2), np.float32)
    m[:, 1:-1, 1:-1] = 1.
    for c in range(3):
        if x_mixed and P_x[c]:
            m[c, 0, 1:-1] = m[c, -1, 1:-1] = 1.
        if y_mixed and P_y[c]:
            m[c, 1:-1, 0] = m[c, 1:-1, -1] = 1.
        if x_mixed and y_mixed and P_x[c] and P_y[c]:
            m[c, 0, 0] = m[c, 0, -1] = m[c, -1, 0] = m[c, -1, -1] = 1.
    return m


def make_mixed_loop(cfg, nx, ny, dtype=torch.float32, compensated=False,
                    step_fn=mixed_step):
    """n-step driver for mixed-edge problems.

    ``loop(q, topo, extra, dt, n_steps) -> q`` on ghost-inclusive arrays
    (the surface of :func:`ops.stencil.make_pallas_loop`).  The carried
    state is the full ghost-inclusive field.  ``compensated``
    Kahan-accumulates the per-step increments: the kernel emits the
    interior increment, the bands the frame's, and the carry two-sums
    both, masked to the positions that accumulate (:func:`_lo_mask`).
    ``step_fn`` is the interior update, :func:`mixed_step`; passing
    :func:`mixed_step_ref` runs the whole loop on the plain twin, which
    is how the kernel's loop is checked on the card.
    """
    if not mixed_supported(cfg, ny, nx):
        raise ValueError("the mixed-edge kernel does not cover this "
                         "configuration (see mixed_supported)")
    x_mixed, y_mixed = _edge_mixed(cfg, 0), _edge_mixed(cfg, 2)
    ridx, cidx = _band_idx(nx), _band_idx(ny)

    def loop(q, topo, extra, dt, n_steps):
        q_g = apply_bcs(torch.as_tensor(q).to(dtype), cfg)
        dev = q_g.device
        topo = torch.as_tensor(topo, device=dev).to(dtype)
        extra = torch.as_tensor(extra, device=dev).to(dtype)
        st_g = ghost_statics(topo, extra, dtype, dev)
        dt = float(dt)
        tb_x, eb_x = topo[:, ridx, :], extra[:, ridx, :]
        tb_y, eb_y = topo[:, :, cidx], extra[:, :, cidx]
        gx0 = q_g.new_zeros((3, 2, ny + 2))
        gy0 = q_g.new_zeros((3, 2, nx + 2))

        def frame(q_g, emit_delta):
            """Band evolution: the kernel's side inputs and the new ghost
            lines (or their increments)."""
            gx, gy, rows, cols = gx0, gy0, None, None
            sign = -1. if emit_delta else 1.
            if x_mixed:
                qb1, qb2 = _band_step(cfg, q_g[:, ridx, :], tb_x, eb_x, dt, 1)
                gx = qb1[:, [0, 5]].contiguous()
                rows = (qb2[:, [0, 5]] + sign * q_g[:, [0, -1]]) / 2.
            if y_mixed:
                qb1, qb2 = _band_step(cfg, q_g[:, :, cidx], tb_y, eb_y, dt, 2)
                gy = qb1[:, :, [0, 5]].transpose(1, 2).contiguous()
                cols = (qb2[:, :, [0, 5]] + sign * q_g[:, :, [0, -1]]) / 2.
            return gx, gy, rows, cols

        def assemble(q_int, rows, cols):
            out = torch.zeros_like(q_g)
            out[:, 1:-1, 1:-1] = q_int
            if y_mixed:
                out[:, :, 0] = cols[:, :, 0]
                out[:, :, -1] = cols[:, :, 1]
            if x_mixed:
                out[:, 0] = rows[:, 0]
                out[:, -1] = rows[:, 1]
            return out

        if not compensated:
            for _ in range(n_steps):
                gx, gy, rows, cols = frame(q_g, False)
                q_int = step_fn(q_g, st_g, gx, gy, dt, cfg)
                q_g = apply_bcs(assemble(q_int, rows, cols), cfg)
            return q_g

        mask = torch.as_tensor(_lo_mask(cfg, nx, ny), dtype=dtype, device=dev)
        lo = torch.zeros_like(q_g)
        for _ in range(n_steps):
            gx, gy, rows, cols = frame(q_g, True)
            delta = step_fn(q_g, st_g, gx, gy, dt, cfg, emit_delta=True)
            y = assemble(delta, rows, cols) + lo
            t = q_g + y
            q_g, lo = apply_bcs(t, cfg), (y - (t - q_g)) * mask
        return q_g

    return loop
