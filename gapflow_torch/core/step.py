"""The deterministic MacCormack solver step in plain torch.

Builds step functions from a static :class:`SolverConfig`:

- ``make_pass_fn``:    one MacCormack pass with closures supplied from
                       outside (the per-step GP driver)
- ``make_det_step``:   the full deterministic timestep: constitutive models,
                       two alternating one-sided passes, ghost fills,
                       temporal average, validity check with rollback,
                       residual and adaptive dt
- ``make_trajectory``: ``n`` steps, stacking (q, simtime) after each
- ``make_run_loop``:   steps until convergence or max_it

Counterpart of :mod:`gapflow_tpu.core.step`, which is the specification:
the same scheme, ghost-cell handling (one ghost cell, midpoint weight
a1 = 0.5) and pass order.  ``lax.while_loop``/``lax.scan`` become Python
loops.  The step itself stays free of host synchronisation: rollback and
bookkeeping are selected with ``torch.where`` on the validity flag.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .integrate import predictor_corrector, source
from ..models.eos import eos_pressure, eos_sound_velocity, true_div
from ..models.viscosity import (piezoviscosity, shear_thinning_factor,
                                shear_rate_avg)
from ..models.viscous import stress_bottom, stress_top, stress_avg


@dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable)."""

    dx: float
    dy: float
    U: float
    V: float
    shear: float
    bulk: float
    eos: Tuple[Tuple[str, float], ...]       # prop dict items for the EOS
    piezo: Optional[Tuple[Tuple[str, object], ...]] = None
    thinning: Optional[Tuple[Tuple[str, object], ...]] = None
    MC_order: int = 1
    adaptive: bool = False
    CFL: float = 0.5
    # BC masks: per-edge tuples of 3 bools; D values are scalars
    bc: Tuple = ()

    @staticmethod
    def from_dicts(grid, geo, prop, numerics):
        eos_keys = [k for k, v in prop.items()
                    if not isinstance(v, dict) and k not in ("shear", "bulk")]
        eos = tuple((k, prop[k]) for k in ["EOS"] + [k for k in eos_keys if k != "EOS"])
        piezo = tuple(prop["piezo"].items()) if "piezo" in prop else None
        thinning = tuple(prop["thinning"].items()) if "thinning" in prop else None
        # Dirichlet VALUES come from the OPPOSITE edge: the reference's
        # ghost fill writes the low-x ghost with the xE masks but computes
        # it from bc_xW_D_val (and vice versa; same for y), i.e. xE_D lands
        # on the HIGH-x boundary.  Masks must match on opposite edges, so
        # swapping only the value reproduces its net semantics exactly.
        _opposite = {"xE": "xW", "xW": "xE", "yS": "yN", "yN": "yS"}
        bc = []
        for edge in ("xE", "xW", "yS", "yN"):
            entry = {kind: tuple(grid[f"bc_{edge}_{kind}"]) for kind in "PDN"}
            entry["val"] = grid.get(f"bc_{_opposite[edge]}_D_val", 0.0)
            bc.append(tuple(sorted(entry.items())))
        return SolverConfig(
            dx=grid["dx"], dy=grid["dy"], U=geo["U"], V=geo["V"],
            shear=prop["shear"], bulk=prop["bulk"], eos=eos,
            piezo=piezo, thinning=thinning,
            MC_order=numerics["MC_order"], adaptive=bool(numerics["adaptive"]),
            CFL=numerics["CFL"],
            bc=tuple(bc),
        )

    # -- dict views ---------------------------------------------------------
    @property
    def prop(self):
        d = dict(self.eos)
        d["shear"] = self.shear
        d["bulk"] = self.bulk
        if self.piezo is not None:
            d["piezo"] = dict(self.piezo)
        if self.thinning is not None:
            d["thinning"] = dict(self.thinning)
        return d

    def bc_edge(self, i):
        return dict(self.bc[i])


# ---------------------------------------------------------------------------
# Ghost-cell boundary fill
# ---------------------------------------------------------------------------

def _edge_fill(q, cfg, edge_idx, axis, side):
    """Fill one ghost edge of ``q`` in place from its P/D/N component masks.

    SolverConfig.from_dicts pre-swaps the Dirichlet values between opposite
    edges, so here mask and value are read from the same entry.

    Ghost formula (one ghost cell, midpoint weight a1 = 0.5):
      Dirichlet: Q = 2*q_target - q_adjacent
      Neumann:   Q = q_adjacent
    """
    bc = cfg.bc_edge(edge_idx)
    dst = 0 if side == "lo" else -1
    qa = q if axis == 1 else q.transpose(1, 2)   # view: edges along dim 1
    if all(bc["P"]):
        qa[:, dst] = qa[:, -2 if side == "lo" else 1]
        return
    adj = 1 if side == "lo" else -2
    for c in range(3):
        if bc["D"][c]:
            qa[c, dst] = 2. * bc["val"] - qa[c, adj]
        elif bc["N"][c]:
            qa[c, dst] = qa[c, adj]


def apply_bcs(q, cfg):
    """Fill all four ghost edges (x-low, x-high, y-low, y-high, in order).

    Returns a new tensor; ``q`` is left as it was."""
    q = q.clone()
    _edge_fill(q, cfg, 0, axis=1, side="lo")   # left edge, xE spec
    _edge_fill(q, cfg, 1, axis=1, side="hi")   # right edge, xW spec
    _edge_fill(q, cfg, 2, axis=2, side="lo")   # bottom edge, yS spec
    _edge_fill(q, cfg, 3, axis=2, side="hi")   # top edge, yN spec
    return q


def mc_directions(mc_order):
    """Static MacCormack pass order (d0, d1) for mc_order in (-1, +1).

    mc_order == 0 alternates by step parity: even steps run
    mc_directions(+1), odd steps mc_directions(-1)."""
    return [(-1, 1), (1, -1)][(mc_order + 1) // 2]


# ---------------------------------------------------------------------------
# Constitutive closures (deterministic path)
# ---------------------------------------------------------------------------

def effective_viscosity(cfg, rho, p, h):
    """Shear viscosity after piezoviscous and shear-thinning corrections,
    from the density ``rho`` and the pressure ``p`` of the same cells."""
    prop = cfg.prop
    if cfg.piezo is not None:
        arg = rho if prop["EOS"] == "Bayada" else p
        mu0 = piezoviscosity(arg, cfg.shear, prop["piezo"])
    else:
        mu0 = cfg.shear

    if cfg.thinning is not None:
        dp_dx = torch.gradient(p, spacing=cfg.dx, dim=0)[0]
        dp_dy = torch.gradient(p, spacing=cfg.dy, dim=1)[0]
        rate = shear_rate_avg(dp_dx, dp_dy, h, cfg.U, cfg.V, mu0)
        return mu0 * shear_thinning_factor(rate, mu0, prop["thinning"])
    return mu0


def det_closures(cfg, q, topo, extra):
    """Pressure, wall and bulk stresses of the deterministic model.

    Returns (p, tau_bulk(3,), s_lower(6,), s_upper(6,)).  The slip length is
    the extra field (zero by default).
    """
    prop = cfg.prop
    h3 = topo[:3]
    p = eos_pressure(q[0], prop)
    eta = effective_viscosity(cfg, q[0], p, h3[0])
    Ls = extra

    s_lower = stress_bottom(q, h3, cfg.U, cfg.V, eta, cfg.bulk, Ls)
    s_upper = stress_top(q, h3, cfg.U, cfg.V, eta, cfg.bulk, Ls)
    tau_bulk = stress_avg(q, h3, cfg.U, cfg.V, eta, cfg.bulk, Ls)
    return p, tau_bulk, s_lower, s_upper


# ---------------------------------------------------------------------------
# MacCormack passes and steps
# ---------------------------------------------------------------------------

def make_pass_fn(cfg):
    """One MacCormack pass with externally supplied closure fields (the
    per-step GP driver re-predicts between passes).

    ``pass_fn(q, topo, p, tau_bulk, s_lower, s_upper, dt, direction)``
    advances q by one one-sided Euler update and refills the ghost cells.
    """
    def pass_fn(q, topo, p, tau_bulk, s_lower, s_upper, dt, direction):
        fX, fY = predictor_corrector(q, p, tau_bulk, direction)
        src = source(q, topo, tau_bulk, s_lower, s_upper)
        q = q - dt * (true_div(fX, cfg.dx) + true_div(fY, cfg.dy) - src)
        return apply_bcs(q, cfg)

    return pass_fn


def kinetic_energy(q):
    return torch.sum((q[1] ** 2 + q[2] ** 2) / q[0] / 2.)


def v_max(q):
    return torch.sqrt((q[1] ** 2 + q[2] ** 2) / q[0]).max()


def make_det_step(cfg, with_aux=True):
    """The full deterministic timestep.

    ``det_step(state) -> (state, aux)`` where aux holds the last-pass
    closure fields (pressure, wall/bulk stresses) for I/O.  On NaN or
    negative density the state is rolled back to the pre-step state with
    ``valid`` set False.
    """
    prop = cfg.prop

    def one_pass(q, topo, extra, dt, d):
        p, tau_bulk, s_lo, s_up = det_closures(cfg, q, topo, extra)
        fX, fY = predictor_corrector(q, p, tau_bulk, d)
        src = source(q, topo, tau_bulk, s_lo, s_up)
        q = q - dt * (true_div(fX, cfg.dx) + true_div(fY, cfg.dy) - src)
        return apply_bcs(q, cfg), (p, tau_bulk, s_lo, s_up)

    def det_step(state):
        q0 = state.q
        topo, extra, dt = state.topo, state.extra, state.dt

        if cfg.MC_order != 0:
            d0, d1 = mc_directions(cfg.MC_order)
        else:
            d0, d1 = mc_directions(1 if int(state.step) % 2 == 0 else -1)
        q, _ = one_pass(q0, topo, extra, dt, d0)
        q, aux = one_pass(q, topo, extra, dt, d1)

        # second-order temporal average
        q = (q + q0) / 2.
        valid = ~torch.isnan(q).any() & ~(q[0] < 0.).any()
        q = apply_bcs(q, cfg)

        ekin = kinetic_energy(q)
        c_max = eos_sound_velocity(q[0], prop).max()
        dt_crit = min(cfg.dx, cfg.dy) / (v_max(q) + c_max)
        cfl = dt / dt_crit
        # zero-guard: static/squeeze setups (U=V=0) start at ekin=0
        residual = (torch.abs(ekin - state.ekin_old)
                    / state.ekin_old.clamp(min=1e-300) / cfl)
        new_dt = cfg.CFL * dt_crit if cfg.adaptive else dt
        post = state._replace(
            q=q,
            dt=new_dt,
            step=state.step + 1,
            simtime=state.simtime + dt,
            ekin_old=ekin,
            residual=residual,
            residual_buffer=torch.cat([residual[None],
                                       state.residual_buffer[:-1]]),
        )
        # rollback keeps the pre-step state, flagged invalid
        new_state = type(state)(
            *(torch.where(valid, a, b) for a, b in zip(post[:-1], state[:-1])),
            valid)
        if with_aux:
            return new_state, aux
        return new_state

    return det_step


def make_trajectory(cfg, n):
    """``run(state) -> (state, (qs, times))``: ``n`` deterministic steps,
    stacking (q, simtime) after each along a leading axis."""
    det_step = make_det_step(cfg, with_aux=False)

    def run(state):
        qs, times = [], []
        for _ in range(n):
            state = det_step(state)
            qs.append(state.q)
            times.append(state.simtime)
        return state, (torch.stack(qs), torch.stack(times))

    return run


def make_run_loop(cfg, tol, max_it):
    """``run(state) -> state``: deterministic steps until convergence (all
    5 trailing residuals below tol), ``max_it`` or an invalid step."""
    det_step = make_det_step(cfg, with_aux=False)

    def run(state):
        while (int(state.step) < max_it and bool(state.valid)
               and not bool(torch.all(state.residual_buffer < tol))):
            state = det_step(state)
        return state

    return run
