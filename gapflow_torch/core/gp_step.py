"""GP-surrogate MacCormack step (plain torch, or the CUDA GP kernels).

Counterpart of :mod:`gapflow_tpu.core.gp_step` (``_features``,
``make_gp_closures``, ``make_gp_step_core`` with its kernel routes,
``make_gp_step``, and adaptive dt on the device: ``make_v_sound``,
``cfl_dt``, ``make_gp_adaptive_loop``).  When no retraining is pending
the GP-closed timestep is a pure function of the state and the
surrogates' padded buffers:

    per pass: build the feature matrix from the current q, predict the
              pressure and wall-stress means from the cached (params,
              alpha), assemble the wall and bulk stresses, advance q one
              MacCormack pass and fill the ghosts.

The plain step is the specification.  Float32 CUDA states that the GP
kernels cover take them instead (:mod:`gapflow_torch.ops.stencil_gp`):
fully periodic edges the periodic kernel, uniform Dirichlet/Neumann edges
the boundary kernel (with its ghost-inclusive pass-2 pressure where the
caller needs it).
"""

import functools
from typing import Callable, NamedTuple

import torch

from .integrate import predictor_corrector, source
from .step import apply_bcs, effective_viscosity, mc_directions
from ..models.eos import eos_pressure, eos_sound_velocity, true_div
from ..models.gp import _outputs_first, kernel_fn
from ..models.viscous import stress_bottom, stress_top, stress_avg


def _features(q, topo, extra):
    """(n_feat, ...) feature rows: rho, jx, jy, h, hx, hy, extra..."""
    return torch.cat([q, topo[:3], extra], dim=0)


def _gp_mean(params, X_fit, alpha, Xtest):
    return _outputs_first(kernel_fn(params, X_fit, Xtest).T @ alpha)


def make_gp_closures(cfg, active_dims, num_features, use_gp):
    """GP-surrogate constitutive closures on a (3, a, b) block:
    ``closures(q, topo, extra, gp_state) -> (p, tau_bulk, s_bot, s_top)``.
    See :func:`make_gp_step_core` for the gp_state layout."""
    dims_z, dims_x, dims_y = active_dims
    gpz, gpx, gpy = use_gp

    def closures(q, topo, extra, gp_state):
        shape = q.shape[1:]
        feats = _features(q, topo, extra)
        Xf = feats.reshape(num_features, -1).T / gp_state["Xscale"][None, :]

        def mean(key, dims):
            m = _gp_mean(gp_state[f"params_{key}"], gp_state[f"Xfit_{key}"],
                         gp_state[f"alpha_{key}"], Xf[:, list(dims)])
            return m * gp_state[f"Yscale_{key}"]

        if gpz:
            p = mean("z", dims_z).reshape(shape)
        else:
            p = eos_pressure(q[0], cfg.prop)

        h3 = topo[:3]
        eta = effective_viscosity(cfg, q[0], p, h3[0])
        Ls = extra

        s_bot = stress_bottom(q, h3, cfg.U, cfg.V, eta, cfg.bulk, Ls)
        s_top = stress_top(q, h3, cfg.U, cfg.V, eta, cfg.bulk, Ls)
        tau_bulk = stress_avg(q, h3, cfg.U, cfg.V, eta, cfg.bulk, Ls)

        # GP wall shear: the xz model writes Voigt 4, yz writes 3; the
        # 2-column mean is (bottom, top)
        for used, key, dims, i in ((gpx, "x", dims_x, 4),
                                   (gpy, "y", dims_y, 3)):
            if used:
                m = mean(key, dims)
                s_bot[i] = m[0].reshape(shape)
                s_top[i] = m[1].reshape(shape)

        return p, tau_bulk, s_bot, s_top

    return closures


def _wrap_pad(p):
    """Interior (nx, ny) -> ghost-inclusive with periodic ghosts."""
    nx, ny = p.shape
    ix = torch.arange(-1, nx + 1, device=p.device) % nx
    iy = torch.arange(-1, ny + 1, device=p.device) % ny
    return p[ix][:, iy]


def cast_gp_state(gp_state, dtype):
    """``gp_state`` (see :func:`make_gp_step_core`) with every tensor in
    ``dtype``."""
    def to(v):
        if isinstance(v, dict):
            return {k: t.to(dtype) for k, t in v.items()}
        return v.to(dtype)
    return {k: to(v) for k, v in gp_state.items()}


def _same(q):
    return q


def _interior(q):
    return q[:, 1:-1, 1:-1].contiguous()


class Stepper(NamedTuple):
    """The per-state stepping of one route: ``step(s, dt, step_idx) ->
    (s, p_last)`` advances the state ``s`` that the route carries (the
    interior for a kernel, the ghost-inclusive q for the plain step);
    ``inner(q)`` takes it from a ghost-inclusive q and ``full(s)`` gives
    the ghost-inclusive q back."""

    inner: Callable
    step: Callable
    full: Callable


def make_gp_step_core(cfg, active_dims, num_features, use_gp,
                      allow_pallas=True, need_p=True):
    """GP-closed timestep on ghost-inclusive arrays.

    ``active_dims``: (dims_z, dims_x, dims_y), None where that surrogate
    is analytic; ``use_gp``: (z, x, y) booleans; ``num_features``: the
    database's feature count.  Returns ``step(q, topo, extra, dt,
    step_idx, gp_state) -> (q, p_last)``; ``gp_state`` holds ``Xscale``
    and per used surrogate k in {z, x, y} ``params_k``, ``Xfit_k``,
    ``alpha_k``, ``Yscale_k`` (padded buffers: padded alpha rows are
    zero, so the means are exact without masking).

    ``step.prepare(q, topo, extra, gp_state)`` builds the per-state part
    once (the state in q's dtype, statics and kernel operands) and
    returns a :class:`Stepper`;
    ``step.route(q)`` names the kernel a state takes (``"gp_step"``,
    ``"gp_step_bc"`` or None for the plain step).  ``need_p=False``
    declares that the caller discards ``p_last``: it is None, and the
    kernels run their variants that write no pressure (the boundary
    kernel's pressure, where written, covers the ghost ring)."""
    from ..ops.stencil import ghost_statics, interior_statics, with_ghosts
    from ..ops.stencil_gp import (gp_bc_kernel_supported,
                                  gp_kernel_supported, gp_step, gp_step_bc,
                                  prep_gp_ops)

    closures = make_gp_closures(cfg, active_dims, num_features, use_gp)

    def one_pass(q, topo, extra, dt, d, gp_state):
        p, tau_bulk, s_lo, s_up = closures(q, topo, extra, gp_state)
        fX, fY = predictor_corrector(q, p, tau_bulk, d)
        src = source(q, topo, tau_bulk, s_lo, s_up)
        q = q - dt * (true_div(fX, cfg.dx) + true_div(fY, cfg.dy) - src)
        return apply_bcs(q, cfg), p

    def plain_step(q, topo, extra, dt, step_idx, gp_state):
        q0 = q
        if cfg.MC_order != 0:
            d0, d1 = mc_directions(cfg.MC_order)
        else:
            d0, d1 = mc_directions(1 if int(step_idx) % 2 == 0 else -1)
        q, _ = one_pass(q, topo, extra, dt, d0, gp_state)
        q, p_last = one_pass(q, topo, extra, dt, d1, gp_state)
        q = (q + q0) / 2.
        return apply_bcs(q, cfg), p_last

    def route(q):
        if not (allow_pallas and q.is_cuda and q.dtype == torch.float32):
            return None
        if gp_kernel_supported(cfg, active_dims, use_gp):
            return "gp_step"
        if gp_bc_kernel_supported(cfg, active_dims, use_gp):
            return "gp_step_bc"
        return None

    def prepare(q, topo, extra, gp_state):
        gp_state = cast_gp_state(gp_state, q.dtype)
        r = route(q)
        if r is None:
            def pstep(qq, dt, i):
                qq, p = plain_step(qq, topo, extra, dt, i, gp_state)
                return qq, (p if need_p else None)
            return Stepper(_same, pstep, _same)
        ops = prep_gp_ops(gp_state, active_dims, use_gp)
        if r == "gp_step":
            st = interior_statics(topo, extra, q.dtype, q.device)

            def kstep(q_int, dt, i):
                q_int, p = gp_step(q_int, st, dt, cfg, ops, need_p)
                return q_int, (None if p is None else _wrap_pad(p))
        else:
            st = ghost_statics(topo, extra, q.dtype, q.device)

            def kstep(q_int, dt, i):
                if need_p:
                    return gp_step_bc(q_int, st, dt, cfg, ops, need_p=True)
                return gp_step_bc(q_int, st, dt, cfg, ops), None
        return Stepper(_interior, kstep, lambda q_int: with_ghosts(q_int, cfg))

    def step(q, topo, extra, dt, step_idx, gp_state):
        s = prepare(q, topo, extra, gp_state)
        q, p = s.step(s.inner(q), dt, step_idx)
        return s.full(q), p

    step.prepare = prepare
    step.route = route
    return step


@functools.lru_cache(maxsize=16)
def make_gp_step(cfg, active_dims, num_features, use_gp):
    """Cached :func:`make_gp_step_core` (the JAX package's jitted step)."""
    return make_gp_step_core(cfg, active_dims, num_features, use_gp)


def make_v_sound(cfg, active_dims, num_features, use_gp):
    """Maximum sound speed on the device, as the host property
    ``Pressure.v_sound`` (models/stress.py) computes it: for a
    deterministic pressure ``max(eos_sound_velocity(rho))`` over the
    ghost-inclusive grid; for a GP pressure ``sqrt(max_x d mean / d
    rho_norm * Yscale / Xscale[0])``, the gradient of the cached GP mean
    over the full-grid feature matrix taken by ``torch.autograd``.

    Returns ``v_sound(q, topo, extra, gp_state) -> 0-d tensor``, with
    which the adaptive loops refresh ``dt = CFL * dmin / (v_max + c)``
    every step."""
    dims_z = active_dims[0]
    gpz = use_gp[0]

    def v_sound(q, topo, extra, gp_state):
        if not gpz:
            return torch.max(eos_sound_velocity(q[0], cfg.prop))
        feats = _features(q, topo, extra)
        Xf = (feats.reshape(num_features, -1).T
              / gp_state["Xscale"][None, :])
        with torch.enable_grad():
            X = Xf[:, list(dims_z)].detach().requires_grad_(True)
            mean = kernel_fn(gp_state["params_z"], gp_state["Xfit_z"],
                             X).T @ gp_state["alpha_z"]
            (dmean,) = torch.autograd.grad(mean.sum(), X)
        vs_sq = (torch.max(dmean[:, 0]) * gp_state["Yscale_z"]
                 / gp_state["Xscale"][0])
        return torch.sqrt(vs_sq)

    return v_sound


def cfl_dt(cfg, q, v_sound):
    """Adaptive timestep ``CFL * min(dx, dy) / (v_max + v_sound)`` with
    ``v_max = sqrt(max(j^2 / rho))``, the CFL convention the reference
    defines the criterion with (GaPFlow problem.py v_max), not the
    physical velocity."""
    v_max = torch.sqrt(torch.max((q[1] ** 2 + q[2] ** 2) / q[0]))
    return true_div(cfg.CFL * min(cfg.dx, cfg.dy), v_max + v_sound)


def make_gp_adaptive_loop(cfg, active_dims, num_features, use_gp, n_steps):
    """Adaptive-dt frozen-GP loop on a fixed topography: ``loop(q, topo,
    extra, dt, step0, gp_state) -> (q, dt, simtime_inc)``.

    Each step goes through ``make_gp_step_core`` (the GP kernels on a
    covered float32 CUDA state, without the pressure output) and is
    followed by ``dt = CFL * dmin / (v_max + v_sound)`` from the new
    state, the host ``_post_update`` order (reference
    GaPFlow/problem.py:435-440).  ``dt`` and the simulated time are 0-d
    tensors in the state's dtype."""
    step_core = make_gp_step_core(cfg, active_dims, num_features, use_gp,
                                  need_p=False)
    v_sound = make_v_sound(cfg, active_dims, num_features, use_gp)

    def loop(q, topo, extra, dt, step0, gp_state):
        gp_state = cast_gp_state(gp_state, q.dtype)
        dt = torch.as_tensor(dt, dtype=q.dtype, device=q.device)
        t = torch.zeros((), dtype=q.dtype, device=q.device)
        stepper = step_core.prepare(q, topo, extra, gp_state)
        s = stepper.inner(q)
        for i in range(n_steps):
            s, _ = stepper.step(s, dt, step0 + i)
            q = stepper.full(s)
            c = v_sound(q, topo, extra, gp_state)
            t = t + dt
            dt = cfl_dt(cfg, q, c).to(q.dtype)
        return q, dt, t

    return loop
