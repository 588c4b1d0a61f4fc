"""Elastohydrodynamic (EHL) stepping on the device.

Counterpart of :mod:`gapflow_tpu.core.ehl`: the MacCormack step coupled
with the FFT elastic half-space, with no host round trip per step.  Per
step the gap is rebuilt from the under-relaxed deformation state, the
fluid advances one step, and the new pressure deforms the surface.  The
JAX package's ``fori_loop`` bodies are Python loops here.

Two protocols with one fixed point:

- :func:`make_ehl_loop` deforms from the END-of-step pressure.  On a
  float32 CUDA state of a fully periodic configuration without shear
  thinning (the production case), the fluid step is the EHL kernel K8
  (``ops.stencil.ehl_comp_step``): the kernel reads the undeformed gap
  and the deformation and forms the gap, its slopes and the statics
  itself, and the (q, q_lo) Kahan carry stays interior between steps;
- :func:`make_gp_ehl_loop` deforms from the PASS-2 pressure, the host
  ``update()`` + ``topo.update()`` sequencing (reference
  GaPFlow/problem.py:565-569, topography.py:424-441), with GP surrogates
  or deterministic closures; its fluid step is ``core.gp_step`` (the GP
  kernel K5 on a covered float32 CUDA state, with or without
  surrogates).  With ``adaptive=True`` it refreshes dt after every
  deformation.
"""

import torch

from ..models.eos import eos_pressure, true_div
from .gp_step import (_wrap_pad, cast_gp_state, cfl_dt, make_gp_closures,
                      make_gp_step_core, make_v_sound)
from .state import SimState
from .step import make_det_step


def _topo_from_deformation(h_undeformed, u, dx, dy):
    """The (4, nx+2, ny+2) topography of a deformation field: the gap, its
    ``np.gradient`` slopes and the deformation."""
    h = h_undeformed + u
    dh_dx = true_div(torch.gradient(h, dim=0)[0], dx)
    dh_dy = true_div(torch.gradient(h, dim=1)[0], dy)
    return torch.stack([h, dh_dx, dh_dy, u])


def _elastic(problem):
    """(deformation function, alpha, shift by u[0, 0]) of a Problem's
    half-space; raises for a problem without elastic coupling."""
    if not problem.topo.elastic:
        raise ValueError("problem has no elastic coupling")
    ed = problem.topo.ElasticDeformation
    return (ed.deformation_full, ed.alpha_underrelax,
            ed.periodicity in ("half", "none"))


def make_gp_ehl_loop(problem, active_dims, num_features, use_gp,
                     deform_every=1, dtype=None, end_pressure=False,
                     adaptive=False, allow_pallas=True):
    """GP-closed (or deterministic) x elastic loop on the pass-2 protocol:
    ``loop(q, u_prev, topo0, dt, step0, n_steps, gp_state) -> (q, u)``,
    with ``adaptive=True`` ``-> (q, u, dt, simtime_inc)``.

    ``active_dims``, ``num_features``, ``use_gp`` and ``gp_state`` as for
    :func:`core.gp_step.make_gp_step_core`; with every ``use_gp`` False
    the closures are the deterministic ones (``gp_state`` then needs only
    ``Xscale``).

    - step 0 uses ``topo0`` verbatim (the host topography, which carries
      the geometry's analytic gradients until the first
      ``topo.update()``); later steps rebuild it from the carried
      deformation;
    - after each step the pass-2 pressure, shifted by its [0, 0] value
      for half/none periodicity, deforms the surface under-relaxed into
      the carried, unshifted ``u`` (which keeps ``u_prev``'s dtype);
    - ``end_pressure=True`` deforms from the end-of-step pressure instead;
    - ``deform_every=K`` deforms every K fluid steps with the compounded
      factor ``1 - (1 - alpha)^K`` from the end-of-chunk pressure; the K
      inner steps go through the frozen-GP kernel K7
      (``ops.stencil_gp.gp_steps``) where the state takes the GP kernel;
    - ``adaptive=True`` (K = 1) refreshes ``dt = CFL * dmin / (v_max +
      v_sound)`` after the deformation, with v_sound from the
      post-deformation topography (reference GaPFlow/problem.py:435-440);
    - ``allow_pallas=False`` keeps the plain GP step on every state.
    """
    from ..ops.stencil import interior_statics, with_ghosts
    from ..ops.stencil_gp import gp_steps, prep_gp_ops

    hs_deform, alpha, shift_ref = _elastic(problem)
    if adaptive and deform_every != 1:
        raise ValueError("adaptive dt requires deform_every=1 "
                         "(host-exact per-step sequencing)")

    cfg = problem._solver_cfg
    dtype = dtype or problem.dtype
    dev = problem.device
    h_und = torch.as_tensor(problem.topo.h_undeformed, dtype=dtype,
                            device=dev)
    extra_d = torch.as_tensor(problem.fc.get_real_field("extra").p,
                              dtype=dtype, device=dev)

    step_core = make_gp_step_core(cfg, active_dims, num_features, use_gp,
                                  allow_pallas)
    closures = make_gp_closures(cfg, active_dims, num_features, use_gp)
    v_sound = make_v_sound(cfg, active_dims, num_features, use_gp)

    K = int(deform_every)
    alpha_K = 1. - (1. - alpha) ** K

    def topo_of(u):
        u_eff = (u - u[0, 0] if shift_ref else u).to(dtype)
        return _topo_from_deformation(h_und, u_eff, cfg.dx, cfg.dy)

    def deform(u, p):
        if shift_ref:
            p = p - p[0, 0]
        return (1. - alpha_K) * u + alpha_K * hs_deform(p.to(u.dtype))

    def chunk(q, topo_d, dt, step, gp_state):
        """K fluid steps on a fixed topography; returns q and the
        end-of-chunk pressure."""
        if step_core.route(q) == "gp_step":
            ops = prep_gp_ops(gp_state, active_dims, use_gp)
            st = interior_statics(topo_d, extra_d, q.dtype, q.device)
            q = with_ghosts(gp_steps(q[:, 1:-1, 1:-1].contiguous(), st, dt,
                                     cfg, ops, K), cfg)
        else:
            stepper = step_core.prepare(q, topo_d, extra_d, gp_state)
            s = stepper.inner(q)
            for k in range(K):
                s, _ = stepper.step(s, dt, step + k)
            q = stepper.full(s)
        return q, closures(q, topo_d, extra_d, gp_state)[0]

    def loop(q, u_prev, topo0, dt, step0, n_steps, gp_state):
        if n_steps % K:
            raise ValueError("n_steps must be divisible by deform_every")
        q = torch.as_tensor(q, device=dev).to(dtype)
        u = torch.as_tensor(u_prev, device=dev)
        topo0 = torch.as_tensor(topo0, device=dev).to(dtype)
        # a fixed dt stays a float of the dtype's value (the kernels take
        # it by value: no device synchronisation per step); an adaptive
        # one is carried on the device
        dt = torch.as_tensor(dt, dtype=dtype, device=dev)
        if not adaptive:
            dt = float(dt)
        gp_state = cast_gp_state(gp_state, dtype)
        t = torch.zeros((), dtype=dtype, device=dev)

        for i in range(n_steps // K):
            topo_d = topo0 if i == 0 else topo_of(u)
            if K == 1:
                q, p = step_core(q, topo_d, extra_d, dt, step0 + i, gp_state)
                if end_pressure:
                    p = closures(q, topo_d, extra_d, gp_state)[0]
            else:
                q, p = chunk(q, topo_d, dt, step0 + i * K, gp_state)
            u = deform(u, p)
            if adaptive:
                # dt AFTER the deformation, from the updated topography
                c = v_sound(q, topo_of(u), extra_d, gp_state)
                t = t + dt
                dt = cfl_dt(cfg, q, c).to(dtype)
        if adaptive:
            return q, u, dt, t
        return q, u

    return loop


def make_ehl_loop(problem, use_pallas="auto", dtype=None, deform_every=1,
                  statics_in_kernel=True):
    """``loop(q, u_prev, dt, n_steps) -> (q, u)`` for an elastic Problem on
    the end-of-step protocol; ``q`` and ``u`` are ghost-inclusive.

    Routes as the JAX package does:

    - ``use_pallas`` (``"auto"``: a CUDA problem whose configuration the
      fused kernels cover) with ``statics_in_kernel``, K = 1, fully
      periodic edges and no thinning: the EHL kernel K8, in float32 (the
      default) as the compensated step on the interior (q, q_lo) carry,
      which starts at zero on every call, in another dtype as its plain
      form (:func:`ops.stencil.ehl_step`);
    - ``use_pallas`` otherwise: the fused step (K = 1) or, for K > 1, the
      compensated fused loop ``make_pallas_loop(compensated, with_lo)``
      whose carry persists across chunks;
    - ``use_pallas=False``: the plain torch step in ``dtype`` (the
      Problem's by default).

    ``deform_every=K`` deforms every K fluid steps with the compounded
    factor ``1 - (1 - alpha)^K``, the same fixed point with K times fewer
    FFTs; ``n_steps`` must then be divisible by K.
    """
    from ..ops.stencil import (_periodic_kernel_ok, ehl_comp_step,
                               ehl_step, make_pallas_loop, make_pallas_step,
                               pallas_supported, with_ghosts)

    hs_deform, alpha, shift_ref = _elastic(problem)
    cfg = problem._solver_cfg
    dev = problem.device
    prop = cfg.prop
    nx, ny = problem.grid["Nx"], problem.grid["Ny"]
    if use_pallas == "auto":
        use_pallas = dev.type == "cuda" and pallas_supported(cfg)

    K = int(deform_every)
    alpha_K = 1. - (1. - alpha) ** K
    ehl_kernel = (use_pallas and statics_in_kernel and K == 1
                  and _periodic_kernel_ok(cfg))
    dtype = dtype or (torch.float32 if use_pallas else problem.dtype)
    comp = use_pallas and dtype == torch.float32

    h_und = torch.as_tensor(problem.topo.h_undeformed, dtype=dtype,
                            device=dev)
    extra_d = torch.as_tensor(problem.fc.get_real_field("extra").p,
                              dtype=dtype, device=dev)

    def deform(u, p):
        return (1. - alpha_K) * u + alpha_K * hs_deform(p.to(u.dtype))

    def topo_of(u):
        u_eff = u - u[0, 0] if shift_ref else u
        return _topo_from_deformation(h_und, u_eff, cfg.dx, cfg.dy)

    if ehl_kernel:
        # the kernel forms the gap from h_und and u (shifted by u[0, 0]
        # with shift_ref) and its slopes from the ghost-inclusive gap
        h_und = h_und.contiguous()
        ls_int = extra_d[0, 1:-1, 1:-1].contiguous()

    if ehl_kernel and comp:
        # the interior carry: the ghost ring is a periodic wrap, so the
        # deforming pressure is the wrap of the interior pressure, and the
        # ghost-inclusive state is reassembled once, after the loop
        def loop(q, u_prev, dt, n_steps):
            q = torch.as_tensor(q, device=dev).to(dtype)
            u = torch.as_tensor(u_prev, device=dev).to(dtype).contiguous()
            q_int = q[:, 1:-1, 1:-1].contiguous()
            lo = torch.zeros_like(q_int)
            for _ in range(n_steps):
                q_int, lo = ehl_comp_step(q_int, lo, h_und, u, ls_int, dt,
                                          cfg, shift_ref)
                u = deform(u, _wrap_pad(eos_pressure(q_int[0], prop)))
            return with_ghosts(q_int, cfg), u

        return loop

    if ehl_kernel:
        def fluid(q, lo, u, i, dt, dtf):
            q_int = ehl_step(q[:, 1:-1, 1:-1].contiguous(), h_und,
                             u.contiguous(), ls_int, dtf, cfg,
                             shift_ref=shift_ref)
            return with_ghosts(q_int, cfg), lo
    elif use_pallas and K > 1:
        inner = make_pallas_loop(cfg, nx, ny, dtype=dtype, compensated=comp,
                                 with_lo=comp)

        def fluid(q, lo, u, i, dt, dtf):
            topo = topo_of(u)
            if comp:
                return inner(q, topo, extra_d, dtf, K, lo)
            return inner(q, topo, extra_d, dtf, K), lo
    elif use_pallas:
        pstep = make_pallas_step(cfg, nx, ny, dtype=dtype)

        def fluid(q, lo, u, i, dt, dtf):
            return pstep(q, topo_of(u), extra_d, dtf, i), lo
    else:
        det = make_det_step(cfg, with_aux=False)

        def fluid(q, lo, u, i, dt, dtf):
            topo = topo_of(u)
            one = torch.ones((), dtype=dtype, device=dev)
            for k in range(K):
                q = det(SimState(
                    q=q, topo=topo, extra=extra_d, dt=dt,
                    step=torch.tensor(i + k, dtype=torch.int32, device=dev),
                    simtime=0. * one, ekin_old=one, residual=one,
                    residual_buffer=torch.full((5,), float("inf"),
                                               dtype=dtype, device=dev),
                    valid=torch.tensor(True, device=dev))).q
            return q, lo

    def loop(q, u_prev, dt, n_steps):
        if n_steps % K:
            raise ValueError("n_steps must be divisible by deform_every")
        q = torch.as_tensor(q, device=dev).to(dtype)
        u = torch.as_tensor(u_prev, device=dev).to(dtype)
        dt = torch.as_tensor(dt, dtype=dtype, device=dev)
        dtf = float(dt)          # the kernels take dt as a float
        lo = torch.zeros_like(q[:, 1:-1, 1:-1])
        for i in range(n_steps // K):
            q, lo = fluid(q, lo, u, i * K, dt, dtf)
            p = eos_pressure(q[0], prop)
            if shift_ref:
                p = p - p[0, 0]
            u = deform(u, p)
        return q, u

    return loop
