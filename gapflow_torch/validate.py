"""Correctness checks of the production (float32, fused kernel) path.

Counterpart of the deterministic checks of :mod:`gapflow_tpu.validate`:

- :func:`sommerfeld_l2`: the journal bearing through the fused
  compensated loop to steady state, against the analytic Sommerfeld
  pressure (rel-L2 < 0.02 is the acceptance bar);
- :func:`pallas_vs_xla_err`: the plain fused loop (the whole-run
  kernels on the card) against the plain step from one perturbed
  float32 state;
- :func:`perturbed_state`: a non-inert journal state for comparing a
  kernel with its plain twin (the unperturbed float32 state is frozen:
  its per-step increments fall below one ulp of the density);
- :func:`synthetic_gp_state` and :func:`gp_kernel_parity`: a
  well-conditioned padded GP state, and the GP kernel against the plain
  GP step on it;
- :func:`ehl_kernel_bitexact`: the compensated EHL kernel against its
  ``emit_delta`` form plus an explicit Kahan two-sum.
"""

import numpy as np
import torch

from .core.step import apply_bcs


def journal_problem(nx=256, ny=128, device="cuda", dtype=torch.float32):
    from . import Problem
    return Problem.from_string(journal_yaml(nx, ny, dx=4e-6, dt=1.5e-10,
                                            tol=1e-9), device=device,
                               dtype=dtype)


def sommerfeld_solution(x, Lx, mu, U, clearance_ratio, eps, P0):
    """Analytic Sommerfeld journal-bearing pressure (full film)."""
    Rb = Lx / (2. * np.pi)
    c = clearance_ratio * Rb
    omega = U / Rb
    prefac = 6. * mu * omega * (Rb / c) ** 2 * eps
    return P0 + prefac * np.sin(x / Rb) * (2. + eps * np.cos(x / Rb)) \
        / ((2. + eps ** 2) * (1. + eps * np.cos(x / Rb)) ** 2)


def sommerfeld_l2(n_steps=20000, nx=256, ny=128, device="cuda"):
    """Rel-L2 pressure error of the float32 compensated loop vs Sommerfeld.

    The float32 parameter constraints (EOS stiffness above f32 ulp, stiff
    source stability, compensated accumulation against increment
    underflow) are documented in examples/validate_f32_production.py.
    """
    problem = journal_problem(nx=nx, ny=ny, device=device)
    problem._pre_run()
    problem.run_steps_fast(n_steps)

    problem._refresh_det_fields()
    p_num = np.asarray(problem.pressure.pressure)[1:-1, ny // 2]

    Lx = problem.grid["Lx"]
    x_edges = np.linspace(0., Lx, nx + 1)
    x = (x_edges[1:] + x_edges[:-1]) / 2.

    dp = p_num[1] - p_num[0]
    p_ana = sommerfeld_solution(x, Lx, problem.prop["shear"],
                                problem.geo["U"], problem.geo["CR"],
                                problem.geo["eps"], p_num[0] - dp / 2)
    return float(np.linalg.norm(p_ana - p_num) / np.linalg.norm(p_ana))


def pallas_vs_xla_err(nx=256, ny=256, n_steps=8, device="cuda"):
    """Component-scaled max error, plain fused loop vs plain steps.

    Runs ``n_steps`` through both :func:`ops.stencil.make_pallas_loop`
    (``compensated=False``: on the card the plain whole-run kernels; at
    256² the whole run in one launch) and :func:`core.step.make_det_step`
    from the same perturbed float32 journal state (dx 2e-5, dt 5e-11, as
    the JAX package's check of its Pallas loop against its XLA step).
    Returns max_c max |loop - step| / max |step_c| over the
    ghost-inclusive state.
    """
    from . import Problem
    from .core.step import make_det_step
    from .ops import make_pallas_loop, pallas_supported

    problem = Problem.from_string(
        journal_yaml(nx, ny, dx=2e-5, dt=5e-11, tol=1e-9,
                     out="data/val_eq"),
        device=device, dtype=torch.float32)
    problem._pre_run()
    cfg = problem._solver_cfg
    if not pallas_supported(cfg):
        raise RuntimeError("journal configuration lost kernel support")
    state = perturbed_state(problem, amp=0.01)
    det = make_det_step(cfg, with_aux=False)
    s = state
    for _ in range(n_steps):
        s = det(s)
    loop = make_pallas_loop(cfg, nx, ny, dtype=torch.float32)
    out = loop(state.q, state.topo, state.extra, state.dt, n_steps)
    return kernel_vs_plain_err(out, s.q)


DH = "EOS: DH, P0: 101325., rho0: 877.7007, C1: 3.5e10, C2: 1.23"
_DN_X = ("xE: ['D', 'N', 'N'], xW: ['D', 'N', 'N'], xE_D: 877.7007, "
         "xW_D: 877.7007")
_EYRING = ", thinning: {name: Eyring, tauE: 5.e5}"
_X_MIXED = ("xE: ['D', 'N', 'P'], xW: ['D', 'N', 'P'], xE_D: 877.7007, "
            "xW_D: 877.7007")
_Y_MIXED = "yS: ['P', 'P', 'D'], yN: ['P', 'P', 'D'], yS_D: 0., yN_D: 0."

#: Edge and thinning cases of the boundary kernel K3 (grid keys, property
#: keys of a journal configuration): D/N x edges; with Barus and Eyring;
#: fully periodic with Eyring (the periodic seam); D/N on all four edges
#: with an asymmetric Dirichlet pair on each axis.
BC_CASES = {
    "dn_x": (_DN_X, DH),
    "dn_x_barus_eyring": (_DN_X, DH + ", piezo: {name: Barus, aB: 2.e-9}"
                          + _EYRING),
    "periodic_eyring": ("", DH + _EYRING),
    "dn_all_asymmetric": (
        "xE: ['D', 'N', 'N'], xW: ['D', 'N', 'N'], xE_D: 900., "
        "xW_D: 850., yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'], "
        "yS_D: 880., yN_D: 860.", DH),
}

#: Mixed per-component edge specs of the mixed-edge kernel K4 (grid keys):
#: the cases of the JAX package's tests/test_pallas_mixed.py.
MIXED_CASES = {
    "x_mixed": _X_MIXED,
    "y_mixed_x_periodic": _Y_MIXED,
    "both_mixed": _X_MIXED + ", " + _Y_MIXED,
    "y_mixed_x_uniform": _DN_X + ", " + _Y_MIXED,
}


def journal_yaml(nx, ny, grid="", props=DH, dx=2e-5, dt=5e-11, tol=1e-30,
                 max_it=1000000, out="data/val"):
    """A silent fixed-dt journal-bearing configuration (Sommerfeld and
    the kernel checks); ``grid`` adds edge keys, ``props`` sets the
    properties after shear and bulk viscosity."""
    grid = ", " + grid if grid else ""
    return (f"options: {{output: {out}, write_freq: 100000, silent: True}}\n"
            f"grid: {{dx: {dx}, dy: {dx}, Nx: {nx}, Ny: {ny}{grid}}}\n"
            "geometry: {type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.}\n"
            f"numerics: {{CFL: 0.5, adaptive: 0, tol: {tol}, dt: {dt}, "
            f"max_it: {max_it}}}\n"
            f"properties: {{shear: 0.0794, bulk: 0., {props}}}\n")


#: The elastic block of the EHL journal (bench.py bench_ehl_step and
#: bench_gp_ehl): a 5 GPa half-space, under-relaxation 1e-4.
EHL_ELASTIC = "elastic: {E: 5e09, v: 0.3, alpha_underrelax: 1e-04}"


def ehl_yaml(nx, ny, V=0., max_it=1000000, out="data/val_ehl"):
    """The EHL journal of the JAX package's benchmark (bench.py
    bench_ehl_step; ``V=0.05`` as bench_gp_ehl): silent, fixed dt 5e-11,
    fully periodic, DH, with the half-space of :data:`EHL_ELASTIC`."""
    return (f"options: {{output: {out}, write_freq: 1000000, "
            "silent: True}\n"
            f"grid: {{dx: 2.e-5, dy: 2.e-5, Nx: {nx}, Ny: {ny}}}\n"
            "geometry: {type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, "
            f"V: {V}}}\n"
            "numerics: {CFL: 0.25, adaptive: 0, tol: 1e-30, dt: 5e-11, "
            f"max_it: {max_it}}}\n"
            f"properties: {{shear: 0.0794, bulk: 0., {DH}, "
            f"{EHL_ELASTIC}}}\n")


def perturbed_q(q, seed=0, amp=0.01):
    """Perturbed copy of a ghost-inclusive numpy state: relative density
    noise and a small jx perturbation (numpy generator, so the JAX
    package and the port can be fed the same state)."""
    rng = np.random.default_rng(seed)
    q = np.array(q, dtype=np.float64)
    q[0] *= 1. + amp * rng.standard_normal(q[0].shape)
    q[1] += 0.1 * amp * float(np.mean(q[0])) * rng.standard_normal(q[0].shape)
    return q


def perturbed_state(problem, seed=0, amp=0.01):
    """The Problem's initial state with :func:`perturbed_q` applied and
    ghost cells refilled, in the Problem's dtype on its device."""
    st = problem._make_state()
    q = problem._tensor(perturbed_q(problem.q, seed, amp))
    return st._replace(q=apply_bcs(q, problem._solver_cfg))


def kernel_vs_plain_err(a, b):
    """Max abs difference scaled by each component's max magnitude of b
    (unscaled for a component of b that is zero everywhere)."""
    scale = b.abs().reshape(b.shape[0], -1).max(dim=1).values
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return float(((a - b).abs() / scale[:, None, None]).max())


#: GP configurations of the GP kernel checks: (gp: section, db: section)
#: of a journal configuration; pressure only, and all three surrogates.
GP_CASES = {
    "pressure": ("press: {fix_noise: True, atol: 1., rtol: 0.1, "
                 "obs_stddev: 100., max_steps: 2}"),
    "all": ("press: {fix_noise: True, atol: 1., rtol: 0.1, "
            "obs_stddev: 100., max_steps: 2}, shear: {fix_noise: True, "
            "atol: 1., rtol: 0.1, obs_stddev: 1., max_steps: 2}"),
}


def gp_yaml(nx, ny, gp=GP_CASES["all"], grid="", dt=5e-11, max_it=10,
            out="data/val_gp", dtool_path=None, init_size=4,
            init_method="sobol", init_width=1e-4):
    """A silent fixed-dt journal-bearing configuration with GP surrogates
    on the mock oracle (``V = 0.05``, so that the yz stress is not zero);
    ``gp`` is the body of the ``gp:`` section, ``grid`` adds edge keys."""
    grid = ", " + grid if grid else ""
    dtool = dtool_path or out + "/train"
    return (f"options: {{output: {out}, write_freq: 1000000, "
            "silent: True}\n"
            f"grid: {{dx: 2.e-5, dy: 2.e-5, Nx: {nx}, Ny: {ny}{grid}}}\n"
            "geometry: {type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, "
            "V: 0.05}\n"
            f"numerics: {{CFL: 0.25, adaptive: 0, tol: 1e-30, dt: {dt}, "
            f"max_it: {max_it}}}\n"
            f"properties: {{shear: 0.0794, bulk: 0., {DH}}}\n"
            f"gp: {{{gp}}}\n"
            f"db: {{init_size: {init_size}, init_method: {init_method}, "
            f"init_width: {init_width}, dtool_path: {dtool}}}\n")


_JOURNAL_XSCALE = (877.7, 68.7, 23.7, 1.7e-6, 6.2e-3, 6.2e-3, 1.0)


def synthetic_gp_state(dims, use, cap, rng, dtype=torch.float32,
                       device="cpu", xscale=_JOURNAL_XSCALE,
                       yscales=(1e5, 1e3, 1e3)):
    """Well-conditioned padded GP state for kernel parity checks (the
    draws of the JAX package's ``validate.synthetic_gp_state`` from the
    same numpy generator, so both packages get the same state; its
    feature and target scales are a journal bearing's, unless given).

    A state trained on a near-uniform initial flow is degenerate
    (saturated kernel, catastrophic alpha cancellation) and meaningless
    to compare in float32; production states behave like this one."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), dtype=dtype,
                               device=device)

    state = {"Xscale": t(xscale)}
    for key, dms, used, yscale in zip(("z", "x", "y"), dims, use, yscales):
        if not used:
            continue
        d = len(dms)
        state[f"params_{key}"] = {
            "log_amp": t(0.2),
            "log_scale": t(rng.uniform(-0.5, 0.5, d))}
        state[f"Xfit_{key}"] = t(rng.uniform(0., 1.2, (cap, d)))
        m = 1 if key == "z" else 2
        alpha = rng.normal(size=(cap, m))
        state[f"alpha_{key}"] = t(alpha if m == 2 else alpha[:, 0])
        state[f"Yscale_{key}"] = t(yscale)
    return state


def gp_dims_use(problem):
    """(active dims, used) per surrogate z, x, y of a GP Problem."""
    models = (problem.pressure, problem.wall_stress_xz,
              problem.wall_stress_yz)
    return (tuple(tuple(m.active_dims) if m.is_gp_model else None
                  for m in models),
            tuple(m.is_gp_model for m in models))


def gp_kernel_inputs(problem, cap, seed=0, amp=1e-3, ghosted=False,
                     dtype=torch.float32, db_scales=False):
    """Interior q, statics, dt, the GP kernel operands and the padded
    state of a synthetic GP state (cap rows) on a perturbed (relative
    density noise ``amp``) state of ``problem``, in ``dtype`` on its
    device.  The state and q are float32 values (the JAX package's
    inputs), the statics are computed in ``dtype``.  ``db_scales``
    takes the feature and target scales of the Problem's database
    instead of a journal bearing's."""
    from .ops.stencil import ghost_statics, interior_statics
    from .ops.stencil_gp import prep_gp_ops
    dims, use = gp_dims_use(problem)
    rng = np.random.default_rng(seed)
    scales = {}
    if db_scales:
        scales = {"xscale": problem.database.X_scale,
                  "yscales": [m.Yscale if m.is_gp_model else 1. for m in
                              (problem.pressure, problem.wall_stress_xz,
                               problem.wall_stress_yz)]}
    state = synthetic_gp_state(dims, use, cap, rng, dtype, problem.device,
                               **scales)
    q = np.asarray(problem.q, np.float32)
    q[0] *= 1 + amp * rng.standard_normal(q[0].shape)
    q = torch.as_tensor(q, dtype=dtype, device=problem.device)
    q = apply_bcs(q, problem._solver_cfg)[:, 1:-1, 1:-1].contiguous()
    topo = problem.topo.full
    extra = problem.fc.get_real_field("extra").p
    statics = (ghost_statics if ghosted else interior_statics)(
        topo, extra, dtype, problem.device)
    return q, statics, problem.dt, prep_gp_ops(state, dims, use), state


def synthetic_gp_ops(shapes, cap, seed, device):
    """Kernel operands (``ops.stencil_gp.GPOps``) of one synthetic
    surrogate per ``(key, d, n_out)`` of ``shapes``: d active features
    drawn from the 7 built-ins, ``cap`` training points and unit-scale
    length scales, scaled like a journal bearing's database, all from one
    numpy generator, float32 on ``device``."""
    from .ops.stencil_gp import GPOps
    rng = np.random.default_rng(seed)
    xscale = np.asarray(_JOURNAL_XSCALE, np.float64)
    models = {}
    for key, d, n_out in shapes:
        dims = tuple(int(i) for i in rng.choice(7, size=d, replace=False))
        ls = rng.uniform(0.6, 1.6, d)
        Ws = np.sqrt(3.) * rng.uniform(0., 1.2, (cap, d)) / ls
        coef = np.sqrt(3.) / ls / xscale[list(dims)]
        alpha = rng.normal(size=(cap, n_out)) * 1e3

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        models[key] = (dims, t(coef), t(-2. * Ws),
                       t(np.sum(Ws * Ws, axis=1) + 3e-14), t(alpha))
    return GPOps(models, device)


def sqrt_sweep(seed=0, per_binade=4096):
    """float32 arguments of the GP kernels' sqrt (numpy): ``(inside,
    above)``, every binade of [3e-14, 2^125] with ``per_binade`` random
    mantissas and both ends, where the written-out sqrt must equal
    sqrtf; and (2^125, FLT_MAX] (three binades and FLT_MAX), where the
    Matern value must be 0 for both."""
    rng = np.random.default_rng(seed)
    lo, hi = np.float32(3e-14), np.float32(2. ** 125)
    parts = [np.array([lo, np.nextafter(lo, np.float32(1)), hi,
                       np.nextafter(hi, np.float32(0))], np.float32)]
    for e in range(-45, 128):
        parts.append((rng.uniform(1., 2., per_binade) * 2. ** e)
                     .astype(np.float32))
    x = np.concatenate(parts + [np.array([np.finfo(np.float32).max])])
    x = x[np.isfinite(x)]
    return x[(x >= lo) & (x <= hi)], x[x > hi]


def gp_kernel_parity(problem, cap=16, seed=0):
    """The GP kernel (:func:`ops.stencil_gp.gp_step`, or
    :func:`~ops.stencil_gp.gp_step_bc` on D/N edges) against the plain
    GP step (``core.gp_step``, kernels off) on a synthetic state, float32
    on the Problem's device: (q scaled max error, p relative max error,
    over the ghost ring too on D/N edges)."""
    from .core.gp_step import make_gp_step_core
    from .ops.stencil import _fully_periodic, with_ghosts
    from .ops.stencil_gp import gp_step, gp_step_bc
    cfg = problem._solver_cfg
    periodic = _fully_periodic(cfg)
    q, st, dt, ops, state = gp_kernel_inputs(problem, cap, seed,
                                             ghosted=not periodic)
    dims, use = gp_dims_use(problem)
    ref = make_gp_step_core(cfg, dims, problem.database.num_features, use,
                            allow_pallas=False)
    topo = torch.as_tensor(problem.topo.full, dtype=torch.float32,
                           device=problem.device)
    extra = torch.as_tensor(problem.fc.get_real_field("extra").p,
                            dtype=torch.float32, device=problem.device)
    qr, pr = ref(with_ghosts(q, cfg), topo, extra, dt, 0, state)
    qr = qr[:, 1:-1, 1:-1]
    if periodic:
        qk, pk = gp_step(q, st, dt, cfg, ops)
        p_err = float((pk - pr[1:-1, 1:-1]).abs().max()
                      / pr[1:-1, 1:-1].abs().max())
    else:
        qk, pk = gp_step_bc(q, st, dt, cfg, ops, need_p=True)
        p_err = float((pk - pr).abs().max() / pr.abs().max())
    return kernel_vs_plain_err(qk, qr), p_err


def ehl_inputs(problem, seed=7, u_amp=1e-9):
    """Inputs of the EHL kernel on a perturbed state of ``problem`` (any
    periodic Problem; its gap serves as the undeformed height), float32
    on its device: interior q, the ghost-inclusive undeformed gap and
    deformation ``u ~ u_amp N(0, 1)`` (numpy, ``seed``, drawn on the
    whole ghost-inclusive grid, so that the gap's ghost ring is no wrap of
    its interior), the slip length and dt."""
    dev, f32 = problem.device, torch.float32
    problem._pre_run()
    q = perturbed_state(problem).q.to(f32)[:, 1:-1, 1:-1].contiguous()
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal(problem.topo.h.shape) * u_amp,
                        dtype=f32, device=dev)
    h_und = torch.as_tensor(problem.topo.h, dtype=f32, device=dev)
    ls = torch.as_tensor(problem.fc.get_real_field("extra").p[0, 1:-1, 1:-1],
                         dtype=f32, device=dev).contiguous()
    return (q, h_und.contiguous(), u.contiguous(), ls,
            float(np.float32(problem.dt)))


def ehl_kernel_bitexact(n_steps=4, nx=256, ny=128, device="cuda",
                        shift_ref=False):
    """The compensated EHL kernel (:func:`ops.stencil.ehl_comp_step`)
    against the ``emit_delta`` EHL kernel plus an explicit Kahan two-sum
    in torch, ``n_steps`` steps on a perturbed journal with a deformation
    ``u ~ 1e-9 N(0, 1)`` (numpy seed 7).  The two share their arithmetic;
    built with ``--fmad=false`` they agree bit for bit, and ``ok`` allows
    up to 1e-6 of the state's magnitude."""
    from .ops.stencil import ehl_comp_step, ehl_step
    problem = journal_problem(nx=nx, ny=ny, device=device)
    cfg = problem._solver_cfg
    q0, h_und, u, ls, dt = ehl_inputs(problem)

    qr, lo = q0, torch.zeros_like(q0)
    for _ in range(n_steps):
        delta = ehl_step(qr, h_und, u, ls, dt, cfg, emit_delta=True,
                         shift_ref=shift_ref)
        y = delta + lo
        t = qr + y
        qr, lo = t, y - (t - qr)

    qk, lk = q0, torch.zeros_like(q0)
    for _ in range(n_steps):
        qk, lk = ehl_comp_step(qk, lk, h_und, u, ls, dt, cfg, shift_ref)

    dq = float((qk - qr).abs().max())
    dl = float((lk - lo).abs().max())
    scale = float(qr.abs().max())
    return {"q_maxdiff": dq, "lo_maxdiff": dl,
            "ok": bool(dq <= 1e-6 * scale and dl <= 1e-6 * scale)}
