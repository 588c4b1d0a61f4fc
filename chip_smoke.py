"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of gapflow_torch from this checkout, checks each
against its plain torch twin on the card, drives the main paths through
``Problem.run()`` (a silent float32 journal bearing on periodic edges, an
inclined slider on Dirichlet/Neumann edges, a rough contact on four D/N
edges with shear thinning, a journal on mixed per-component edges; the
GP-surrogate journal with active learning on the mock MD oracle and with
frozen surrogates, and the GP rough contact on D/N edges, twice), holds
each GP kernel against its twin on the state and the surrogates its run
ended with, checks that the kernel routes and the plain torch steps
agree on a run (deterministic and GP), drives the elastic (EHL) paths
(the EHL kernel loop, the pass-2 route of ``Problem.run()``, GP x
elastic with frozen surrogates, the flagship rough-surface EHL GP
configuration, adaptive dt on the device), checks the physics against
the analytic Sommerfeld solution, and holds each kernel against its twin
again on the main paths' 1024² inputs before timing both.  The GP step
kernels are held bit for bit against their twins (2g, 5), their means
kernel alone for each feature and output count, and the written-out
sqrt against sqrtf; phase 5 splits a K5 step into its four launches
(by torch.profiler; where it keeps no device record of them this late
in the run, in a new process: ``python3 chip_smoke.py --gp-profile``).
The blocked Cholesky and triangular solve (2k) are held bit for bit
against their twins and within the reference's tolerance against
torch.linalg at n 256-2048, forward and backward; the per-step GP loop
(3q) runs the GP example configurations non-silent, the 1D journal held
in float64 against the CPU and in float32 step by step against the same
route on the twins; the half-space on cuFFT is held against its float64 CPU path
on FFT grids of 1024², 1026², 2050² and 2052² (3r).  The plain
(uncompensated) whole-run kernels are held bit for bit against K1 and
K3 launched once per step (2i), then drive bench.py's FV throughput run
(3o: the whole run in one launch at 512², temporally blocked sweeps at
1024² and 2048², each beside K1 once per step) and the plain boundary
paths (3p).  The compensated sweeps (K2c, K3c), which carry the main
paths 3-3c a chunk per C call, are held bit for bit against the
one-step compensated kernels, q and q_lo (2i).  The EHL kernel K8 is
held against its twins and bit for bit against K1 on the statics they
form, with and without the reference shift (2h, 3j, 5).  The shard kernel
K9 is held bit for bit against its twin on every edge-flag pattern of a
2 x 2 and a 1 x 4 mesh, and the k-step shard sweep that the sharded
loops run against k K9 launches and its twin at k = 1..4, and on 1D
blocks against the serial sweep (2s); ``Problem.run_steps_sharded``
drives the four-edge D/N journal at 1024² on 1 x 1, 2 x 2 and 2 x 4
meshes of cuda:0 shards at every timed depth and the periodic journal
on 2 x 2, each bit for bit against the serial route, and the sharded
EHL loop at 512², held against its float64 route (3s).  Any failed
phase raises, which exits non-zero before the result line.
Without CUDA, or without the package beside it, the script fails the
same way.

Output: one line per measurement, then a JSON line with the kernels,
the ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

os.environ["GAPFLOW_X64"] = "0"          # float32 production precision
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TOL = 1e-5            # component-scaled max error, kernel vs plain twin
P_TOL = 2e-5          # relative max error of the GP kernel's pressure
ROUTE_TOL = 1e-4      # scaled max difference, kernel run vs plain-step run
# phase 3e: the compensated kernel route against the float64 plain step.
# The f32 plain step itself sits ~5e-4 from that run (its accumulation
# error); the Kahan carry must bring the kernel route well inside it.
COMP_ROUTE_TOL = 3e-4
SOMMERFELD_TOL = 0.02
# phase 2i: a k-step kernel against k launches of K1 or K3 on the same
# inputs.  They are expected equal bit for bit (the same operations in
# the same order); a difference is printed and held to this, scaled.
SAME_TOL = 1e-6
# phase 3o: bench.py bench_fv_step (journal, DH, dx 2e-5, dt 1e-11, tol
# 1e-30): run_steps_fast(FV_STEPS, compensated=False) at each size, a
# warm-up and 3 timed calls; FV_REM_STEPS adds one remainder launch
FV_STEPS = 5000
FV_SIZES = (512, 1024, 2048)
FV_REM_STEPS = 5003
PLAIN_CALL_STEPS = 1024   # phase 5: steps of a timed plain sweep call
PLAIN_ROUTE_STEPS = 100  # phase 3p: route agreement at 256²
THINNING_ENGAGED = 0.9   # phase 3c: the thinning factor must fall below
HBM_BYTES_PER_S = 3.35e12    # H100 SXM published peak
# float32 adds and multiplies: one per lane and clock, 128 lanes per SM,
# 132 SMs at the 1.98 GHz boost clock.  The published 67 TFLOP/s counts
# an FMA as two operations; the kernels build with --fmad=false, so
# nothing fuses and every operation issues on its own.
FP32_OPS_PER_S = 128 * 132 * 1.98e9
# sqrt and exp go through the special-function units: 16 results per
# clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), 132 SMs at the 1.98 GHz boost clock
MUFU_OPS_PER_S = 16 * 132 * 1.98e9
# Floating-point operations per cell and step of the stencil kernels, an
# upper estimate counted from csrc/stencil_common.cuh: closures ~75 and
# EOS/piezoviscosity up to ~30 per pass (thinning adds ~30), the one-sided
# update ~18, two passes plus the average or the Kahan two-sum.
OPS_PER_CELL = 300
# The compensated sweeps' bound (K2c, K3c): the two-sum's increment and
# carry take ~7 operations per component where the average takes 3, so
# ~12 more per cell and step.  Their bytes are one sweep's over its k
# steps: below the operations at the main paths' depth 3, above them at
# depth 1 (shear thinning).
COMP_OPS_PER_CELL = OPS_PER_CELL + 12
# FP32 operations per cell of the statics the EHL kernel K8 forms from the
# undeformed gap and the deformation (csrc/stencil_ehl.cu EhlStat::load;
# the least the work needs, once per cell): the gap h_und + (u - u00), two
# differences and their scalings, 4 Ls + H, 3 Ls + H, two divisions,
# 2 Ls, 6 Ls and the three products of 2 (3 Ls + H) ic ic.
EHL_STATICS_OPS = 17

_BAYADA = ("EOS: Bayada, rho0: 850., rho_l: 850., rho_v: 0.019, "
           "c_l: 1600., c_v: 352.")
# every EOS and piezoviscosity model the kernel gate admits, one step each
# at 64 x 128.  The perturbation (amplitude 0.01, as in phase 2) keeps the
# state's gradients well above float32 rounding of the EOS (DH's r - 1
# cancellation makes two correct f32 evaluations differ by more than the
# tolerance at smaller amplitudes); the piezoviscous DH cases use the
# softer C1 = 3.5e8 so that Roelands' (1 + p/p_ref)^z stays real.
_DH_SOFT = "EOS: DH, P0: 101325., rho0: 877.7007, C1: 3.5e8, C2: 1.23"
_MODEL_CASES = [
    ("DH", "EOS: DH, P0: 101325., rho0: 877.7007, C1: 3.5e10, C2: 1.23"),
    ("PL", "EOS: PL, rho0: 1.1853, P0: 101325., alpha: 0."),
    ("vdW", "EOS: vdW, rho0: 1."),
    ("MT", "EOS: MT, rho0: 700."),
    ("cubic", "EOS: cubic, rho0: 1."),
    ("BWR", "EOS: BWR, rho0: 0.7, T: 2."),
    ("Bayada", _BAYADA),
    ("DH+Barus", _DH_SOFT + ", piezo: {name: Barus}"),
    ("DH+Roelands", _DH_SOFT + ", piezo: {name: Roelands}"),
    ("Bayada+Dukler", _BAYADA + ", piezo: {name: Dukler}"),
    ("Bayada+McAdams", _BAYADA + ", piezo: {name: McAdams}"),
]

# examples/config/inclined_1d_powerlaw.yaml widened to 2D (Lx = Ly, Ny =
# Nx): D/N x edges, periodic y, power-law EOS
_INCLINED = """
options: {{output: data/smoke, write_freq: 100000, silent: True}}
grid: {{Lx: 1.e-3, Ly: 1.e-3, Nx: {n}, Ny: {n}, xE: ['D', 'N', 'N'],
        xW: ['D', 'N', 'N'], xE_D: 1.1853, xW_D: 1.1853}}
geometry: {{type: inclined, hmax: 1.e-5, hmin: 2.e-6, U: 5., V: 0.}}
numerics: {{CFL: 0.4, adaptive: {adaptive}, tol: 1e-30, dt: {dt},
           max_it: {max_it}}}
properties: {{shear: 1.85e-5, bulk: 0., EOS: PL, rho0: 1.1853, P0: 101325.,
             alpha: 0.}}
"""
# examples/config/asperity_2d_lj_gp.yaml without its gp:/db: sections
# (BWR, D/N on all four edges, LJ units), with Eyring shear thinning.
# tauE is set so that the thinning factor falls well below 1 (the
# Couette wall shear stress mu0 |V - U| / h is ~0.01 in LJ units where
# the gap is narrow); phase 3c prints its minimum.
_ASPERITY = """
options: {{output: data/smoke, write_freq: 100000, silent: True}}
grid: {{Lx: 1470., Ly: 1470., Nx: {n}, Ny: {n}, xE: ['D', 'N', 'N'],
        xW: ['D', 'N', 'N'], yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'],
        xE_D: 0.8, xW_D: 0.8, yS_D: 0.8, yN_D: 0.8}}
geometry: {{type: asperity, hmin: 12., hmax: 60., num: 2, seed: 0, U: 0.12,
           V: 0.06}}
numerics: {{CFL: 0.5, adaptive: {adaptive}, tol: 1e-30, dt: 0.05,
           max_it: {max_it}}}
properties: {{shear: 2.15, bulk: 0., EOS: BWR, T: 1.0, rho0: 0.8,
             thinning: {{name: Eyring, tauE: {tauE}}}}}
"""
ASPERITY_TAUE = 0.002
DEVICE = "cuda"
N = 1024              # main paths and timings
N_CHECK = 256         # kernel vs twin checks
MAX_IT = 4098         # 4096 steps of full sweeps + 2 remainder steps


def inclined_yaml(n, max_it, adaptive=1, dt=1e-10):
    return _INCLINED.format(n=n, max_it=max_it, adaptive=adaptive, dt=dt)


def asperity_yaml(n, max_it, tauE=ASPERITY_TAUE, adaptive=1):
    return _ASPERITY.format(n=n, max_it=max_it, tauE=tauE,
                            adaptive=adaptive)


def problem(text, dtype=None):
    from gapflow_torch import Problem
    return Problem.from_string(text, device=DEVICE, dtype=dtype)


def journal_yaml_for(nx, ny=None, grid="", props=None, dt=5e-11,
                     max_it=1000000):
    from gapflow_torch.validate import DH, journal_yaml
    return journal_yaml(nx, nx if ny is None else ny, grid, props or DH,
                        dt=dt, max_it=max_it, out="data/smoke")


def journal(nx, ny, grid="", props=None, dt=5e-11, max_it=1000000):
    return problem(journal_yaml_for(nx, ny, grid, props, dt, max_it))


def kernel_inputs(p, amp, seed=0, ghosted=False):
    """Interior q, statics (interior, or ghost-inclusive for the boundary
    kernels) and dt of a perturbed state on the card."""
    from gapflow_torch.ops.stencil import ghost_statics, interior_statics
    from gapflow_torch.validate import perturbed_state
    p._pre_run()
    st = perturbed_state(p, seed=seed, amp=amp)
    q = st.q[:, 1:-1, 1:-1].contiguous()
    statics = ghost_statics if ghosted else interior_statics
    return q, statics(st.topo, st.extra, torch.float32, q.device), p.dt


def mixed_inputs(p, amp, seed=0):
    """Ghost-inclusive q, statics and the carried ghost lines (standing in
    for the band lines) of a perturbed mixed-edge state on the card."""
    from gapflow_torch.ops.stencil import ghost_statics
    from gapflow_torch.validate import perturbed_state
    p._pre_run()
    st = perturbed_state(p, seed=seed, amp=amp)
    q_g = st.q.contiguous()
    gx = q_g[:, [0, -1]].contiguous()
    gy = q_g[:, :, [0, -1]].transpose(1, 2).contiguous()
    return q_g, ghost_statics(st.topo, st.extra, torch.float32,
                              q_g.device), gx, gy, p.dt


def errors(label, out, ref):
    """(scaled, abs) max error of ``out`` against ``ref``, both finite."""
    from gapflow_torch.validate import kernel_vs_plain_err
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise RuntimeError(f"{label}: non-finite values")
    return kernel_vs_plain_err(out, ref), float((out - ref).abs().max())


def check(label, out, ref):
    err, abs_err = errors(label, out, ref)
    print(f"  {label}: max scaled err {err:.3e}, max abs err {abs_err:.3e}")
    if not err < TOL:
        raise RuntimeError(f"{label}: scaled err {err} >= {TOL}")
    return abs_err


def once_n(once):
    """A one-step compensated wrapper in the form ``f(q, lo, st, dt, cfg,
    1)`` of :func:`check_comp_steps`."""
    def run(q, lo, st, dt, cfg, n):
        assert n == 1
        return once(q, lo, st, dt, cfg)
    return run


def check_comp_steps(label, kernel, twin, q, lo, st, dt, cfg, n=8):
    """A compensated kernel held against its twin over ``n`` steps, each
    step launched from the twin's ``(q, q_lo)`` carry.  Where the model is
    ill-conditioned in float32 (BWR's cancellation under Eyring thinning),
    a last-bit difference grows by orders of magnitude within a step or
    two, so runs that each go their own way are compared only in the
    printout, beside the twin's own distance after a one-ulp nudge of
    the density."""
    from gapflow_torch.validate import kernel_vs_plain_err
    g = torch.Generator(device=q.device).manual_seed(0)
    up = torch.rand(q[0].shape, generator=g, device=q.device) < 0.5
    nudged = q.clone()
    nudged[0] = torch.where(up, torch.nextafter(q[0], q[0] + 1),
                            torch.nextafter(q[0], q[0] - 1))
    qr, lr, qk, lk, qs, ls = q, lo, q, lo, nudged, lo
    err = abs_err = 0.
    for _ in range(n):
        step = kernel(qr, lr, st, dt, cfg, 1)
        qk, lk = kernel(qk, lk, st, dt, cfg, 1)
        qr, lr = twin(qr, lr, st, dt, cfg, 1)
        qs, ls = twin(qs, ls, st, dt, cfg, 1)
        e, a = errors(label, step[0], qr)
        err, abs_err = max(err, e), max(abs_err, a)
        if not (torch.isfinite(step[1]).all() and torch.isfinite(lk).all()):
            raise RuntimeError(f"{label}: non-finite Kahan carry")
    print(f"  {label} x{n}, each step from the twin's carry: max scaled err "
          f"{err:.3e}, max abs err {abs_err:.3e}; after {n} steps on its "
          f"own {kernel_vs_plain_err(qk, qr):.3e}, the twin after a one-ulp "
          f"nudge {kernel_vs_plain_err(qs, qr):.3e}")
    if not err < TOL:
        raise RuntimeError(f"{label}: scaled err {err} >= {TOL}")
    return abs_err


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps, spin_s=0.2):
    """Device time per call of ``fn``: events around ``reps`` calls
    enqueued behind a spin kernel of ``spin_s`` seconds, so that the card
    runs them back to back however long the host takes to launch each
    (a launch shorter than its wrapper's host work is timed right).
    Raises if the host took longer to enqueue them than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 1.98e9))     # cycles at the boost clock
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host >= spin_s / 2:
        raise RuntimeError(f"queued_ms: enqueueing took {host:.3f} s, not "
                           f"well inside the {spin_s} s spin")
    return start.elapsed_time(end) / reps


# torch.profiler keeps only the device events whose times, converted to
# the host's clock, fall inside its capture window, and the card's clock
# drifts from the host's as a process ages: on an H100, five 1024² GP
# steps (a 3 ms window) lost 4 of 20 kernels after two minutes of work
# and all of them after five.  Idle host time on both sides of the
# profiled region keeps every kernel inside the window (all 20 after
# nine minutes with 0.5 s each side).
PROFILE_PAD_S = 0.5


def profiled(fn, reps=1):
    """torch.profiler (CPU and CUDA activity) over ``reps`` calls of
    ``fn`` after one warm-up call, the calls between PROFILE_PAD_S seconds
    of idle host time on each side; returns the profile."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return prof


def bound(ins, outs, cells, ops=OPS_PER_CELL):
    """(bound_ms, bound_by): each input read once and each output written
    once at the HBM rate, against ``ops`` per cell at the fp32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * cells / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def drive(label, p, expect, absent=()):
    """Problem.run() on one main path with the launch counts set to 0
    just before it; checks the route, the launches (at least ``expect``,
    none of ``absent``) and the state."""
    from gapflow_torch.ops import stencil as S
    n = p.grid["Nx"] * p.grid["Ny"]
    torch.cuda.synchronize()
    S.reset_launches()
    t0 = time.perf_counter()
    p.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(S.LAUNCHES)
    print(f"  {label}: route {p._route}, steps {p.step}, launches "
          f"{ {k: v for k, v in launches.items() if v} }, wall {wall:.3f} s, "
          f"{n * p.step / wall:.4e} cell-updates/s")
    if p._route != "run_compiled_fast":
        raise RuntimeError(f"{label} took {p._route}")
    if p.step != p.max_it:
        raise RuntimeError(f"{label} stopped at step {p.step}")
    for k, least in expect.items():
        if launches[k] < least:
            raise RuntimeError(f"{label} missed a kernel: {launches}")
    if any(launches[k] for k in absent):
        raise RuntimeError(f"{label} launched one of {absent}: {launches}")
    if not (np.isfinite(p.q).all() and (p.q[0] > 0).all()):
        raise RuntimeError(f"{label}: non-finite q or rho <= 0")
    return launches


def comp_sweep_row(label, steps, once, twin, q, st, dt, cfg, reps,
                   plain_reps, chaotic=False):
    """A compensated sweep at the main path's depth k from a nonzero carry
    (8 one-step compensated steps first): bit for bit against k one-step
    launches, against its twin (``chaotic``: over one step, as in
    check_comp_steps), then timed per step over ``reps`` sweeps in one
    call.  Returns (max abs err, (ms, twin ms), (bound, by)), the bound
    per step at the deepest sweep the kernel takes."""
    from gapflow_torch.ops import stencil as S
    k = S._comp_k_steps(cfg)
    lo = torch.zeros_like(q)
    for _ in range(8):
        q, lo = once(q, lo, st, dt, cfg)
    out = steps(q, lo, st, dt, cfg, k)
    ref = (q, lo)
    for _ in range(k):
        ref = once(*ref, st, dt, cfg)
    check_bits(f"{label} k={k} vs {k} x one-step kernel", out, ref)
    n = 1 if chaotic else k
    err = check(f"{label} n={n} vs twin (q)",
                steps(q, lo, st, dt, cfg, n)[0],
                twin(q, lo, st, dt, cfg, n)[0])
    ms = time_ms(lambda: steps(q, lo, st, dt, cfg, reps * k), 1) / (reps * k)
    plain_ms = time_ms(lambda: twin(q, lo, st, dt, cfg, 1), plain_reps)
    # the least the work needs: one sweep's bytes over the deepest sweep
    # the kernel takes (_k_steps), whatever depth the main path chose
    kmax = S._k_steps(cfg)
    b = bound((q, lo, st), (q, lo), q[0].numel(), kmax * COMP_OPS_PER_CELL)
    return err, (ms, plain_ms), (b[0] / kmax, b[1])


def kernel_times(n=N, reps=200, plain_reps=20):
    """The five kernels at n x n on the inputs of the main paths (and the
    compensated K3 with thinning on the asperity contact): each held
    against its plain twin, then timed; the compensated sweeps K2c/K3c
    (the main paths' kernels) beside the one-step compensated kernels
    (their witnesses).  Returns {kernel: max abs err}, {kernel: (ms,
    plain twin ms)} and {kernel: (bound_ms, bound_by)}; times are events
    over ``reps`` launches after a warm-up (the sweeps: ``reps`` sweeps
    in one call), the twins over ``plain_reps``."""
    from gapflow_torch.ops import mixed_bc as M
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.validate import MIXED_CASES
    cells = n * n
    errs, times, bounds = {}, {}, {}

    def check_step(label, kernel, twin, *args):
        return check(label, kernel(*args), twin(*args))

    tp = journal(n, n, dt=1e-11)
    cfg = tp._solver_cfg
    q, st, dt = kernel_inputs(tp, amp=0.01)
    lo = torch.zeros_like(q)
    errs["fused_step"] = check_step("K1 journal", S.fused_step,
                                    S.fused_step_ref, q, st, dt, cfg)
    errs["comp_step"] = check_comp_steps(
        "K2 journal comp_step_once", once_n(S.comp_step_once),
        S.comp_steps_ref, q, lo, st, dt, cfg)
    times["fused_step"] = (
        time_ms(lambda: S.fused_step(q, st, dt, cfg), reps),
        time_ms(lambda: S.fused_step_ref(q, st, dt, cfg), plain_reps))
    times["comp_step"] = (
        time_ms(lambda: S.comp_step_once(q, lo, st, dt, cfg), reps),
        time_ms(lambda: S.comp_steps_ref(q, lo, st, dt, cfg, 1), plain_reps))
    errs["comp_sweep"], times["comp_sweep"], bounds["comp_sweep"] = \
        comp_sweep_row("K2c journal comp_steps", S.comp_steps,
                       S.comp_step_once, S.comp_steps_ref, q, st, dt, cfg,
                       reps, plain_reps)
    bounds["fused_step"] = bound((q, st), (q,), cells)
    bounds["comp_step"] = bound((q, lo, st), (q, lo), cells)

    tb = problem(inclined_yaml(n, MAX_IT))
    cfg = tb._solver_cfg
    q, st, dt = kernel_inputs(tb, amp=0.01, ghosted=True)
    lo = torch.zeros_like(q)
    errs["fused_step_bc"] = check_step("K3 inclined", S.fused_step_bc,
                                       S.fused_step_bc_ref, q, st, dt, cfg)
    errs["comp_step_bc"] = check_comp_steps(
        "K3 inclined comp_step_bc_once", once_n(S.comp_step_bc_once),
        S.comp_steps_bc_ref, q, lo, st, dt, cfg)
    times["fused_step_bc"] = (
        time_ms(lambda: S.fused_step_bc(q, st, dt, cfg), reps),
        time_ms(lambda: S.fused_step_bc_ref(q, st, dt, cfg), plain_reps))
    times["comp_step_bc"] = (
        time_ms(lambda: S.comp_step_bc_once(q, lo, st, dt, cfg), reps),
        time_ms(lambda: S.comp_steps_bc_ref(q, lo, st, dt, cfg, 1),
                plain_reps))
    errs["comp_sweep_bc"], times["comp_sweep_bc"], \
        bounds["comp_sweep_bc"] = comp_sweep_row(
            "K3c inclined comp_steps_bc", S.comp_steps_bc,
            S.comp_step_bc_once, S.comp_steps_bc_ref, q, st, dt, cfg, reps,
            plain_reps)
    bounds["fused_step_bc"] = bound((q, st), (q,), cells)
    bounds["comp_step_bc"] = bound((q, lo, st), (q, lo), cells)

    # the thinning variant of K3 (halo 4), on the asperity contact
    ta = problem(asperity_yaml(n, MAX_IT))
    cfg = ta._solver_cfg
    q, st, dt = kernel_inputs(ta, amp=0.01, ghosted=True)
    lo = torch.zeros_like(q)
    errs["fused_step_bc"] = max(errs["fused_step_bc"], check_step(
        "K3 asperity Eyring", S.fused_step_bc, S.fused_step_bc_ref,
        q, st, dt, cfg))
    errs["comp_step_bc"] = max(errs["comp_step_bc"], check_comp_steps(
        "K3 asperity Eyring comp_step_bc_once",
        once_n(S.comp_step_bc_once), S.comp_steps_bc_ref, q, lo, st, dt,
        cfg))
    times["comp_step_bc (Eyring)"] = (
        time_ms(lambda: S.comp_step_bc_once(q, lo, st, dt, cfg), reps),
        time_ms(lambda: S.comp_steps_bc_ref(q, lo, st, dt, cfg, 1),
                plain_reps))
    bounds["comp_step_bc (Eyring)"] = bound((q, lo, st), (q, lo), cells)
    e, times["comp_sweep_bc (Eyring)"], bounds["comp_sweep_bc (Eyring)"] = \
        comp_sweep_row("K3c asperity Eyring comp_steps_bc", S.comp_steps_bc,
                       S.comp_step_bc_once, S.comp_steps_bc_ref, q, st, dt,
                       cfg, reps, plain_reps, chaotic=True)
    errs["comp_sweep_bc"] = max(errs["comp_sweep_bc"], e)

    tm = journal(n, n, MIXED_CASES["both_mixed"], dt=2e-11)
    cfg = tm._solver_cfg
    q_g, st, gx, gy, dt = mixed_inputs(tm, amp=0.01)
    errs["mixed_step"] = max(
        check(f"K4 both_mixed emit_delta={d}",
              M.mixed_step(q_g, st, gx, gy, dt, cfg, emit_delta=d),
              M.mixed_step_ref(q_g, st, gx, gy, dt, cfg, emit_delta=d))
        for d in (False, True))
    times["mixed_step"] = (
        time_ms(lambda: M.mixed_step(q_g, st, gx, gy, dt, cfg), reps),
        time_ms(lambda: M.mixed_step_ref(q_g, st, gx, gy, dt, cfg),
                plain_reps))
    bounds["mixed_step"] = bound((q_g, st, gx, gy), (q_g[:, 1:-1, 1:-1],),
                                 cells)
    return errs, times, bounds


# bench.py bench_gp_al_e2e, the JAX package's end-to-end GP stage: 1024²
# journal, DH, pressure and both wall-stress surrogates, lhc init of 4
# points on the mock oracle, fixed dt 5e-11
_GP_JOURNAL = """
options: {{output: data/smoke, write_freq: 1000000, use_tstamp: False,
          silent: True}}
grid: {{dx: 2.e-5, dy: 2.e-5, Nx: {n}, Ny: {n}}}
geometry: {{type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.05}}
numerics: {{CFL: 0.25, adaptive: 0, tol: 1e-30, dt: 5e-11, max_it: {max_it}}}
properties: {{shear: 0.0794, bulk: 0., EOS: DH, P0: 101325.,
             rho0: 877.7007, C1: 3.5e10, C2: 1.23}}
gp:
    press: {{fix_noise: True, atol: 1.e-2, rtol: 0., obs_stddev: 1.e-3,
            max_steps: 2, active_learning: {al}}}
    shear: {{fix_noise: True, atol: 1.e-2, rtol: 0., obs_stddev: 1.e-4,
            max_steps: 2, active_learning: {al}}}
db: {{init_size: 4, init_method: lhc, dtool_path: {dtool}{width}}}
"""
GP_MAX_IT = 200
GP_CAP = 64           # phase 5: training points per surrogate
GP_CHECK_CAPS = (16, 48, 128, 200, 256)
# phase 3i: the GP journal of 3f at 128², 50 steps with active learning,
# the kernel route against the plain GP step run in float64.  Its initial
# samples spread the density by +-20 %, not 3f's +-1 %: from 3f's the
# pressure GP's kernel saturates (every training point within a small
# fraction of a length scale), its mean lives in the last bits of the
# kernel values, and any float32 evaluation of it is rounding (phase 3i
# prints one step of each).  The limit is about three times the f32
# plain step's own distance to the float64 run after 50 steps (4.256e-3
# on the H100); both f32 routes carry the DH EOS's float32 rounding.
# Against the f32 plain step the kernel route is held to ROUTE_TOL.
GP_ROUTE_N, GP_ROUTE_STEPS, GP_ROUTE_WIDTH = 128, 50, 0.2
GP_ROUTE_TOL = 1.2e-2


def gp_journal_yaml(n, al=True, max_it=GP_MAX_IT, init_width=None):
    """The bench_gp_al_e2e journal at n x n with a fresh database
    directory; ``init_width`` replaces the default relative density
    spread (0.01) of the initial samples."""
    import tempfile
    width = "" if init_width is None else f", init_width: {init_width}"
    return _GP_JOURNAL.format(n=n, max_it=max_it, al=al, width=width,
                              dtool=tempfile.mkdtemp(prefix="gp_train_"))


def gp_asperity_yaml(n, max_it=GP_MAX_IT):
    """examples/config/asperity_2d_lj_gp.yaml (BWR, D/N on four edges, LJ
    units, mock oracle, active learning) widened to n x n, silent, at its
    dt held fixed, with a fresh database directory.  The asperity depths
    are drawn from seed 0 (the file draws them unseeded, a new surface
    in every run)."""
    import tempfile
    import yaml
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "config", "asperity_2d_lj_gp.yaml")
    with open(path) as fh:
        d = yaml.safe_load(fh)
    d["options"].update(silent=True, output="data/smoke")
    d["grid"].update(Nx=n, Ny=n)
    d["numerics"].update(adaptive=0, max_it=max_it)
    d["geometry"]["seed"] = 0
    d["db"]["dtool_path"] = tempfile.mkdtemp(prefix="gp_train_")
    return yaml.safe_dump(d)


def check_p(label, out, ref):
    """The GP kernel's pressure against its twin's: relative max error."""
    err = float((out - ref).abs().max() / ref.abs().max())
    print(f"  {label} pressure: max relative err {err:.3e}")
    if not err < P_TOL:
        raise RuntimeError(f"{label}: pressure err {err} >= {P_TOL}")
    return float((out - ref).abs().max())


def gp_check(label, p, cap, steps=0, exact=True):
    """One GP kernel step (or ``steps`` frozen steps) against its twin on
    a synthetic state of ``cap`` points per surrogate, scaled like the
    Problem's database; with ``exact``, bit for bit (q and the pressure).
    Returns the max abs error."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import gp_kernel_inputs
    cfg = p._solver_cfg
    periodic = S._fully_periodic(cfg)
    q, st, dt, ops, _ = gp_kernel_inputs(p, cap, ghosted=not periodic,
                                         db_scales=True)
    if steps:
        pairs = [(f"{label} gp_steps x{steps}",
                  G.gp_steps(q, st, dt, cfg, ops, steps),
                  G.gp_steps_ref(q, st, dt, cfg, ops, steps), None, None)]
    else:
        if periodic:
            name = "gp_step"
            (qk, pk), (qr, pr) = (G.gp_step(q, st, dt, cfg, ops),
                                  G.gp_step_ref(q, st, dt, cfg, ops))
        else:
            name = "gp_step_bc"
            (qk, pk), (qr, pr) = (G.gp_step_bc(q, st, dt, cfg, ops, True),
                                  G.gp_step_bc_ref(q, st, dt, cfg, ops,
                                                   True))
        pairs = [(f"{label} {name}", qk, qr, pk, pr)]
    err = 0.
    for lab, out, ref, p_out, p_ref in pairs:
        err = max(err, check(lab, out, ref))
        if p_out is not None:
            err = max(err, check_p(lab, p_out, p_ref))
        for what, a, b in (("", out, ref), (" pressure", p_out, p_ref)):
            if a is None:
                continue
            if exact:
                check_equal(lab + what, a, b)
            else:
                print(f"  {lab}{what}: "
                      f"{'equal' if torch.equal(a, b) else 'NOT equal'} bit "
                      f"for bit")
    return err


def gp_fields_checks():
    """Phase 2g: the means kernel alone against its twin, bit for bit,
    for each body it compiles (d = 1-7 features, 1-2 outputs; 200 points
    of synthetic surrogates on a perturbed journal state) and for three
    surrogates in one launch; the written-out sqrt against sqrtf over
    validate.sqrt_sweep."""
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import (journal_problem, perturbed_state,
                                        sqrt_sweep, synthetic_gp_ops)
    from gapflow_torch.ops.stencil import interior_statics
    pj = journal_problem(N_CHECK, N_CHECK, device=DEVICE)
    pj._pre_run()
    ps = perturbed_state(pj, seed=0, amp=0.01)
    q = ps.q.float()[:, 1:-1, 1:-1].contiguous()
    st = interior_statics(ps.topo, ps.extra, torch.float32, q.device)
    for d in range(1, 8):
        for n_out in (1, 2):
            ops = synthetic_gp_ops([("z", d, n_out)], 200, 10 * d + n_out,
                                   DEVICE)
            check_equal(f"gp_fields d {d} n_out {n_out} cap 200",
                        G.gp_fields(q, st, ops)["z"],
                        G.gp_fields_ref(q, st, ops)["z"])
    ops = synthetic_gp_ops([("z", 2, 1), ("x", 3, 2), ("y", 7, 2)], 48, 5,
                           DEVICE)
    got, ref = G.gp_fields(q, st, ops), G.gp_fields_ref(q, st, ops)
    for k in got:
        check_equal(f"gp_fields z, x, y together: {k}", got[k], ref[k])
    inside, above = sqrt_sweep()
    fast, ref = G.sqrt_pair(torch.as_tensor(inside, device=DEVICE))
    check_equal(f"written-out sqrt vs sqrtf, {inside.size} arguments in "
                f"[3e-14, 2^125]", fast, ref)
    fast, ref = G.sqrt_pair(torch.as_tensor(above, device=DEVICE))
    for arg in (fast, ref):
        e = torch.exp(-arg)
        if not (torch.isfinite(arg).all() and (e + arg * e == 0).all()):
            raise RuntimeError("sqrt above 2^125: a Matern value is not 0")
    print(f"  above 2^125 ({above.size} arguments): both sqrts finite, "
          f"min {float(fast.min()):.4e} and {float(ref.min()):.4e}, Matern "
          f"value 0 in both")


def gp_problem(text, dtype=None):
    """A GP Problem after its pre-run (database initialisation on the mock
    oracle, BFGS fits, the fields before step 0); prints its time."""
    import contextlib
    import io
    p = problem(text, dtype)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        p._pre_run()
    torch.cuda.synchronize()
    print(f"  pre-run (database of {p.database.size}, fits, fields): "
          f"{time.perf_counter() - t0:.3f} s")
    return p


def drive_gp(label, p, route, expect):
    """Problem.run() on a GP path with every launch count set to 0 just
    before it; checks the route, the launches and the state, and prints
    the run's counters.  Returns (launches, wall)."""
    import contextlib
    import io
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    n = p.grid["Nx"] * p.grid["Ny"]
    torch.cuda.synchronize()
    S.reset_launches()
    G.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        p.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**S.LAUNCHES, **G.LAUNCHES}
    models = [m for m in (p.pressure, p.wall_stress_xz, p.wall_stress_yz)
              if m.is_gp_model]
    train = sum(m.cumtime_train.total_seconds() for m in models)
    infer = sum(m.cumtime_infer.total_seconds() for m in models)
    st = p.al_stats
    print(f"  {label}: route {p._route}, steps {p.step}, launches "
          f"{ {k: v for k, v in launches.items() if v} }, wall {wall:.3f} s, "
          f"{n * p.step / wall:.4e} cell-updates/s; acquisitions "
          f"{st['acquisitions']}, database {p.database.size}, variance "
          f"checks {st['checks']}, advance {st['advance_s']:.3f} s, host "
          f"protocol {st['host_s']:.3f} s, GP train {train:.3f} s, GP infer "
          f"{infer:.3f} s (pre-run included)")
    if p._route != route:
        raise RuntimeError(f"{label} took {p._route}")
    if p.step != p.max_it:
        raise RuntimeError(f"{label} stopped at step {p.step}")
    for k, least in expect.items():
        if launches[k] < least:
            raise RuntimeError(f"{label} missed a kernel: {launches}")
    if sum(v for k, v in launches.items() if k not in expect):
        raise RuntimeError(f"{label} launched other kernels: {launches}")
    if not (np.isfinite(p.q).all() and (p.q[0] > 0).all()):
        raise RuntimeError(f"{label}: non-finite q or rho <= 0")
    return launches, wall


def gp_breakdown(label, p, launches, wall, kernel, reps=20):
    """The run's kernel held against its twin on the run's own final
    state and operands (the surrogates it trained, conditioned at the
    capacity it stepped with), then where the wall time went: the kernel
    (its launches times its time there), the AL variance checks (their
    count times one check's time on the final state), the host protocol
    (acquisitions, BFGS, dense variance, buffer rebuild: the run's own
    clock) and the rest (synchronisation, ghost refills, launch
    overhead, between-chunk statistics).  Returns the max abs error."""
    from gapflow_torch.core.al_chunked import (_next_capacity,
                                               _surrogate_specs, gp_state_of,
                                               init_gp_states)
    from gapflow_torch.core.gp_step import _features
    from gapflow_torch.models import al_jit
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import gp_dims_use
    cfg = p._solver_cfg
    db = p.database
    dims, use = gp_dims_use(p)
    # the capacities run_gp_al_chunked and run_steps_gp_fast condition at
    cap = _next_capacity(db.size + (1 if p._route == "gp_chunked" else 0))
    gps, _ = init_gp_states(p, cap)
    models = dict(zip("zxy", (p.pressure, p.wall_stress_xz,
                              p.wall_stress_yz)))
    state = gp_state_of(gps, p._tensor(db.X_scale),
                        {k: p._tensor(models[k].Yscale) for k in gps})
    ops = G.prep_gp_ops(state, dims, use)
    qg = p._tensor(p.q)
    q = qg[:, 1:-1, 1:-1].contiguous()
    topo = p._tensor(p.topo.full)
    extra = p._tensor(p.fc.get_real_field("extra").p)
    periodic = S._fully_periodic(cfg)
    st = (S.interior_statics if periodic else S.ghost_statics)(
        topo, extra, torch.float32, q.device)
    own = f"{label}, the run's own state and surrogates (capacity {cap})"
    if kernel == "gp_steps":
        abs_err = check(f"{own}: gp_steps x8",
                        G.gp_steps(q, st, p.dt, cfg, ops, 8),
                        G.gp_steps_ref(q, st, p.dt, cfg, ops, 8))
        k_ms = time_ms(lambda: G.gp_steps(q, st, p.dt, cfg, ops, reps),
                       1) / reps
    elif kernel == "gp_step":
        (qk, pk), (qr, pr) = (G.gp_step(q, st, p.dt, cfg, ops),
                              G.gp_step_ref(q, st, p.dt, cfg, ops))
        abs_err = max(check(f"{own}: gp_step", qk, qr),
                      check_p(f"{own}: gp_step", pk, pr))
        # the advance discards the pressure: the variant without it
        k_ms = time_ms(lambda: G.gp_step(q, st, p.dt, cfg, ops,
                                         need_p=False), reps)
    else:
        abs_err = check(f"{own}: gp_step_bc",
                        G.gp_step_bc(q, st, p.dt, cfg, ops),
                        G.gp_step_bc_ref(q, st, p.dt, cfg, ops))
        k_ms = time_ms(lambda: G.gp_step_bc(q, st, p.dt, cfg, ops), reps)
    t_kernel = launches[kernel] * k_ms / 1e3
    specs = _surrogate_specs(p)
    t_check = 0.
    Xf = (_features(qg, topo, extra).reshape(db.num_features, -1).T
          / p._tensor(db.X_scale)[None, :])
    for k, spec in specs.items():
        t_check += time_ms(lambda: al_jit.predict(
            gps[k], Xf[:, list(spec.dims)])[1].max(), reps) / len(specs)
    checks = p.al_stats["checks"]
    t_var = checks * t_check / 1e3
    t_host = p.al_stats["host_s"]
    print(f"  {label} breakdown (capacity {cap}, final "
          f"state): wall {wall:.3f} s = kernel {t_kernel:.3f} s "
          f"({launches[kernel]} x {k_ms:.4f} ms) + variance checks "
          f"{t_var:.3f} s ({checks} x {t_check:.4f} ms) + host protocol "
          f"{t_host:.3f} s + rest {wall - t_kernel - t_var - t_host:.3f} s; "
          f"kernel share {t_kernel / wall:.3f}")
    return abs_err


def compare_triggers(a, b):
    """Prints two AL runs' device triggers ``(step, surrogate, peak /
    tol, verdict)``; raises at the first one in which they differ."""
    for label, t in (("first", a), ("second", b)):
        print(f"  {label} run: {sum(v == 'acquired' for *_, v in t)} "
              f"acquisitions, {len(t)} triggers: "
              + " ".join(f"{s}:{k}:{r:.6f}:{v}" for s, k, r, v in t))
    diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))
    if diff is not None:
        raise RuntimeError(f"the runs part at trigger {diff}: "
                           f"{a[diff] if diff < len(a) else None} vs "
                           f"{b[diff] if diff < len(b) else None}")
    print("  the two runs triggered identically")


def gp_one_step(width):
    """One GP step of the 3f journal at GP_ROUTE_N² from its initial
    state and its initial float64 fits: the kernel route in float32
    against the plain GP step in float64.  Returns (q scaled max error,
    p relative max error)."""
    from gapflow_torch import Problem
    from gapflow_torch.core.al_chunked import (_next_capacity, gp_state_of,
                                               init_gp_states)
    from gapflow_torch.core.gp_step import make_gp_step_core
    from gapflow_torch.validate import gp_dims_use, kernel_vs_plain_err
    p = gp_problem(gp_journal_yaml(GP_ROUTE_N, max_it=1, init_width=width),
                   dtype=torch.float64)
    db = p.database
    gps, _ = init_gp_states(p, _next_capacity(db.size))
    models = dict(zip("zxy", (p.pressure, p.wall_stress_xz,
                              p.wall_stress_yz)))
    state = gp_state_of(gps, p._tensor(db.X_scale),
                        {k: p._tensor(models[k].Yscale) for k in gps})
    dims, use = gp_dims_use(p)
    step = make_gp_step_core(p._solver_cfg, dims, db.num_features, use)
    q, topo, extra = (p._tensor(a) for a in (
        p.q, p.topo.full, p.fc.get_real_field("extra").p))
    if step.route(q.float()) != "gp_step":
        raise RuntimeError("the float32 state does not take the GP kernel")
    q64, p64 = step(q, topo, extra, p.dt, 0, state)
    q32, p32 = step(q.float(), topo.float(), extra.float(), p.dt, 0, state)
    return (kernel_vs_plain_err(q32.double(), q64),
            float((p32.double() - p64).abs().max() / p64.abs().max()))


def gp_route_check():
    """Phase 3i: the AL route at GP_ROUTE_N² for GP_ROUTE_STEPS steps on
    the card three times from one state and one database
    initialisation: on the GP kernels in float32, on the plain GP step in
    float32 and on the plain GP step in float64.  Holds the kernel route
    to the float64 run (the same acquisitions, q within GP_ROUTE_TOL
    scaled) and prints every distance; first, one step of each at 3f's
    and at this phase's initial density spread."""
    import contextlib
    import io
    from gapflow_torch import Problem
    from gapflow_torch.core.al_chunked import run_gp_al_chunked
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import kernel_vs_plain_err
    for width in (0.01, GP_ROUTE_WIDTH):
        q_err, p_err = gp_one_step(width)
        print(f"  one step from the initial fits, initial density spread "
              f"+-{width:g}: kernel route (f32) vs plain GP step (f64): q "
              f"{q_err:.3e} scaled, p {p_err:.3e} relative")
    n, steps = GP_ROUTE_N, GP_ROUTE_STEPS
    q0, runs = None, {}
    for label, dtype, kernels in (("kernel route f32", torch.float32, True),
                                  ("plain step f32", torch.float32, False),
                                  ("plain step f64", torch.float64, False)):
        p = Problem.from_string(
            gp_journal_yaml(n, max_it=steps, init_width=GP_ROUTE_WIDTH),
            device=DEVICE, dtype=dtype)
        # one initial state, of float32 values, in all three runs
        q0 = np.array(p.q, dtype=np.float32) if q0 is None else q0
        p.q[...] = q0
        with contextlib.redirect_stdout(io.StringIO()):
            p._pre_run()
            torch.cuda.synchronize()
            S.reset_launches()
            G.reset_launches()
            acq = run_gp_al_chunked(p, steps, allow_pallas=kernels)
            torch.cuda.synchronize()
        launched = {k: v for k, v in {**S.LAUNCHES, **G.LAUNCHES}.items()
                    if v}
        print(f"  {label}: acquisitions {acq}, database "
              f"{p.database.size}, launches {launched}")
        if launched != ({"gp_step": steps} if kernels else {}):
            raise RuntimeError(f"{label}: unexpected launches {launched}")
        if not (np.isfinite(p.q).all() and (p.q[0] > 0).all()):
            raise RuntimeError(f"{label}: non-finite q or rho <= 0")
        runs[label] = (torch.as_tensor(p.q, dtype=torch.float64), acq,
                       p.database._Xtrain.copy())
    (qk, ak, Xk), (qp, ap, Xp), (q64, a64, X64) = runs.values()
    if not ak == ap == a64:
        raise RuntimeError(f"the routes acquired {ak}, {ap}, {a64} points")
    scale = np.abs(X64).max(axis=0)
    scale = np.where(scale > 0, scale, 1.)
    x_err = [float((np.abs(X - X64) / scale).max()) for X in (Xk, Xp)]
    d_k64, d_p64 = (kernel_vs_plain_err(q, q64) for q in (qk, qp))
    d_kp = kernel_vs_plain_err(qk, qp)
    print(f"  acquired X, scaled max difference to the float64 run: kernel "
          f"route {x_err[0]:.3e}, f32 plain step {x_err[1]:.3e}")
    print(f"  q, scaled max difference to the float64 run: kernel route "
          f"{d_k64:.3e}, f32 plain step {d_p64:.3e}; kernel route vs f32 "
          f"plain step {d_kp:.3e}")
    if not (np.isfinite(d_k64) and d_k64 < GP_ROUTE_TOL):
        raise RuntimeError(f"GP kernel route vs float64 plain step: {d_k64} "
                           f">= {GP_ROUTE_TOL}")
    if not (np.isfinite(d_kp) and d_kp < ROUTE_TOL):
        raise RuntimeError(f"GP kernel route vs float32 plain step: {d_kp} "
                           f">= {ROUTE_TOL}")


def gp_bound(cells, ops):
    """(bound_ms, bound_by, (HBM ms, FP32 ms, MUFU ms)) of one GP-closed
    step without the pressure output: q and the 8 statics read and q
    written once; per cell and pass, for every surrogate and training
    point 2d + 8 + 2 n_out FP32 operations (the scaled distance, clamp,
    sqrt, exp, Matern and sums; sqrt and exp among them, at the MUFU rate
    too) plus 3d for its features, and OPS_PER_CELL for the closures and
    updates."""
    nbytes = cells * 4 * (3 + 8 + 3)
    fp32 = mufu = 0
    for dims, _, W, _, a in ops.models.values():
        cap, d = W.shape
        fp32 += 2 * (cap * (2 * d + 8 + 2 * a.shape[1]) + 3 * d)
        mufu += 2 * cap * 2
    parts = (nbytes / HBM_BYTES_PER_S * 1e3,
             cells * (OPS_PER_CELL + fp32) / FP32_OPS_PER_S * 1e3,
             cells * mufu / MUFU_OPS_PER_S * 1e3)
    if parts[0] >= max(parts[1:]):
        return parts[0], "bytes", parts
    return max(parts[1:]), "operations", parts


def gp_pair_ms(cells, ops):
    """Bound of one pass's means (ms): for every surrogate and training
    point 2d + 8 + 2 n_out FP32 operations, sqrt and exp among them at
    the MUFU rate too, the larger of the two (gp_bound's pair part)."""
    fp32 = mufu = 0
    for dims, _, W, _, a in ops.models.values():
        cap, d = W.shape
        fp32 += cap * (2 * d + 8 + 2 * a.shape[1])
        mufu += cap * 2
    return max(cells * fp32 / FP32_OPS_PER_S, cells * mufu / MUFU_OPS_PER_S) \
        * 1e3


def gp_profile(q, st, dt, cfg, ops, reps=5):
    """gp_step (need_p=False) under torch.profiler over ``reps`` steps,
    its device time per step split by kernel (the means before each pass,
    the two passes), each beside its bound: a pass's means at
    gp_pair_ms, a pass's stencil at OPS_PER_CELL / 2 operations or its
    bytes (state, statics and the fields read, its output written).
    Raises if the steps called cudaLaunchKernel other than
    ops.stencil_gp.kernel_launches times a step (the profiler's host-side
    records of the runtime API).  The split needs the device record of
    every kernel; where the profiler kept fewer, it says how many.
    Returns whether it printed the split."""
    from gapflow_torch.ops import stencil_gp as G
    _, nx, ny = q.shape
    cells = nx * ny
    prof = profiled(lambda: G.gp_step(q, st, dt, cfg, ops, need_p=False),
                    reps)
    want = reps * G.kernel_launches(ops)
    parts = {"gp_fields_kernel": "means (both passes)",
             "gp_pass_kernel<0>": "pass d0 and predictor",
             "gp_pass_kernel<1>": "pass d1 and average"}
    planes = ops.planes()
    stencil = max(cells * OPS_PER_CELL / 2 / FP32_OPS_PER_S,
                  cells * 4 * (3 + 8 + planes + 3 + 3) / HBM_BYTES_PER_S) * 1e3
    bounds = {"gp_fields_kernel": 2 * gp_pair_ms(cells, ops),
              "gp_pass_kernel<0>": stencil, "gp_pass_kernel<1>": stencil}
    launched, device, rows = 0, [], []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.)
        if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launched += e.count
        elif dev and not e.key.startswith("aten::"):
            device.append(f"{e.key[:48]} x{e.count}")
            key = next((k for k in parts if k in e.key), None)
            if key:
                rows.append((key, e.count, dev / 1e3 / reps))
    if launched != want:
        raise RuntimeError(f"{reps} gp_steps called cudaLaunchKernel "
                           f"{launched} times, expected {want}")
    seen = sum(count for _, count, _ in rows)
    if seen == want:
        for key, count, ms in rows:
            print(f"  profile of gp_step at {nx}x{ny}, per step: "
                  f"{parts[key]} x{count // reps}: {ms:.4f} ms, bound "
                  f"{bounds[key]:.4f} ms")
        print(f"  profile: {launched // reps} launches and kernels a step, "
              f"{sum(ms for _, _, ms in rows):.4f} ms of device time")
        return True
    print(f"  profile: {launched // reps} launches a step; the profiler "
          f"kept the device records of {seen} of the {want} GP kernels "
          f"(device records kept: {', '.join(device) or 'none'})")
    return False


def gp_profile_child():
    """``chip_smoke.py --gp-profile``: gp_profile in a process of its own
    on phase 5's inputs but for the state (3f's journal after its pre-run,
    GP_CAP points x 3 surrogates).  Exits 0 with the split printed, 3
    where this profiler too kept too few device records."""
    from gapflow_torch.ops import _build
    from gapflow_torch.validate import gp_kernel_inputs
    _build.load()
    p = gp_problem(gp_journal_yaml(N))
    q, st, dt, ops, _ = gp_kernel_inputs(p, GP_CAP, db_scales=True)
    if not gp_profile(q, st, dt, p._solver_cfg, ops):
        sys.exit(3)


def gp_profile_split(q, st, dt, cfg, ops):
    """Phase 5's profile of a K5 step: gp_profile here, which also checks
    the launches; where this process's profiler kept too few device
    records (late in this script it has kept none of the GP kernels'
    while keeping K9's), gp_profile_child in a new process, and where
    that kept too few too, the means' launch alone by events."""
    from gapflow_torch.ops import stencil_gp as G
    if gp_profile(q, st, dt, cfg, ops):
        return
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--gp-profile"], capture_output=True, text=True,
                         timeout=600)
    for line in out.stdout.splitlines():
        print(f"  new process: {line.strip()}")
    if out.returncode == 0:
        return
    if out.returncode != 3:
        raise RuntimeError(f"chip_smoke.py --gp-profile exited with "
                           f"{out.returncode}: {out.stderr[-2000:]}")
    _, nx, ny = q.shape
    ms = time_ms(lambda: G.gp_fields(q, st, ops), 20)
    print(f"  profile: by events, the means of one pass (gp_fields) "
          f"{ms:.4f} ms, bound {gp_pair_ms(nx * ny, ops):.4f} ms")


def gp_kernel_times(pj, pa, n=N, reps=20, plain_reps=3):
    """The three GP kernels at n x n on the main paths' final states (the
    journal of phase 3f for gp_step and gp_steps, the asperity contact of
    3h for gp_step_bc) with a synthetic state of GP_CAP points for each of
    the three surrogates, scaled like the run's database: each held
    against its twin, then timed (gp_step as the AL advance launches it,
    without the pressure output).  Returns errors, times and bounds as
    kernel_times does."""
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import gp_kernel_inputs
    errs = {"gp_step": gp_check("K5 journal", pj, GP_CAP),
            "gp_steps": gp_check("K7 journal", pj, GP_CAP, steps=8),
            "gp_step_bc": gp_check("K6 asperity", pa, GP_CAP, exact=False)}
    times, bounds = {}, {}
    cfg = pj._solver_cfg
    q, st, dt, ops, _ = gp_kernel_inputs(pj, GP_CAP, db_scales=True)
    times["gp_step"] = (
        time_ms(lambda: G.gp_step(q, st, dt, cfg, ops, need_p=False), reps),
        time_ms(lambda: G.gp_step_ref(q, st, dt, cfg, ops, need_p=False),
                plain_reps))
    times["gp_steps"] = (
        time_ms(lambda: G.gp_steps(q, st, dt, cfg, ops, reps), 1) / reps,
        time_ms(lambda: G.gp_steps_ref(q, st, dt, cfg, ops, 1), plain_reps))
    bounds["gp_step"] = bounds["gp_steps"] = gp_bound(n * n, ops)
    gp_profile_split(q, st, dt, cfg, ops)
    q2, st2, dt2, ops2, _ = gp_kernel_inputs(pj, 4 * GP_CAP, db_scales=True)
    ms = time_ms(lambda: G.gp_step(q2, st2, dt2, cfg, ops2, need_p=False),
                 reps)
    b = gp_bound(n * n, ops2)
    print(f"phase 5: gp_step {n}x{n} at {4 * GP_CAP} points x 3 surrogates "
          f"(need_p=False): kernel {ms:.4f} ms/step, bound {b[0]:.4f} ms "
          f"({b[1]}) = max(HBM {b[2][0]:.4f}, FP32 {b[2][1]:.4f}, MUFU "
          f"{b[2][2]:.4f})")
    cfg = pa._solver_cfg
    q, st, dt, ops, _ = gp_kernel_inputs(pa, GP_CAP, ghosted=True,
                                         db_scales=True)
    times["gp_step_bc"] = (
        time_ms(lambda: G.gp_step_bc(q, st, dt, cfg, ops), reps),
        time_ms(lambda: G.gp_step_bc_ref(q, st, dt, cfg, ops), plain_reps))
    bounds["gp_step_bc"] = gp_bound(n * n, ops)
    return errs, times, bounds


# -- the elastic (EHL) slice -------------------------------------------------

EHL_STEPS = 500          # phase 3j: run_steps_ehl on the 1024² EHL journal
EHL_RUN_IT = 512         # phase 3k: Problem.run(), the pass-2 route
# phase 3k: route agreement on the pass-2 protocol at 128², 50 steps from
# one perturbed state (relative density noise 1e-3): the kernel route
# against the f32 plain route within ROUTE_TOL, and against a float64
# plain run within EHL_ROUTE_TOL, about three times the f32 plain route's
# own distance to that run (1.727e-4 on an H100 80GB HBM3); both f32
# routes carry the DH EOS's float32 rounding
EHL_ROUTE_N, EHL_ROUTE_STEPS, EHL_ROUTE_TOL = 128, 50, 5e-4
GP_EHL_STEPS = 200       # phase 3l
FLAGSHIP_N, FLAGSHIP_IT = 256, 100       # phase 3m
ADAPTIVE_IT = 2000       # phase 3n


def ehl_journal(n, V=0., max_it=1000000, dtype=None):
    """The EHL journal of the JAX package's benchmark (bench.py
    bench_ehl_step: DH, E 5e9, nu 0.3, alpha 1e-4, fixed dt 5e-11, fully
    periodic) at n x n."""
    from gapflow_torch.validate import ehl_yaml
    return problem(ehl_yaml(n, n, V=V, max_it=max_it, out="data/smoke"),
                   dtype)


def ehl_run_inputs(p):
    """K8's inputs on a Problem's current state and deformation state,
    float32 on the card: interior q, the ghost-inclusive undeformed gap
    and deformation, the slip length, dt, the reference shift; and the
    ghost-inclusive pressure the deformation step takes."""
    from gapflow_torch.core.ehl import _elastic
    from gapflow_torch.core.gp_step import _wrap_pad
    from gapflow_torch.models.eos import eos_pressure
    f32 = torch.float32
    cfg = p._solver_cfg
    q = p._tensor(p.q).to(f32)[:, 1:-1, 1:-1].contiguous()
    hu = p._tensor(p.topo.h_undeformed).to(f32).contiguous()
    u = p.topo.ElasticDeformation.u_prev.to(f32).contiguous()
    ls = p._tensor(p.fc.get_real_field("extra").p[0, 1:-1, 1:-1]).to(f32) \
        .contiguous()
    p_full = _wrap_pad(eos_pressure(q[0], cfg.prop))
    return (q, hu, u, ls, float(np.float32(p.dt)), _elastic(p)[2], p_full)


def ehl_comp_pair(hu, u, ls, shift):
    """K8's compensated step and its twin in the form check_comp_steps
    calls (statics argument unused: the kernel forms them)."""
    from gapflow_torch.ops import stencil as S

    def run(step):
        def f(q, lo, _st, dt, cfg, n):
            for _ in range(n):
                q, lo = step(q, lo, hu, u, ls, dt, cfg, shift)
            return q, lo
        return f
    return run(S.ehl_comp_step), run(S.ehl_comp_step_ref)


def ehl_checks(label, q, hu, u, ls, dt, cfg, shifts=(False, True)):
    """K8's two entries against their twins, and bit for bit against K1
    (and the one-step compensated kernel) on the statics the twins form
    (``ops.stencil.ehl_statics_ref`` of the shifted gap and its patches),
    with and without the reference shift: (ehl_step err, ehl_comp_step
    err), max abs errors against the twins."""
    from gapflow_torch.ops import stencil as S
    e1 = e2 = 0.
    lo = (torch.rand(q.shape, generator=torch.Generator().manual_seed(1))
          .to(q.device) - 0.5) * 1e-6 * q.abs()
    for shift in shifts:
        tag = f"{label}, shift_ref {shift}"
        e1 = max(e1, *(check(f"{tag}: ehl_step emit_delta={d}",
                             S.ehl_step(q, hu, u, ls, dt, cfg, d, shift),
                             S.ehl_step_ref(q, hu, u, ls, dt, cfg, d,
                                            shift))
                       for d in (False, True)))
        e2 = max(e2, check_comp_steps(f"{tag}: ehl_comp_step",
                                      *ehl_comp_pair(hu, u, ls, shift), q,
                                      torch.zeros_like(q), None, dt, cfg))
        st = S._ehl_statics_of(hu, u, ls, cfg, shift).contiguous()
        check_equal(f"{tag}: ehl_step vs K1 on the twins' statics",
                    S.ehl_step(q, hu, u, ls, dt, cfg, shift_ref=shift),
                    S.fused_step(q, st, dt, cfg))
        check_equal(f"{tag}: ehl_comp_step vs the one-step compensated "
                    f"kernel on those statics, q and q_lo (nonzero carry)",
                    torch.cat(S.ehl_comp_step(q, lo, hu, u, ls, dt, cfg,
                                              shift)),
                    torch.cat(S.comp_step_once(q, lo, st, dt, cfg)))
    return e1, e2


def launched():
    from gapflow_torch.ops import cholesky as C
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    return {k: v for k, v in {**S.LAUNCHES, **G.LAUNCHES,
                              **C.LAUNCHES}.items() if v}


def reset_all():
    from gapflow_torch.ops import cholesky as C
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    torch.cuda.synchronize()
    S.reset_launches()
    G.reset_launches()
    C.reset_launches()


def expect_launches(label, want):
    got = launched()
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want}")


def check_state(label, p, n_steps):
    if p.step != n_steps:
        raise RuntimeError(f"{label} stopped at step {p.step}")
    if not (np.isfinite(p.q).all() and (p.q[0] > 0).all()
            and np.isfinite(p.topo.full).all()):
        raise RuntimeError(f"{label}: non-finite state or rho <= 0")


def deform_ms(p, p_full, reps=20):
    """One deformation update's time on the card: the half-space FFT
    pair with its wrap/edge fill, and the relaxation."""
    ed = p.topo.ElasticDeformation
    a = ed.alpha_underrelax
    u = ed.u_prev
    return time_ms(lambda: (1. - a) * u + a * ed.deformation_full(p_full),
                   reps)


def ehl_main(n, reps=50):
    """Phase 3j: Problem.run_steps_ehl on the n² EHL journal, the K8 main
    path.  Returns (launches, errs, wall, the Problem)."""
    p = ehl_journal(n)
    p._pre_run()
    cfg = p._solver_cfg
    reset_all()
    t0 = time.perf_counter()
    p.run_steps_ehl(EHL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lau = launched()
    print(f"  run_steps_ehl({EHL_STEPS}): launches {lau}, wall {wall:.3f} s, "
          f"{n * n * EHL_STEPS / wall:.4e} cell-updates/s, max deformation "
          f"{np.abs(p.topo.deformation).max():.4e} m (gap "
          f"{p.topo.h.min():.4e}..{p.topo.h.max():.4e} m)")
    expect_launches("3j", {"ehl_comp_step": EHL_STEPS})
    check_state("3j", p, EHL_STEPS)
    q, hu, u, ls, dt, shift, p_full = ehl_run_inputs(p)
    errs = ehl_checks("3j final state and deformation", q, hu, u, ls, dt,
                      cfg, (shift,))
    from gapflow_torch.ops import stencil as S
    lo = torch.zeros_like(q)
    k_ms = queued_ms(lambda: S.ehl_comp_step(q, lo, hu, u, ls, dt, cfg,
                                             shift), reps)
    f_ms = deform_ms(p, p_full, reps)
    step_ms = wall / EHL_STEPS * 1e3
    print(f"  3j per step: wall {step_ms:.4f} ms = K8 {k_ms:.4f} ms + "
          f"deformation (FFT pair, fill, relaxation) {f_ms:.4f} ms + rest "
          f"{step_ms - k_ms - f_ms:.4f} ms (EOS, wrap, host launches; the "
          f"gap and its patches are formed in K8); K8 share "
          f"{k_ms / step_ms:.3f}")
    return lau, errs, wall, p


def ehl_route_check():
    """Phase 3k, second half: the pass-2 protocol at EHL_ROUTE_N² for
    EHL_ROUTE_STEPS steps from one perturbed state, three times: the
    kernel route (K5 without surrogates) in float32, the plain step in
    float32 and in float64."""
    from gapflow_torch.core.step import apply_bcs
    from gapflow_torch.validate import kernel_vs_plain_err, perturbed_q
    n, steps = EHL_ROUTE_N, EHL_ROUTE_STEPS
    q0, runs = None, {}
    for label, dtype, kernels in (("kernel route f32", torch.float32, True),
                                  ("plain step f32", torch.float32, False),
                                  ("plain step f64", torch.float64, False)):
        p = ehl_journal(n, dtype=dtype)
        if q0 is None:
            q0 = apply_bcs(torch.as_tensor(perturbed_q(p.q, seed=0,
                                                       amp=1e-3)),
                           p._solver_cfg).numpy().astype(np.float32)
        p.q[...] = q0
        p._pre_run()
        reset_all()
        p._run_steps_ehl_pass2(steps, allow_pallas=kernels)
        torch.cuda.synchronize()
        print(f"  {label}: launches {launched()}")
        expect_launches(label, {"gp_step": steps} if kernels else {})
        check_state(label, p, steps)
        runs[label] = (torch.as_tensor(p.q, dtype=torch.float64),
                       torch.as_tensor(p.topo.deformation)[None])
    (qk, uk), (qp, up), (q64, u64) = runs.values()
    d_kp = kernel_vs_plain_err(qk, qp)
    d_k64, d_p64 = (kernel_vs_plain_err(q, q64) for q in (qk, qp))
    u_kp = kernel_vs_plain_err(uk, up)
    u_k64, u_p64 = (kernel_vs_plain_err(u, u64) for u in (uk, up))
    print(f"  q, scaled max difference: kernel route vs f32 plain step "
          f"{d_kp:.3e}; to the float64 run: kernel route {d_k64:.3e}, f32 "
          f"plain step {d_p64:.3e}")
    print(f"  deformation, scaled max difference: kernel route vs f32 plain "
          f"step {u_kp:.3e}; to the float64 run: kernel route {u_k64:.3e}, "
          f"f32 plain step {u_p64:.3e}")
    if not (np.isfinite(d_kp) and d_kp < ROUTE_TOL and u_kp < ROUTE_TOL):
        raise RuntimeError(f"pass-2 kernel route vs f32 plain step: q "
                           f"{d_kp}, u {u_kp} >= {ROUTE_TOL}")
    if not (np.isfinite(d_k64) and d_k64 < EHL_ROUTE_TOL):
        raise RuntimeError(f"pass-2 kernel route vs float64: {d_k64} >= "
                           f"{EHL_ROUTE_TOL}")


def gp_ehl_yaml(n):
    """The GP journal of phase 3g (frozen surrogates on the mock oracle)
    with the half-space of the EHL journal: bench.py bench_gp_ehl's
    configuration (V 0.05) as a Problem."""
    from gapflow_torch.validate import EHL_ELASTIC
    text = gp_journal_yaml(n, al=False)
    if "C2: 1.23}" not in text:
        raise RuntimeError("unexpected GP journal configuration")
    return text.replace("C2: 1.23}", f"C2: 1.23, {EHL_ELASTIC}}}")


def gp_ehl_main(n, reps=20):
    """Phase 3l: run_steps_gp_fast on the GP x elastic journal with
    bench.py bench_gp_ehl's three synthetic surrogates at GP_CAP points
    (validate.synthetic_gp_state, numpy seed 0) standing in for the
    database's fits.  Returns (launches, the K5 error, wall)."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import gp_dims_use, synthetic_gp_state
    p = gp_problem(gp_ehl_yaml(n))
    dims, use = gp_dims_use(p)
    state = synthetic_gp_state(dims, use, GP_CAP, np.random.default_rng(0),
                               device=DEVICE)
    # the bench protocol's surrogates in place of the mock database's fits
    p._frozen_gp_state = lambda capacity=None: (state, dims, use,
                                                p.database.num_features)
    reset_all()
    t0 = time.perf_counter()
    p.run_steps_gp_fast(GP_EHL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lau = launched()
    print(f"  run_steps_gp_fast({GP_EHL_STEPS}), {GP_CAP} points x 3 "
          f"surrogates: launches {lau}, wall {wall:.3f} s (the end-of-run "
          f"host refresh included), {n * n * GP_EHL_STEPS / wall:.4e} "
          f"cell-updates/s, max deformation "
          f"{np.abs(p.topo.deformation).max():.4e} m")
    expect_launches("3l", {"gp_step": GP_EHL_STEPS})
    check_state("3l", p, GP_EHL_STEPS)
    cfg = p._solver_cfg
    ops = G.prep_gp_ops(state, dims, use)
    q = p._tensor(p.q)[:, 1:-1, 1:-1].contiguous()
    st = S.interior_statics(p.topo.full, p.fc.get_real_field("extra").p,
                            torch.float32, q.device)
    (qk, pk), (qr, pr) = (G.gp_step(q, st, p.dt, cfg, ops),
                          G.gp_step_ref(q, st, p.dt, cfg, ops))
    err = max(check("3l final state and gap: gp_step", qk, qr),
              check_p("3l final state and gap: gp_step", pk, pr))
    k_ms = time_ms(lambda: G.gp_step(q, st, p.dt, cfg, ops), reps)
    from gapflow_torch.core.gp_step import _wrap_pad
    f_ms = deform_ms(p, _wrap_pad(pk), reps)
    step_ms = wall / GP_EHL_STEPS * 1e3
    print(f"  3l per step: wall {step_ms:.4f} ms = K5 {k_ms:.4f} ms + "
          f"deformation {f_ms:.4f} ms + rest {step_ms - k_ms - f_ms:.4f} ms "
          f"(topography and statics of the deformed gap, GP operands, host "
          f"launches, the end-of-run refresh); K5 share "
          f"{k_ms / step_ms:.3f}")
    return lau, err, wall


def flagship_yaml(n, max_it):
    """examples/config/asperity_2d_ehl_gp.yaml (rough-surface EHL with GP
    surrogates: BWR, D/N on four edges, a free half-space, chunked active
    learning) widened to n x n, with its asperity depths from seed 0 and a
    fresh database directory."""
    import tempfile
    import yaml
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "config", "asperity_2d_ehl_gp.yaml")
    with open(path) as fh:
        d = yaml.safe_load(fh)
    d["options"].update(silent=True, output="data/smoke", use_tstamp=False)
    d["grid"].update(Nx=n, Ny=n)
    d["numerics"].update(max_it=max_it)
    d["geometry"]["seed"] = 0
    d["db"]["dtool_path"] = tempfile.mkdtemp(prefix="gp_train_")
    return yaml.safe_dump(d)


def adaptive_yaml(max_it):
    """examples/config/parabolic_1d_elastic.yaml (EHL line contact,
    adaptive dt) made silent, with no convergence stop before max_it."""
    import yaml
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "config", "parabolic_1d_elastic.yaml")
    with open(path) as fh:
        d = yaml.safe_load(fh)
    d["options"].update(silent=True, output="data/smoke", use_tstamp=False)
    d["numerics"].update(max_it=max_it, tol=1e-30)
    return yaml.safe_dump(d)


def k5_empty_check(label, p, reps=0):
    """K5 without surrogates (the pass-2 route's step) against its twin on
    a Problem's current state and topography.  Returns (max abs error,
    the kernel's ms over ``reps`` launches, None without)."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    cfg = p._solver_cfg
    nf = 6 + p.fc.get_real_field("extra").p.shape[0]
    ops = G.prep_gp_ops({"Xscale": torch.ones(nf, device=DEVICE)},
                        (None, None, None), (False, False, False))
    q = p._tensor(p.q).float()[:, 1:-1, 1:-1].contiguous()
    st = S.interior_statics(p.topo.full, p.fc.get_real_field("extra").p,
                            torch.float32, q.device)
    (qk, pk), (qr, pr) = (G.gp_step(q, st, p.dt, cfg, ops),
                          G.gp_step_ref(q, st, p.dt, cfg, ops))
    err = max(check(f"{label}: gp_step, no surrogates", qk, qr),
              check_p(f"{label}: gp_step, no surrogates", pk, pr))
    k_ms = (time_ms(lambda: G.gp_step(q, st, p.dt, cfg, ops), reps)
            if reps else None)
    return err, k_ms


def twin_step(cfg, active_dims, use_gp):
    """The GP kernel route's step with the pass-2 pressure, run on the
    kernels' plain twins (in the state's dtype, on its device):
    ``step(q, topo, extra, dt, step_idx, gp_state) -> (q, p)`` on
    ghost-inclusive arrays, as ``core.gp_step.make_gp_step_core``'s."""
    from gapflow_torch.core.gp_step import _wrap_pad, cast_gp_state
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G

    def step(q, topo, extra, dt, step_idx, gp_state):
        ops = G.prep_gp_ops(cast_gp_state(gp_state, q.dtype), active_dims,
                            use_gp)
        q_int = q[:, 1:-1, 1:-1].contiguous()
        if S._fully_periodic(cfg):
            st = S.interior_statics(topo, extra, q.dtype, q.device)
            q_int, p = G.gp_step_ref(q_int, st, dt, cfg, ops)
            p = _wrap_pad(p)
        else:
            st = S.ghost_statics(topo, extra, q.dtype, q.device)
            q_int, p = G.gp_step_bc_ref(q_int, st, dt, cfg, ops, need_p=True)
        return S.with_ghosts(q_int, cfg), p
    return step


class twin_route:
    """Within the block, the pass-2 EHL loop's step is the kernel route
    run on the kernels' plain twins (:func:`twin_step`): the float64
    counterpart of the float32 kernel route."""

    def __enter__(self):
        import gapflow_torch.core.ehl as E
        self.orig = E.make_gp_step_core
        E.make_gp_step_core = lambda cfg, dims, nf, use, *a, **k: \
            twin_step(cfg, dims, use)

    def __exit__(self, *exc):
        import gapflow_torch.core.ehl as E
        E.make_gp_step_core = self.orig


# phase 3n: the f32 kernel route's distance from the same route in
# float64 (its twins) against the f32 plain step's own distance from the
# float64 plain step
ADAPTIVE_ROUTE_FACTOR = 2.


def adaptive_check(err):
    """Phase 3n: Problem.run() on the adaptive EHL line contact (the
    pass-2 route with dt on the device, K5 without surrogates), the dt
    after every chunk recorded; then the same chunks on the f32 plain
    step, on the same route in float64 (the kernels' twins on the card)
    and on the float64 plain step.  The parabolic gap is not periodic:
    on the periodic grid the kernel route (interior statics, wrapped) and
    the plain step (the ghost cells' analytic slopes) differ at the seam
    by construction, as in the JAX package, so q is held route against
    route: the f32 kernel route's distance from the float64 twin route
    to at most ADAPTIVE_ROUTE_FACTOR times the f32 plain step's distance
    from the float64 plain step.  Returns the kernel route's launches."""
    from gapflow_torch.validate import kernel_vs_plain_err
    runs = {}
    for label, kernels, dtype in (
            ("kernel route", True, None),
            ("plain step", False, None),
            ("kernel route f64 (twins)", "twins", torch.float64),
            ("plain step f64", False, torch.float64)):
        p = problem(adaptive_yaml(ADAPTIVE_IT), dtype)
        p._pre_run()
        dts, chunks = [p.dt], []
        if kernels is True:
            run_chunk = p._run_steps_ehl_pass2

            def record(n, run_chunk=run_chunk, p=p):
                run_chunk(n)
                chunks.append(n)
                dts.append(p.dt)
            p._run_steps_ehl_pass2 = record
            reset_all()
            t0 = time.perf_counter()
            p.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lau = launched()
            if p._route != "ehl_pass2":
                raise RuntimeError(f"3n took {p._route}")
            expect_launches("3n", {"gp_step": ADAPTIVE_IT})
            err["gp_step"] = max(err["gp_step"], k5_empty_check(
                "3n final state and gap", p)[0])
        else:
            reset_all()
            t0 = time.perf_counter()
            with (twin_route() if kernels == "twins"
                  else contextlib.nullcontext()):
                for n in runs["kernel route"][3]:
                    p._run_steps_ehl_pass2(n, allow_pallas=False)
                    dts.append(p.dt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            expect_launches(f"3n {label}", {})
        check_state(f"3n {label}", p, ADAPTIVE_IT)
        print(f"  {label}: wall {wall:.3f} s, dt from {dts[0]:.6e} to "
              f"{dts[-1]:.6e} (min {min(dts):.6e}, max {max(dts):.6e} over "
              f"{len(dts) - 1} chunks), simtime {p.simtime:.9e} s")
        runs[label] = (torch.as_tensor(p.q, dtype=torch.float64), dts,
                       p.simtime, chunks)
    (qk, dk, tk, _), (qp, dp, tp, _), (qk64, *_), (qp64, *_) = \
        runs.values()
    d_dt = max(abs(a / b - 1.) for a, b in zip(dk, dp))
    d_t = abs(tk / tp - 1.)
    d_k, d_p = kernel_vs_plain_err(qk, qk64), kernel_vs_plain_err(qp, qp64)
    print(f"  kernel route vs f32 plain step: dt {d_dt:.3e} relative (max "
          f"over the chunks), simtime {d_t:.3e} relative, q "
          f"{kernel_vs_plain_err(qk, qp):.3e} scaled (the seam convention; "
          f"the float64 routes "
          f"{kernel_vs_plain_err(qk64, qp64):.3e}); f32 kernel route vs its "
          f"float64 twin route {d_k:.3e}, f32 plain step vs float64 plain "
          f"step {d_p:.3e} (limit {ADAPTIVE_ROUTE_FACTOR:g} x)")
    if not (np.isfinite(d_dt) and max(d_dt, d_t) < ROUTE_TOL):
        raise RuntimeError(f"3n routes disagree: dt {d_dt}, simtime {d_t} "
                           f"(limit {ROUTE_TOL})")
    if not (np.isfinite(d_k) and d_k <= ADAPTIVE_ROUTE_FACTOR * d_p):
        raise RuntimeError(f"3n: f32 kernel route {d_k} from its float64 "
                           f"route, f32 plain step {d_p} from its own")
    return lau



# -- the plain whole-run path ------------------------------------------------

def check_same(label, out, ref):
    """A k-step kernel against k launches of the one-step kernel: equal
    bit for bit, else the difference is printed and held to SAME_TOL."""
    torch.cuda.synchronize()
    if torch.equal(out, ref):
        print(f"  {label}: equal bit for bit")
        return
    err, abs_err = errors(label, out, ref)
    print(f"  {label}: NOT equal bit for bit: max scaled diff {err:.3e}, "
          f"max abs diff {abs_err:.3e}")
    if not err < SAME_TOL:
        raise RuntimeError(f"{label}: scaled diff {err} >= {SAME_TOL}")


def plain_launches(cfg, n, k=None):
    """The launch counts of n plain steps through the C sweep entry in
    sweeps of k (the main path's depth, _plain_k_steps, by default):
    every sweep as plain_steps_bc on D/N edges; on periodic ones a sweep
    of the main path's depth as plain_steps (K2p), any other as
    plain_steps_rem (Ke)."""
    from gapflow_torch.ops import stencil as S
    main = S._plain_k_steps(cfg)
    k = main if k is None else k
    full, rem = divmod(n, k)
    if not S._periodic_kernel_ok(cfg):
        return {"plain_steps_bc": full + (rem > 0)}
    got = {}
    for depth, count in ((k, full), (rem, int(rem > 0))):
        key = "plain_steps" if depth == main else "plain_steps_rem"
        got[key] = got.get(key, 0) + count
    return {key: v for key, v in got.items() if v}


def plain_kernel_checks(err):
    """Phase 2i: plain_run (n = 9) against K1 launched once per step and
    against its twin, a refused cooperative launch raising; then the
    plain sweeps against K1/K3 launched once per step, bit for bit: k =
    1..KMAX steps in one sweep (plain_steps, plain_steps_bc), n = 1..KMAX
    and 2 KMAX + 1 steps in one C call at the main path's depth
    (plain_sweeps, plain_sweeps_bc) and 2 KMAX + 1 at every depth k
    (through the private ops.stencil._plain_sweeps), with their launch
    counts, on the periodic journal at N_CHECK² and 40 x 72, every
    BC_CASES layout, the Eyring asperity (KMAX = 2) and 1D grids (1024 x
    1: periodic, dn_x, dn_x_barus_eyring); each sweep against its twin.
    The C entry refuses a depth outside 1..KMAX, and the refusal raises.
    Returns the launches of K1 and K3 (the witnesses)."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.validate import BC_CASES
    for key in ("plain_steps", "plain_steps_rem", "plain_run",
                "plain_steps_bc"):
        err[key] = 0.
    p = journal(N_CHECK, N_CHECK)
    cfg = p._solver_cfg
    q, st, dt = kernel_inputs(p, amp=0.01)
    ref = q
    for _ in range(9):
        ref = S.fused_step(ref, st, dt, cfg)
    out = S.plain_run(q, st, dt, cfg, 9)
    check_same("plain_run n=9 vs 9 x K1", out, ref)
    err["plain_run"] = check("plain_run n=9 vs twin", out,
                             S.plain_run_ref(q, st, dt, cfg, 9))
    try:
        S.plain_run(q, st, dt, cfg, 2, blocks=1 << 20)
    except RuntimeError as e:
        print(f"  plain_run on 2^20 blocks refused, as it must be: {e}")
    else:
        raise RuntimeError("a cooperative launch of 2^20 blocks ran")
    witness = {"fused_step": 0, "fused_step_bc": 0}
    cases = [("journal", journal(N_CHECK, N_CHECK), False),
             ("journal 40x72", journal(40, 72), False)]
    cases += [(case, journal(N_CHECK, N_CHECK, grid, props, dt=2e-11), True)
              for case, (grid, props) in BC_CASES.items()]
    cases.append(("asperity Eyring", problem(asperity_yaml(N_CHECK, 1000)),
                  True))
    cases.append(("journal 1024x1", journal(1024, 1), False))
    cases += [(f"{case} 1024x1", journal(1024, 1, *BC_CASES[case],
                                         dt=2e-12 if "barus" in case
                                         else 2e-11), True)
              for case in ("dn_x", "dn_x_barus_eyring")]
    for label, pc, bc in cases:
        cfg = pc._solver_cfg
        q, st, dt = kernel_inputs(pc, amp=0.01, ghosted=bc)
        once = S.fused_step_bc if bc else S.fused_step
        one_sweep = S.plain_steps_bc if bc else S.plain_steps
        sweeps = S.plain_sweeps_bc if bc else S.plain_sweeps
        twin = S.plain_steps_bc_ref if bc else S.plain_steps_ref
        key = "plain_steps_bc" if bc else "plain_steps"
        kmax = S._k_steps(cfg)
        reset_all()
        refs = [q]
        for _ in range(2 * kmax + 1):
            refs.append(once(refs[-1], st, dt, cfg))
        for k in witness:
            witness[k] += S.LAUNCHES[k]
        runs = [(f"{key.replace('steps', 'sweeps')} n={n}", n, None)
                for n in (*range(1, kmax + 1), 2 * kmax + 1)]
        runs += [(f"_plain_sweeps n={2 * kmax + 1} k={k}", 2 * kmax + 1, k)
                 for k in range(1, kmax + 1)]
        for k in range(1, kmax + 1):
            reset_all()
            out = one_sweep(q, st, dt, cfg, k)
            torch.cuda.synchronize()
            check_equal(f"{key} {label} k={k} vs {k} x one-step kernel", out,
                        refs[k])
            expect_launches(f"2i {label} k={k}", plain_launches(cfg, k, k))
            if label == "asperity Eyring" and k > 1:
                # BWR + Eyring amplifies a last-bit difference by orders
                # of magnitude a step: the twin is held over one step
                continue
            e = check(f"{key} {label} k={k} vs twin", out,
                      twin(q, st, dt, cfg, k))
            ekey = key if bc or k == S._plain_k_steps(cfg) \
                else "plain_steps_rem"
            err[ekey] = max(err[ekey], e)
        for name, n, k in runs:
            reset_all()
            out = (sweeps(q, st, dt, cfg, n) if k is None else
                   S._plain_sweeps(q, st, dt, cfg, n, k))
            want = plain_launches(cfg, n, k)
            expect_launches(f"2i {label} {name}", want)
            check_equal(f"{name} {label} ({want}) vs {n} x one-step kernel",
                        out, refs[n])
        before = dict(S.LAUNCHES)
        for k in (0, kmax + 1):
            try:
                S._plain_sweeps(q, st, dt, cfg, 4, k)
            except RuntimeError as e:
                print(f"  {label}: a plain sweep of {k} steps refused, as "
                      f"it must be: {e}")
            else:
                raise RuntimeError(f"2i {label}: a sweep of {k} steps ran")
        if dict(S.LAUNCHES) != before:
            raise RuntimeError(f"2i {label}: a refused sweep was counted")
    torch.cuda.synchronize()
    return witness


def check_bits(label, out, ref):
    """A compensated sweep against the one-step kernel: q and q_lo equal
    bit for bit, else raise."""
    torch.cuda.synchronize()
    for name, a, b in (("q", out[0], ref[0]), ("q_lo", out[1], ref[1])):
        if not torch.equal(a, b):
            raise RuntimeError(f"{label}: {name} differs, max abs diff "
                               f"{float((a - b).abs().max()):.3e}")
    print(f"  {label}: q and q_lo equal bit for bit")


def comp_sweep_checks(err):
    """Phase 2i: the compensated sweeps (comp_steps, comp_steps_bc) against
    the one-step compensated kernels launched once per step, bit for bit,
    q and q_lo: from a nonzero carry (8 one-step compensated steps first),
    k = 1..KMAX steps in one launch, and 2 KMAX + 1 steps (sweeps and a
    remainder) at every depth k (through the C sweep entry) and at the
    main path's (through the wrapper), on the periodic journal at
    N_CHECK² and on a ragged 40 x 72 grid, every BC_CASES layout, the
    Eyring asperity (KMAX = 2), and on 1D grids (1024 x 1: periodic,
    dn_x, dn_x_barus_eyring), where a tile's window wraps onto its one
    column; each against its twin too (the asperity over one step
    only).  The C entry refuses a sweep depth outside 1..KMAX, and the
    refusal raises.  Returns the one-step kernels' launches."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.validate import BC_CASES
    err["comp_sweep"] = err.get("comp_sweep", 0.)
    err["comp_sweep_bc"] = err.get("comp_sweep_bc", 0.)
    cases = [("journal", journal(N_CHECK, N_CHECK), False),
             ("journal 40x72", journal(40, 72), False)]
    # dt 2e-12 for Barus + Eyring: at 2e-11 its state goes non-finite
    # within the 13 compensated steps here (at the twelfth; the twin alike)
    cases += [(case, journal(N_CHECK, N_CHECK, grid, props,
                             dt=2e-12 if "barus" in case else 2e-11), True)
              for case, (grid, props) in BC_CASES.items()]
    cases.append(("asperity Eyring", problem(asperity_yaml(N_CHECK, 1000)),
                  True))
    cases.append(("journal 1024x1", journal(1024, 1), False))
    cases += [(f"{case} 1024x1", journal(1024, 1, *BC_CASES[case],
                                         dt=2e-12 if "barus" in case
                                         else 2e-11), True)
              for case in ("dn_x", "dn_x_barus_eyring")]
    witness = {"comp_step": 0, "comp_step_bc": 0}
    for label, p, bc in cases:
        cfg = p._solver_cfg
        q, st, dt = kernel_inputs(p, amp=0.01, ghosted=bc)
        once = S.comp_step_bc_once if bc else S.comp_step_once
        steps = S.comp_steps_bc if bc else S.comp_steps
        twin = S.comp_steps_bc_ref if bc else S.comp_steps_ref
        key = "comp_sweep_bc" if bc else "comp_sweep"
        entry = "gf_comp_sweeps_bc" if bc else "gf_comp_sweeps"
        extra = S._bc_params(cfg) if bc else ()
        kmax = S._k_steps(cfg)
        reset_all()
        lo = torch.zeros_like(q)
        for _ in range(8):
            q, lo = once(q, lo, st, dt, cfg)
        runs = [(k, k) for k in range(1, kmax + 1)]
        runs += [(2 * kmax + 1, k) for k in (*range(1, kmax + 1), None)]
        for n, k in runs:
            ref = (q, lo)
            for _ in range(n):
                ref = once(*ref, st, dt, cfg)
            before = S.LAUNCHES[key]
            out = (steps(q, lo, st, dt, cfg, n) if k is None else
                   S._comp_sweeps(entry, key, q, lo, st, dt, cfg, n, k,
                                  *extra))
            sweeps = S.LAUNCHES[key] - before
            depth = S._comp_k_steps(cfg) if k is None else k
            if sweeps != -(-n // depth):
                raise RuntimeError(f"2i {label} n={n}: {sweeps} sweeps")
            check_bits(f"{key} {label} n={n} k={depth} ({sweeps} sweeps) "
                       f"vs {n} x one-step kernel", out, ref)
            tq = twin(q, lo, st, dt, cfg, n)[0]
            if label == "asperity Eyring" and n > 1:
                # BWR + Eyring amplifies a last-bit difference by orders of
                # magnitude a step: runs of more than one step from the
                # same carry go their own way (check_comp_steps)
                print(f"  {key} {label} n={n} vs twin (q), on their own: "
                      f"max scaled diff {errors(label, out[0], tq)[0]:.3e}")
            else:
                err[key] = max(err[key], check(
                    f"{key} {label} n={n} vs twin (q)", out[0], tq))
        for k in witness:
            witness[k] += S.LAUNCHES[k]
        before = S.LAUNCHES[key]
        for k in (0, kmax + 1):
            try:
                S._comp_sweeps(entry, key, q, lo, st, dt, cfg, 4, k, *extra)
            except RuntimeError as e:
                print(f"  {entry} with k = {k} refused, as it must be: {e}")
            else:
                raise RuntimeError(f"2i {label}: {entry} ran k = {k}")
        if S.LAUNCHES[key] != before:
            raise RuntimeError(f"2i {label}: a refused sweep was counted")
    torch.cuda.synchronize()
    return witness


def k1_run_steps(p, n):
    """run_steps_fast's body with K1 launched once per step in place of
    the plain route (the loop the port ran before the plain kernels), for
    the record."""
    from gapflow_torch.ops.stencil import (fused_step, interior_statics,
                                           with_ghosts)
    q = p._tensor(p.q).float()
    st = interior_statics(p.topo.full, p.fc.get_real_field("extra").p,
                          torch.float32, q.device)
    q_int = q[:, 1:-1, 1:-1].contiguous()
    for _ in range(n):
        q_int = fused_step(q_int, st, p.dt, p._solver_cfg)
    p.q[...] = with_ghosts(q_int, p._solver_cfg).cpu().numpy()
    p.step += n


def timed_runs(label, p, run, n, want, reps=3):
    """A warm-up, then ``reps`` timed calls of ``run(p, n)``, each with
    the launch counts set to 0 just before it and checked against
    ``want`` just after.  Returns (median wall s, launches)."""
    cells = p.grid["Nx"] * p.grid["Ny"]
    run(p, n)
    walls = []
    for _ in range(reps):
        reset_all()
        t0 = time.perf_counter()
        run(p, n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        expect_launches(label, want)
    wall = sorted(walls)[len(walls) // 2]
    if not (np.isfinite(p.q).all() and (p.q[0] > 0).all()):
        raise RuntimeError(f"{label}: non-finite q or rho <= 0")
    print(f"  {label}: launches {want}, walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s, median {wall:.4f} s, "
          f"{cells * n / wall:.4e} cell-updates/s")
    return wall, want


def fv_throughput(launches):
    """Phase 3o: bench.py bench_fv_step through run_steps_fast(FV_STEPS,
    compensated=False) at each of FV_SIZES (the whole run in one Kv
    launch where it fits the L2 cache, else one C call of K2p sweeps),
    then the same calls through K1 launched once per step; the two routes'
    final states compared.  A run of FV_REM_STEPS at N x N adds a
    remainder sweep (Ke)."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.validate import kernel_vs_plain_err

    def plain(p, n):
        p.run_steps_fast(n, compensated=False)

    for n in FV_SIZES:
        pk = journal(n, n, dt=1e-11)
        pk._pre_run()
        entry, k, n_sweeps, n_rem = S._plain_route(
            pk._solver_cfg, n, n, FV_STEPS, DEVICE)
        want = ({"plain_run": 1} if entry == "plain_run"
                else plain_launches(pk._solver_cfg, FV_STEPS))
        _, got = timed_runs(f"{n}x{n} plain route ({entry})", pk, plain,
                            FV_STEPS, want)
        for key, v in got.items():
            if n == N or key == "plain_run":
                launches[key] = v
        p1 = journal(n, n, dt=1e-11)
        p1._pre_run()
        _, got = timed_runs(f"{n}x{n} K1 once per step", p1, k1_run_steps,
                            FV_STEPS, {"fused_step": FV_STEPS})
        if n == N:          # no main path launches K1: its record run
            launches["fused_step"] = got["fused_step"]
        diff = kernel_vs_plain_err(torch.as_tensor(pk.q),
                                   torch.as_tensor(p1.q))
        print(f"  {n}x{n}: after {4 * FV_STEPS} steps, plain route vs K1 "
              f"once per step: max scaled diff {diff:.3e}")
        if not diff < SAME_TOL:
            raise RuntimeError(f"{n}x{n}: routes differ by {diff}")
    pr = journal(N, N, dt=1e-11)
    pr._pre_run()
    _, got = timed_runs(f"{N}x{N} plain route, {FV_REM_STEPS} steps", pr,
                        plain, FV_REM_STEPS,
                        plain_launches(pr._solver_cfg, FV_REM_STEPS), reps=1)
    launches["plain_steps_rem"] = got["plain_steps_rem"]


def plain_bc_paths(launches):
    """Phase 3p: run_steps_fast(compensated=False) on 3b's inclined slider
    and 3c's Eyring asperity at N x N, fixed dt: one C call of K3p sweeps
    of _plain_k_steps and a remainder sweep."""
    def plain(p, n):
        p.run_steps_fast(n, compensated=False)

    pb = problem(inclined_yaml(N, 1000000, adaptive=0, dt=1e-10))
    pb._pre_run()
    _, got = timed_runs(f"inclined slider {N}x{N}, D/N x edges, 1002 steps",
                        pb, plain, 1002, plain_launches(pb._solver_cfg, 1002))
    launches["plain_steps_bc"] = got["plain_steps_bc"]
    pa = problem(asperity_yaml(N, 1000000, adaptive=0))
    pa._pre_run()
    _, got = timed_runs(f"asperity {N}x{N}, D/N on four edges, Eyring, 1001 "
                        f"steps", pa, plain, 1001,
                        plain_launches(pa._solver_cfg, 1001))
    launches["plain_steps_bc"] += got["plain_steps_bc"]


def plain_route_check():
    """Phase 3p: the plain kernel route against the f32 plain step after
    PLAIN_ROUTE_STEPS steps at 256²: Kv on the journal, K3p on the
    inclined slider and, with Barus and Eyring thinning, on the journal's
    D/N x edges.  From each configuration's own initial state the two
    are held to ROUTE_TOL (as phase 3e holds K3 once per step).  From
    that state perturbed by relative density noise 1e-3 (seed 0) the two
    f32 routes part by their closures' rounding, so each is measured
    against the plain step run in float64, the kernel route held to
    twice the f32 plain step's own distance.  K3p on the BWR + Eyring
    asperity is held that way from its own state too: that model
    amplifies last-bit differences by orders of magnitude within a few
    steps (PERF.md), so two f32 routes part by more than ROUTE_TOL while
    each stays as close to float64 as the other.  Then
    validate.pallas_vs_xla_err."""
    from gapflow_torch.validate import (BC_CASES, kernel_vs_plain_err,
                                        pallas_vs_xla_err, perturbed_state)
    n, steps = N_CHECK, PLAIN_ROUTE_STEPS

    def run(make, route, amp=0., dtype=None):
        p = make(dtype)
        p._pre_run()
        if amp:
            p.q[...] = perturbed_state(p, seed=0, amp=amp).q.cpu().numpy()
        reset_all()
        if route == "kernels":
            p.run_steps_fast(steps, compensated=False)
            torch.cuda.synchronize()
        else:
            p.run_steps(steps)
        got = launched()
        check_state(f"3p {route}", p, steps)
        return torch.as_tensor(p.q, dtype=torch.float64), got

    err = kernel_vs_plain_err

    def against_float64(label, make, amp):
        qk, _ = run(make, "kernels", amp)
        qp, _ = run(make, "plain step", amp)
        q64, _ = run(make, "plain step", amp, torch.float64)
        dk, dp = err(qk, q64), err(qp, q64)
        start = f"the state perturbed by {amp:g}" if amp else "its own state"
        print(f"    from {start}: kernel route vs f32 plain step "
              f"{err(qk, qp):.3e}; to the float64 plain step: kernel route "
              f"{dk:.3e}, f32 plain step {dp:.3e} (limit 2 x)")
        if not (np.isfinite(dk) and dk < 2 * dp):
            raise RuntimeError(f"3p {label}: kernel route {dk} from float64, "
                               f"f32 plain step {dp}")

    for label, make, chaotic in (
            ("journal", lambda dtype: problem(journal_yaml_for(n), dtype),
             False),
            ("inclined slider", lambda dtype: problem(inclined_yaml(
                n, 1000000, adaptive=0, dt=1e-9), dtype), False),
            ("journal D/N x, Barus + Eyring", lambda dtype: problem(
                journal_yaml_for(n, n, *BC_CASES["dn_x_barus_eyring"],
                                 dt=2e-11), dtype), False),
            ("asperity BWR + Eyring", lambda dtype: problem(asperity_yaml(
                n, 1000000, adaptive=0), dtype), True)):
        cfg = make(None)._solver_cfg
        want = ({"plain_run": 1} if label == "journal"
                else plain_launches(cfg, steps))
        qk, got = run(make, "kernels")
        if got != want:
            raise RuntimeError(f"3p {label}: launches {got}, expected {want}")
        qp, got = run(make, "plain step")
        if got:
            raise RuntimeError(f"3p {label} plain step launched {got}")
        d = err(qk, qp)
        print(f"  {label} {n}x{n}, {steps} steps: plain kernel route vs "
              f"f32 plain step: max scaled diff {d:.3e}"
              + ("" if chaotic else f" (limit {ROUTE_TOL:g})"))
        if chaotic:
            against_float64(label, make, 0.)
        elif not (np.isfinite(d) and d < ROUTE_TOL):
            raise RuntimeError(f"3p {label}: {d} >= {ROUTE_TOL}")
        against_float64(label, make, 1e-3)
    reset_all()
    e = pallas_vs_xla_err(device=DEVICE)
    print(f"  validate.pallas_vs_xla_err() (journal 256x256, 8 steps, "
          f"launches {launched()}): {e:.3e}")
    if not e < TOL:
        raise RuntimeError(f"pallas_vs_xla_err {e} >= {TOL}")


def plain_kernel_times(n=N, plain_reps=2):
    """Phase 5: the plain whole-run kernels on the main paths' inputs,
    each held against its twin, then timed per step (the sweeps over
    whole C calls of PLAIN_CALL_STEPS steps at their depth).  Returns
    {kernel: max abs error}, {kernel: (ms, twin ms)} and {kernel:
    (bound ms, bound by)}, and prints Kv at n x n forced beside its
    main-path size."""
    from gapflow_torch.ops import stencil as S
    errs, times, bounds = {}, {}, {}
    cells = n * n
    tp = journal(n, n, dt=1e-11)
    cfg = tp._solver_cfg
    q, st, dt = kernel_inputs(tp, amp=0.01)
    # the least the work needs: one sweep's bytes over the deepest sweep
    # the kernel takes (_k_steps), whatever depth the main path chose
    kmax = S._k_steps(cfg)
    k_main = S._plain_k_steps(cfg)
    # whole C calls of PLAIN_CALL_STEPS steps in sweeps of the depth: a
    # launch of one short sweep is shorter than the wrapper's host time
    for key, k in (("plain_steps", k_main),
                   ("plain_steps_rem", FV_REM_STEPS % k_main)):
        errs[key] = check(f"{key} k={k} journal {n}x{n}",
                          S.plain_steps(q, st, dt, cfg, k),
                          S.plain_steps_ref(q, st, dt, cfg, k))
        times[key] = (
            time_ms(lambda: S._plain_sweeps(q, st, dt, cfg, PLAIN_CALL_STEPS,
                                            k), 3) / PLAIN_CALL_STEPS,
            time_ms(lambda: S.plain_steps_ref(q, st, dt, cfg, k),
                    plain_reps) / k)
        b = bound((q, st), (q,), cells, kmax * OPS_PER_CELL)
        bounds[key] = (b[0] / kmax, b[1])
    run_n = 100
    for m in (FV_SIZES[0], n):
        if m == n:
            qm, stm, dtm, cm = q, st, dt, cfg
        else:
            pm = journal(m, m, dt=1e-11)
            qm, stm, dtm = kernel_inputs(pm, amp=0.01)
            cm = pm._solver_cfg
        e = check(f"plain_run n=4 journal {m}x{m}",
                  S.plain_run(qm, stm, dtm, cm, 4),
                  S.plain_run_ref(qm, stm, dtm, cm, 4))
        ms = time_ms(lambda: S.plain_run(qm, stm, dtm, cm, run_n),
                     3) / run_n
        plain_ms = time_ms(lambda: S.plain_run_ref(qm, stm, dtm, cm, 2),
                           plain_reps) / 2
        b = bound((qm, stm), (qm,), m * m, run_n * OPS_PER_CELL)
        fits = S._plain_run_fits(m, m, qm.device)
        print(f"phase 5: plain_run {m}x{m} ({run_n} steps per launch; "
              f"{'fits' if fits else 'exceeds'} the L2 gate): kernel "
              f"{ms:.4f} ms/step, plain twin {plain_ms:.4f} ms/step, bound "
              f"{b[0] / run_n:.4f} ms ({b[1]})")
        if m == FV_SIZES[0]:
            errs["plain_run"] = e
            times["plain_run"] = (ms, plain_ms)
            bounds["plain_run"] = (b[0] / run_n, b[1])
    for label, text in (
            ("plain_steps_bc", inclined_yaml(n, MAX_IT)),
            ("plain_steps_bc (Eyring)", asperity_yaml(n, MAX_IT))):
        pb = problem(text)
        cfg = pb._solver_cfg
        q, st, dt = kernel_inputs(pb, amp=0.01, ghosted=True)
        k, kmax = S._plain_k_steps(cfg), S._k_steps(cfg)
        errs[label] = check(f"{label} k={k} {n}x{n}",
                            S.plain_steps_bc(q, st, dt, cfg, k),
                            S.plain_steps_bc_ref(q, st, dt, cfg, k))
        times[label] = (
            time_ms(lambda: S.plain_sweeps_bc(q, st, dt, cfg,
                                              PLAIN_CALL_STEPS), 3)
            / PLAIN_CALL_STEPS,
            time_ms(lambda: S.plain_steps_bc_ref(q, st, dt, cfg, k),
                    plain_reps) / k)
        b = bound((q, st), (q,), cells, kmax * OPS_PER_CELL)
        bounds[label] = (b[0] / kmax, b[1])
    errs["plain_steps_bc"] = max(errs["plain_steps_bc"],
                                 errs.pop("plain_steps_bc (Eyring)"))
    return errs, times, bounds


# -- K10: blocked Cholesky and triangular solve ------------------------------

K10_SIZES = (256, 512, 1024, 2048)
# against torch.linalg, the reference's tolerance for its kernels against
# XLA (tests/test_cholesky.py:27,38), elementwise |out - ref| <= atol +
# rtol |ref|; against their twins the kernels are held bit for bit
K10_RTOL, K10_ATOL = 2e-4, 5e-5
K10_GRAD_N = 512
# the symmetrised gradient of sum(sin(cholesky(A))) against autograd
# through torch.linalg.cholesky, max difference over the largest entry:
# float32 rounding of two factorizations and of the backward's solves on a
# matrix of condition number < 5 (A A^T / n + I)
K10_GRAD_TOL = 1e-4


def spd(n, seed):
    """A A^T / n + I from numpy's generator, float32 on the card."""
    A = np.random.default_rng(seed).standard_normal((n, n))
    return torch.tensor(A @ A.T / n + np.eye(n), dtype=torch.float32,
                        device=DEVICE)


def k10_close(label, out, ref):
    """Max abs error; raises unless |out - ref| <= atol + rtol |ref|."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: non-finite values")
    excess = float(((out - ref).abs()
                    - (K10_ATOL + K10_RTOL * ref.abs())).max())
    abs_err = float((out - ref).abs().max())
    print(f"  {label}: max abs err {abs_err:.3e} (max excess over atol + "
          f"rtol |ref|: {excess:.3e})")
    if not excess <= 0.:
        raise RuntimeError(f"{label}: outside rtol {K10_RTOL}, atol "
                           f"{K10_ATOL}")
    return abs_err


def k10_same(label, out, ref):
    """Max abs error (0); raises unless ``out`` equals ``ref`` bit for bit:
    the twins repeat the kernels' operations in their order."""
    torch.cuda.synchronize()
    same = torch.equal(out, ref)
    abs_err = float((out - ref).abs().max())
    print(f"  {label}: {'bit for bit' if same else 'DIFFERENT'} (max abs "
          f"err {abs_err:.3e})")
    if not (same and torch.isfinite(out).all()):
        raise RuntimeError(f"{label}: not bit for bit equal")
    return abs_err


def k10_bound(n, m=None):
    """(bound_ms, bound_by): the Cholesky's n^3/3 multiply-adds, or the
    solve's n^2 m / 2, one fused multiply-add each at the FP32 issue rate
    (the function needs no more; the kernel's --fmad=false is a choice of
    its build), against its bytes (the factor: A read, L written; the
    solve: L and B read, X written) at the HBM rate."""
    if m is None:
        ops, nbytes = n ** 3 / 3., 2. * n * n * 4
    else:
        ops, nbytes = n * n * m / 2., (n * n + 2. * n * m) * 4
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_entries(text):
    """One ``name: registers, shared memory; stack, spills`` string per
    kernel in a source's section of the ptxas log (names demangled to the
    kernel and its template arguments)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d([a-z_]+?kernel|tril_copy)"
                          r"(I((?:L[ib]\d+E)+)E)?", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(3):
                name += "<" + ",".join(
                    v if t == "i" else "TF"[v == "0"]
                    for t, v in re.findall(r"L([ib])(\d+)E", k.group(3)))
                name += ">"
        elif name and ("stack frame" in line or "Used" in line):
            out.setdefault(name, []).append(
                line.split("ptxas info    : ")[-1].strip())
    return [f"{k}: {', '.join(v)}" for k, v in out.items()]


# kernel-name prefixes of one K10 call, the split k10_profile prints
K10_PARTS = (("diagonal tiles", "diag_kernel"),
             ("batched inverses", "inv_kernel"),
             ("products", "gemm_kernel"), ("copies", "tril_copy"))


def k10_profile(C, A, L, B):
    """Where one call of each K10 entry goes on the card: torch.profiler's
    device time per CUDA kernel and copy over one call, split into the
    diagonal tiles, the batched inverses, the products and the copies.
    Raises if the kernels the call launched differ from
    ``C.kernel_launches(n)``; where the profiler records no device time it
    says so."""
    n = A.shape[0]
    for label, fn in (("cholesky", lambda: C.cholesky_kernel(A)),
                      ("tril_solve", lambda: C.tril_solve_kernel(L, B))):
        prof = profiled(fn)
        rows = []
        for e in prof.key_averages():
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = getattr(e, "cuda_time_total", 0.)
            if dev and not e.key.startswith("aten::"):
                rows.append((dev, e.count, e.key))
        if not rows:
            print(f"  profile {label} n {n}: no device time recorded")
            continue
        total = sum(r[0] for r in rows)
        parts = {part: [0., 0] for part, _ in K10_PARTS}
        parts["other"] = [0., 0]
        for dev, count, key in rows:
            part = next((p for p, k in K10_PARTS if k in key), "other")
            if "Memcpy" in key or "Memset" in key:
                part = "copies"
            parts[part][0] += dev
            parts[part][1] += count
        kernels = sum(c for d, c, k in rows
                      if "Memcpy" not in k and "Memset" not in k)
        print(f"  profile {label} n {n}, one call: device time "
              f"{total / 1e3:.4f} ms = "
              + " + ".join(f"{p} {d / 1e3:.4f} (x{c}, {d / total:.1%})"
                           for p, (d, c) in parts.items() if c)
              + f"; {kernels} kernels (expected "
              f"{C.kernel_launches(n)[label]})")
        for dev, count, key in sorted(rows, reverse=True)[:8]:
            print(f"    {key[:90]} x{count} {dev / 1e3:.4f} ms")
        if kernels != C.kernel_launches(n)[label]:
            raise RuntimeError(f"K10 {label}: {kernels} kernels in one "
                               f"call, expected {C.kernel_launches(n)}")


def linalg_phase():
    """Phase 2k (the caller sets GAPFLOW_PALLAS_LINALG=1): cholesky and
    tril_solve of ops/cholesky.py at K10_SIZES (the solve with m = 128 and m =
    n), and the gradient of sum(sin(cholesky(A))) at K10_GRAD_N: counts
    from 0 before these calls, read after them (one launch sequence per
    call, the backward's two upper solves included); then each output
    against its twin and torch.linalg, the gradient against autograd
    through torch.linalg.cholesky, and each kernel's time per call beside
    its twin's, the library's and its bound.  Returns (launches, errs,
    times, bounds, library ms) keyed by kernel."""
    from gapflow_torch.ops import cholesky as C
    mats = {n: spd(n, n) for n in K10_SIZES}
    rhs = {(n, m): torch.tensor(
        np.random.default_rng(n + m).standard_normal((n, m)),
        dtype=torch.float32, device=DEVICE)
        for n in K10_SIZES for m in sorted({128, n})}
    A_g = mats[K10_GRAD_N].clone().requires_grad_(True)

    torch.cuda.synchronize()
    C.reset_launches()
    Ls = {n: C.cholesky(A) for n, A in mats.items()}
    Xs = {nm: C.tril_solve(Ls[nm[0]], B) for nm, B in rhs.items()}
    torch.sum(torch.sin(C.cholesky(A_g))).backward()
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    want = {"cholesky": len(mats) + 1, "tril_solve": len(rhs) + 2}
    print(f"  launch sequences {launches} (expected {want}); CUDA kernels "
          f"per call (cholesky, tril_solve): "
          + ", ".join(f"{n}: {tuple(C.kernel_launches(n).values())}"
                      for n in K10_SIZES))
    if launches != want:
        raise RuntimeError(f"K10: launches {launches}, expected {want}")

    errs = {"cholesky": 0., "tril_solve": 0.}
    for n, A in mats.items():
        L = Ls[n]
        if not torch.equal(L, torch.tril(L)):
            raise RuntimeError(f"cholesky {n}: upper triangle not zero")
        errs["cholesky"] = max(errs["cholesky"], k10_same(
            f"cholesky n {n} vs twin", L, C._chol_ref(A)))
        k10_close(f"cholesky n {n} vs torch.linalg.cholesky", L,
                  torch.linalg.cholesky(A))
    for (n, m), B in rhs.items():
        L = Ls[n]
        errs["tril_solve"] = max(errs["tril_solve"], k10_same(
            f"tril_solve n {n}, m {m} vs twin", Xs[n, m],
            C._trsm_ref(L, B)))
        k10_close(f"tril_solve n {n}, m {m} vs torch.linalg."
                  f"solve_triangular", Xs[n, m],
                  torch.linalg.solve_triangular(L, B, upper=False))
    A_r = mats[K10_GRAD_N].clone().requires_grad_(True)
    torch.sum(torch.sin(torch.linalg.cholesky(A_r))).backward()
    g, g_r = A_g.grad + A_g.grad.T, A_r.grad + A_r.grad.T
    # the same ops with the twins in the kernels' place
    kernels = C.cholesky_kernel, C.tril_solve_kernel
    C.cholesky_kernel, C.tril_solve_kernel = C._chol_ref, C._trsm_ref
    try:
        A_t = mats[K10_GRAD_N].clone().requires_grad_(True)
        torch.sum(torch.sin(C.cholesky(A_t))).backward()
    finally:
        C.cholesky_kernel, C.tril_solve_kernel = kernels
    k10_same(f"gradient at n {K10_GRAD_N} vs the twins' gradient", A_g.grad,
             A_t.grad)
    g_err = float((g - g_r).abs().max() / g_r.abs().max())
    print(f"  gradient of sum(sin(cholesky(A))) at n {K10_GRAD_N}, "
          f"symmetrised, vs autograd through torch.linalg.cholesky: max "
          f"diff / max entry {g_err:.3e} (limit {K10_GRAD_TOL:g})")
    if not g_err < K10_GRAD_TOL:
        raise RuntimeError(f"K10 gradient: {g_err} >= {K10_GRAD_TOL}")

    per = {}
    for n, A in mats.items():
        L, B = Ls[n], rhs[n, n]
        reps = max(2, 4096 // n)
        per[n] = (
            time_ms(lambda: C.cholesky_kernel(A), reps),
            time_ms(lambda: C._chol_ref(A), 1),
            time_ms(lambda: torch.linalg.cholesky(A), reps),
            time_ms(lambda: C.tril_solve_kernel(L, B), reps),
            time_ms(lambda: C._trsm_ref(L, B), 1),
            time_ms(lambda: torch.linalg.solve_triangular(L, B, upper=False),
                    reps),
            time_ms(lambda: C.tril_solve_kernel(L, rhs[n, 128]), reps))
        bc, bs = k10_bound(n), k10_bound(n, n)
        print(f"  n {n}: cholesky kernel {per[n][0]:.4f} ms/call, twin "
              f"{per[n][1]:.4f}, torch.linalg.cholesky {per[n][2]:.4f}, "
              f"bound {bc[0]:.4f} ({bc[1]}); tril_solve m {n}: kernel "
              f"{per[n][3]:.4f} ms/call, twin {per[n][4]:.4f}, "
              f"torch.linalg.solve_triangular {per[n][5]:.4f}, bound "
              f"{bs[0]:.4f} ({bs[1]}); m 128: kernel {per[n][6]:.4f} "
              f"(bound {k10_bound(n, 128)[0]:.4f})")
    n = K10_SIZES[-1]
    k10_profile(C, mats[n], Ls[n], rhs[n, n])
    times = {"cholesky": per[n][:2], "tril_solve": per[n][3:5]}
    bounds = {"cholesky": k10_bound(n), "tril_solve": k10_bound(n, n)}
    library = {"cholesky": per[n][2], "tril_solve": per[n][5]}
    return launches, errs, times, bounds, library


# -- the half-space on cuFFT at size -----------------------------------------

HALFSPACE_SIZES = (1024, 2050)   # FFT grids 1024², 1026², 2050², 2052²
# the card's deformation against the port's float64 CPU path on the same
# pressure, max difference over max |u|: float64 FFTs differ in their
# summation order only; float32 carries cuFFT's single-precision rounding
# (~eps log2 N of the field's norm)
HALFSPACE_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def halfspace_check():
    """Phase 3r: gapflow_torch/elastic.py on cuFFT (float32 and float64)
    against its float64 CPU path on one pressure (numpy, seed 0), fully
    periodic and free half-spaces, at N x N for N in HALFSPACE_SIZES: the
    FFT grid N x N (``fft_grid="interior"``) and (N+2) x (N+2)
    (``"ghost"``)."""
    from gapflow_torch.elastic import ElasticDeformation
    for n in HALFSPACE_SIZES:
        p = np.random.default_rng(0).standard_normal((n + 2, n + 2))
        for per in (True, False):
            grid = {"dx": 1e-5, "dy": 1e-5, "Nx": n, "Ny": n, "Lx": 1e-5 * n,
                    "Ly": 1e-5 * n, "bc_xE_P": [per] * 3,
                    "bc_yS_P": [per] * 3}
            for fft_grid in ("interior", "ghost"):
                def u_of(device, dtype):
                    ed = ElasticDeformation(E=5e9, v=0.3, alpha_underrelax=1.,
                                            grid=grid, n_images=0,
                                            fft_grid=fft_grid, device=device,
                                            dtype=dtype)
                    u = ed.get_deformation(torch.as_tensor(p, dtype=dtype))
                    return u.double().cpu()
                ref = u_of("cpu", torch.float64)
                for dtype, tol in HALFSPACE_TOL.items():
                    t0 = time.perf_counter()
                    u = u_of(DEVICE, dtype)
                    err = float((u - ref).abs().max() / ref.abs().max())
                    print(f"  {'periodic' if per else 'free'} {fft_grid} "
                          f"({n + 2 if fft_grid == 'ghost' else n}^2 FFT "
                          f"grid) {str(dtype)[6:]}: max diff / max |u| "
                          f"{err:.3e} (limit {tol:g}, "
                          f"{time.perf_counter() - t0:.2f} s)")
                    if not err < tol:
                        raise RuntimeError(f"half-space {n} {per} {fft_grid} "
                                           f"{dtype}: {err} >= {tol}")


# -- the per-step GP loop ----------------------------------------------------

GP_LOOP_IT = 100         # phase 3q: steps of each example configuration
GP_LOOP_JOURNAL_IT, GP_LOOP_JOURNAL_WF = 200, 50
# phase 3q: the 1D journal held in float64 on the card (the plain GP step,
# and the fused steps on the kernels' twins) against the port's float64
# CPU run, and the float32 routes against them
GP_PARITY_IT, GP_PARITY_WF = 30, 10
GP_PARITY_TOL = 1e-6     # scaled q, tests/test_torch_gp_host.py's limit
# the float32 kernel route against the same route on the twins in
# float32, step by step (scaled rho and jx): each fused step is held to
# its twin on the same input at TOL, and the two routes are held to TOL
# too (they agreed bit for bit over the 30 steps on an H100 80GB HBM3)
GP_LOOP_TWIN_TOL = TOL
# the float32 kernel route's distance from the float64 run against the
# float32 plain step's own, up to the first step at which the
# acquisitions part; both are O(10) scaled from the float32 GP mean
# (fault 1), so this bounds the route only coarsely
GP_LOOP_ROUTE_FACTOR = 2.


def example_yaml(name, out, max_it, write_freq=None, edits=(), n=None,
                 silent=False):
    """examples/config/<name>.yaml with its output under ``out`` (and its
    training datasets there), ``max_it`` steps and no convergence stop;
    ``edits`` (old, new) text replacements; ``n`` points per axis."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "config", f"{name}.yaml")
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r"output: .*", f"output: {out}", text)
    text = re.sub(r"use_tstamp: .*", f"use_tstamp: False\n    silent: "
                  f"{silent}", text)
    text = re.sub(r"max_it: .*", f"max_it: {max_it}", text)
    text = re.sub(r"^(\s*)tol: .*", r"\1tol: 1e-30", text, flags=re.M)
    if write_freq is not None:
        text = re.sub(r"write_freq: .*", f"write_freq: {write_freq}", text)
    if n is not None:
        text = re.sub(r"N([xy]): .*", rf"N\1: {n}", text)
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: no {old!r} to edit")
        text = text.replace(old, new)
    return text


#: the four GP example configurations at their own grids, and two frozen
#: variants whose steps between outputs are fused (K6 on D/N edges, K5 on
#: periodic ones)
_FROZEN = (("max_steps: 5", "max_steps: 5\n        active_learning: False"),)
GP_EXAMPLES = (
    ("asperity_2d_lj_gp", (("num: 2", "num: 2\n    seed: 0"),)),
    ("journal_1d_dowson-higginson_gp", ()),
    ("journal_2d_dowson-higginson_gp", ()),
    ("parabolic_1d_lj_gp", ()),
    ("asperity_2d_lj_gp", (("num: 2", "num: 2\n    seed: 0"),) + _FROZEN),
    ("journal_2d_dowson-higginson_gp", _FROZEN),
)
# the 1D journal of tests/test_torch_gp_host.py (a well-conditioned
# pressure surrogate) with the pressure frozen and one acquisition per
# episode, so that the wall stress pauses and the steps between outputs
# are fused (K6 on the D/N x edges in float32)
GP_PARITY_EDITS = (
    ("init_width: 1.e-6", "init_width: 1.e-2"),
    ("obs_stddev: 100.", "obs_stddev: 1.e8\n        active_dims: [0]\n"
     "        active_learning: False"),
    ("max_steps: 5", "max_steps: 1"))


def gp_models(p):
    return [m for m in (p.pressure, p.wall_stress_xz, p.wall_stress_yz)
            if m.is_gp_model]


def run_gp_loop(text, dtype=torch.float32, device=None, record=None,
                fits=None, draws=None):
    """Problem.run() of a non-silent (per-step) GP configuration with the
    launch counts set to 0 just before it.  ``record``: a list that gets
    (q, dt, database size, acquisitions so far, fused steps so far) after
    every step;
    ``fits``: a dict (surrogate, training size) -> hyperparameters, the
    run's own fits recorded into it, or taken from it where present;
    ``draws``: a list of the mock oracle's noise draws in order, recorded
    into it when empty, else taken from it.  Returns (problem, launches,
    wall, times), times the GP inference, training and MD seconds."""
    import contextlib
    import io
    from gapflow_torch import Problem
    from gapflow_torch.models import gp as gpmod
    device = device or DEVICE
    with contextlib.redirect_stdout(io.StringIO()):
        p = Problem.from_string(text, device=device, dtype=dtype)
    acq = []
    t_md = [0.]
    for m in gp_models(p):
        def acquire(var, idx=None, m=m, orig=m._active_learning):
            acq.append(m.name)
            orig(var, idx)
        m._active_learning = acquire
    add = p.database.add_data

    def add_data(X):
        t0 = time.perf_counter()
        add(X)
        t_md[0] += time.perf_counter() - t0
    p.database.add_data = add_data
    if draws is not None:
        md = p.database._md
        replay, own = list(draws), md.draws_fn

        def draw(X):
            if replay:
                return replay.pop(0)
            d = own(X)
            draws.append(d)
            return d
        md.draws_fn = draw
    if record is not None:
        update = p.update

        def recorded():
            update()
            record.append((p.q.copy(), float(p.dt), p.database.size,
                           tuple(acq), p._fused_steps))
        p.update = recorded
    fit = gpmod.fit_hyperparameters
    if fits is not None:
        def keyed_fit(params0, X, Y, yerr, method="BFGS"):
            key = (np.shape(params0["log_scale"]), np.shape(X)[0],
                   np.ndim(Y))
            if key not in fits:
                fits[key] = fit(params0, X, Y, yerr, method)
            return fits[key]
        gpmod.fit_hyperparameters = keyed_fit
    models = gp_models(p)

    def clocks():
        return (sum(m.cumtime_infer.total_seconds() for m in models),
                sum(m.cumtime_train.total_seconds() for m in models),
                t_md[0])
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            p._pre_run()
            before = clocks()
            reset_all()
            t0 = time.perf_counter()
            p.run()
            if device != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        gpmod.fit_hyperparameters = fit
    times = tuple(b - a for a, b in zip(before, clocks()))
    p.acquisitions = acq
    return p, launched(), wall, times


def check_gp_outputs(label, p, max_it):
    """The per-step run ended valid at max_it and wrote its frames and GP
    histories."""
    from gapflow_torch.config import read_history_csv
    from gapflow_torch.nc import NCReader
    check_state(label, p, max_it)
    if p._route != "host_loop":
        raise RuntimeError(f"{label} took {p._route}")
    wf = p.options["write_freq"]
    with NCReader(os.path.join(p.outdir, "sol.nc")) as nc:
        frames = nc.num_frames("solution")
        var = "pressure_var" in nc.variables
    if frames != max_it // wf + 1 + (max_it % wf > 0) or not var:
        raise RuntimeError(f"{label}: {frames} frames, variance {var}")
    for m, tag in zip((p.pressure, p.wall_stress_xz, p.wall_stress_yz),
                      ("zz", "xz", "yz")):
        path = os.path.join(p.outdir, f"gp_{tag}.csv")
        if os.path.exists(path) != m.is_gp_model:
            raise RuntimeError(f"{label}: gp_{tag}.csv {os.path.exists(path)}")
        if m.is_gp_model and read_history_csv(path)["step"][-1] != max_it:
            raise RuntimeError(f"{label}: gp_{tag}.csv ends early")
    return frames


def gp_loop_phase(tmp):
    """Phase 3q: the per-step GP loop (non-silent GP runs) on the card.
    Returns the launches of its kernels over the phase."""
    from gapflow_torch.validate import kernel_vs_plain_err
    total = {}
    for i, (name, edits) in enumerate(GP_EXAMPLES):
        out = os.path.join(tmp, f"{i}_{name}")
        frozen = any("active_learning: False" in e[1] for e in edits)
        p, lau, wall, _ = run_gp_loop(example_yaml(name, out, GP_LOOP_IT,
                                                   edits=edits))
        frames = check_gp_outputs(name, p, GP_LOOP_IT)
        kern = lau.get("gp_step", 0) + lau.get("gp_step_bc", 0)
        print(f"  {name}{' (frozen)' if frozen else ''} "
              f"{p.grid['Nx']}x{p.grid['Ny']}: {GP_LOOP_IT} steps in "
              f"{wall:.3f} s, frames {frames}, acquisitions "
              f"{len(p.acquisitions)} {p.acquisitions}, database "
              f"{p.database.size}, fused steps {p._fused_steps}, launches "
              f"{lau}, dt {p.dt:.4e}")
        if set(lau) - {"gp_step", "gp_step_bc"} or kern != p._fused_steps:
            raise RuntimeError(f"{name}: launches {lau} for "
                               f"{p._fused_steps} fused steps")
        if frozen and not kern:
            raise RuntimeError(f"{name} (frozen): no fused step")
        if kern:
            print(f"    its fused-step kernel: {gp_kernel_ms(p):.4f} ms")
        for k, v in lau.items():
            total[k] = total.get(k, 0) + v

    n = N
    print(f"  the GP journal of 3f non-silent, {n} x {n}, "
          f"{GP_LOOP_JOURNAL_IT} steps, write_freq {GP_LOOP_JOURNAL_WF}:")
    text = gp_journal_yaml(n, max_it=GP_LOOP_JOURNAL_IT).replace(
        "write_freq: 1000000", f"write_freq: {GP_LOOP_JOURNAL_WF}").replace(
        "silent: True", "silent: False").replace(
        "output: data/smoke", f"output: {os.path.join(tmp, 'journal_3f')}")
    p, lau, wall, (t_inf, t_train, t_md) = run_gp_loop(text)
    check_gp_outputs("3q journal", p, GP_LOOP_JOURNAL_IT)
    for k, v in lau.items():
        total[k] = total.get(k, 0) + v
    k_ms = 0.
    if p._fused_steps:
        k_ms = gp_kernel_ms(p)
    t_kernel = p._fused_steps * k_ms / 1e3
    t_host = t_train + t_md
    print(f"    wall {wall:.3f} s = fused-step kernel {t_kernel:.3f} s "
          f"({p._fused_steps} x {k_ms:.4f} ms) + GP inference over the grid "
          f"(means and variances, float64) {t_inf:.3f} s + host protocol "
          f"(BFGS {t_train:.3f} s, MD oracle {t_md:.3f} s) {t_host:.3f} s + "
          f"rest (passes, host copies, writes) "
          f"{wall - t_kernel - t_inf - t_host:.3f} s; acquisitions "
          f"{len(p.acquisitions)}, launches {lau}; 3f's chunked route above")

    print(f"  the 1D journal (tests/test_torch_gp_host.py's surrogates, "
          f"frozen pressure, one acquisition per episode), "
          f"{GP_PARITY_IT} steps: float64 on the card vs float64 on the CPU, "
          f"float32 routes against the same routes")
    fits, draws, runs = {}, [], {}
    for label, dtype, device, how in (
            ("cpu f64", torch.float64, "cpu", "plain"),
            ("card f64", torch.float64, None, "plain"),
            ("card f64 twin route", torch.float64, None, "twins"),
            ("card f32 kernel route", torch.float32, None, "shadow"),
            ("card f32 twin route", torch.float32, None, "twins"),
            ("card f32 plain step", torch.float32, None, "plain")):
        rec = []
        text = example_yaml("journal_1d_dowson-higginson_gp",
                            os.path.join(tmp, label.replace(" ", "_")),
                            GP_PARITY_IT, GP_PARITY_WF, GP_PARITY_EDITS)
        with fused_step(how) as shadow:
            p, lau, wall, _ = run_gp_loop(text, dtype, device, rec, fits,
                                          draws)
        check_gp_outputs(label, p, GP_PARITY_IT)
        print(f"    {label}: acquisitions {p.acquisitions}, fused steps "
              f"{p._fused_steps}, launches {lau}, wall {wall:.3f} s")
        want = p._fused_steps if how == "shadow" else 0
        if sum(lau.values()) != want or set(lau) - {"gp_step_bc"}:
            raise RuntimeError(f"{label}: launches {lau}, {want} expected")
        if how == "shadow":
            if not (want and len(shadow) == want):
                raise RuntimeError(f"{label}: {want} fused steps, "
                                   f"{len(shadow)} held")
            print(f"    its {len(shadow)} fused steps, each against its twin "
                  f"on the same input: max scaled err "
                  f"{max(e[0] for e in shadow):.3e} (limit {TOL:g}), "
                  f"pressure {max(e[1] for e in shadow):.3e} (limit "
                  f"{P_TOL:g}); the kernel on the final state: "
                  f"{gp_kernel_ms(p):.4f} ms")
            for k, v in lau.items():
                total[k] = total.get(k, 0) + v
        runs[label] = rec

    def dist(a, b):
        # rho and jx: the line contact's jy is zero, bar rounding
        return kernel_vs_plain_err(torch.as_tensor(a[:2]),
                                   torch.as_tensor(b[:2]))

    def held(label, run, ref, tol):
        """``run`` against ``ref`` step by step: identical database,
        acquisitions and fused steps at every step, q within ``tol``."""
        worst = 0.
        for i, (a, b) in enumerate(zip(runs[run], runs[ref])):
            if a[2:] != b[2:]:
                raise RuntimeError(f"{label}: step {i}: database {a[2]} vs "
                                   f"{b[2]}, acquisitions {a[3]} vs {b[3]}, "
                                   f"fused steps {a[4]} vs {b[4]}")
            worst = max(worst, dist(a[0], b[0]))
        print(f"    {label}: identical acquisitions and fused steps at "
              f"every step, rho and jx max scaled diff {worst:.3e} (limit "
              f"{tol:g})")
        if not worst < tol:
            raise RuntimeError(f"{label}: {worst} >= {tol}")

    held("card f64 vs CPU f64", "card f64", "cpu f64", GP_PARITY_TOL)
    held("card f64 twin route vs CPU f64", "card f64 twin route", "cpu f64",
         GP_PARITY_TOL)
    held("card f32 kernel route vs card f32 twin route",
         "card f32 kernel route", "card f32 twin route", GP_LOOP_TWIN_TOL)
    dk = dp = 0.
    upto = fused = 0
    for a, b, c in zip(runs["card f32 kernel route"],
                       runs["card f32 plain step"], runs["card f64"]):
        if not (a[2:4] == b[2:4] == c[2:4]):
            break
        upto, fused = upto + 1, a[4]
        dk = max(dk, dist(a[0], c[0]))
        dp = max(dp, dist(b[0], c[0]))
    print(f"    to the card's f64 run over the {upto} steps before the "
          f"acquisitions part ({fused} fused): f32 kernel route {dk:.3e}, "
          f"f32 plain step {dp:.3e} (limit {GP_LOOP_ROUTE_FACTOR:g} x the "
          f"latter)")
    if not (fused and dk <= GP_LOOP_ROUTE_FACTOR * dp):
        raise RuntimeError(f"3q f32 kernel route {dk} vs plain {dp} "
                           f"({upto} steps, {fused} fused)")
    return total


class fused_step:
    """Within the block, the per-step loop's fused step takes ``how``:
    "plain", the plain GP step in every dtype (no kernel); "twins",
    :func:`twin_step`; "shadow", the kernels, each launch held against its twin on
    the same input (the ``as`` target gets (scaled q error, relative p
    error) per launch).  Launch counts are the kernels' only."""

    def __init__(self, how):
        self.how = how
        self.errs = []

    def __enter__(self):
        import gapflow_torch.problem as P
        from gapflow_torch.core.gp_step import make_gp_step_core
        from gapflow_torch.ops import stencil_gp as G
        self.orig = P.make_gp_step, G.gp_step, G.gp_step_bc
        if self.how == "plain":
            P.make_gp_step = lambda *a: make_gp_step_core(
                *a, allow_pallas=False)
        elif self.how == "twins":
            P.make_gp_step = lambda cfg, dims, nf, use: twin_step(cfg, dims,
                                                                  use)
        elif self.how == "shadow":
            errs = self.errs

            def held(kernel, twin):
                def run(q_int, st, dt, cfg, ops, need_p):
                    out = kernel(q_int, st, dt, cfg, ops, need_p=need_p)
                    ref = twin(q_int, st, dt, cfg, ops, need_p=need_p)
                    qk, pk = out if isinstance(out, tuple) else (out, None)
                    qr, pr = ref if isinstance(ref, tuple) else (ref, None)
                    e = (errors("fused step", qk, qr)[0],
                         0. if pk is None else
                         float((pk - pr).abs().max() / pr.abs().max()))
                    errs.append(e)
                    if not (e[0] < TOL and e[1] < P_TOL):
                        raise RuntimeError(f"fused step vs its twin: {e}")
                    return out
                return run
            G.gp_step = held(G.gp_step, G.gp_step_ref)
            G.gp_step_bc = held(G.gp_step_bc, G.gp_step_bc_ref)
            P.make_gp_step = lambda *a: make_gp_step_core(*a)
        return self.errs

    def __exit__(self, *exc):
        import gapflow_torch.problem as P
        from gapflow_torch.ops import stencil_gp as G
        P.make_gp_step, G.gp_step, G.gp_step_bc = self.orig


def gp_kernel_ms(p, reps=20):
    """The fused step's kernel time on a per-step run's final state and
    surrogates (K5 with its pressure or K6 with its ghost-inclusive
    pressure), held against its twin first."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.core.gp_step import cast_gp_state
    cfg = p._solver_cfg
    models = (p.pressure, p.wall_stress_xz, p.wall_stress_yz)
    dims = tuple(tuple(m.active_dims) if m.is_gp_model else None
                 for m in models)
    use = tuple(m.is_gp_model for m in models)
    ops = G.prep_gp_ops(cast_gp_state(p._gp_state(), torch.float32), dims,
                        use)
    q = p._tensor(p.q)[:, 1:-1, 1:-1].contiguous()
    topo = p._tensor(p.topo.full)
    extra = p._tensor(p.fc.get_real_field("extra").p)
    if S._fully_periodic(cfg):
        st = S.interior_statics(topo, extra, torch.float32, q.device)
        (qk, pk), (qr, pr) = (G.gp_step(q, st, p.dt, cfg, ops),
                              G.gp_step_ref(q, st, p.dt, cfg, ops))
        fn = lambda: G.gp_step(q, st, p.dt, cfg, ops)  # noqa: E731
    else:
        st = S.ghost_statics(topo, extra, torch.float32, q.device)
        (qk, pk), (qr, pr) = (G.gp_step_bc(q, st, p.dt, cfg, ops, True),
                              G.gp_step_bc_ref(q, st, p.dt, cfg, ops, True))
        fn = lambda: G.gp_step_bc(q, st, p.dt, cfg, ops, True)  # noqa: E731
    check("fused step on the run's final state", qk, qr)
    check_p("fused step on the run's final state", pk, pr)
    return time_ms(fn, reps)


# -- the sharded path (K9) ---------------------------------------------------

SHARD_STEPS = 200            # phase 3s: steps of each sharded run
SHARD_MESHES = ((1, 1), (2, 2), (2, 4))
SHARD_CASE = "dn_all_asymmetric"   # D/N on four edges: every edge flag
SHARD_EHL_N = 512            # phase 3s: the sharded EHL loop at 512²
SHARD_EHL_EVERY = 4
# phase 3s: the sharded EHL loop's float32 distance from the same route in
# float64 (its twins on the card) may be at most this many times the
# serial float32 EHL loop's (plain step) distance from its float64 run
SHARD_EHL_FACTOR = 2.
SHARD_SPLIT_STEPS = 50       # phase 3s: the split of a 2 x 2 step


def cuda_mesh(shape):
    """A mesh of shape[0] x shape[1] shards, all on cuda:0."""
    from gapflow_torch.parallel import grid_mesh
    return grid_mesh(["cuda:0"] * (shape[0] * shape[1]), shape)


def perturbed(p):
    """``p`` from the perturbed state of phase 2 (amplitude 0.01, seed 0)
    rounded to float32, its ghosts refilled: a float64 run starts from the
    float32 runs' state, so that its distance to them is their
    accumulated rounding only."""
    from gapflow_torch.core.step import apply_bcs
    from gapflow_torch.validate import perturbed_q
    p._pre_run()
    q = torch.as_tensor(perturbed_q(p.q), dtype=torch.float32)
    p.q[...] = apply_bcs(q, p._solver_cfg).numpy()
    return p


def shard_problem(n, case=None):
    """The perturbed n² journal of BC_CASES[case] (periodic without a
    case), dt 2e-11."""
    from gapflow_torch.validate import BC_CASES
    return perturbed(journal(n, n, *(BC_CASES[case] if case else ()),
                             dt=2e-11))


def shard_blocks(p, shape, k=1, extra=0):
    """The 2k-deep halo blocks, the statics (2k + ``extra`` deep) and the
    edge flags of each shard of ``p``'s state on a cuda:0 mesh of
    ``shape`` (float32), as the sharded loop hands them to the shard
    kernels (k = 1: K9's 2-deep blocks)."""
    from gapflow_torch.models.closures_opt import precompute_statics
    from gapflow_torch.ops.stencil import _fully_periodic
    from gapflow_torch.parallel.halo import (halo_blocks,
                                             shard_problem_arrays,
                                             split_blocks)
    from gapflow_torch.parallel.pallas_halo import (pad_blocks2,
                                                    pad_blocks2_bc,
                                                    shard_flags)
    cfg = p._solver_cfg
    mesh = cuda_mesh(shape)
    per = (all(cfg.bc_edge(0)["P"]), all(cfg.bc_edge(2)["P"]))
    d = 2 * k

    def blocks(a, more=extra):
        lay = (pad_blocks2(a, *shape, d + more) if _fully_periodic(cfg)
               else pad_blocks2_bc(a, *shape, *per, d + more))
        return split_blocks(lay, mesh, torch.float32)

    if shape == (1, 1):
        # the whole domain with its serial ghosts repeated to the depth
        # (a block may be thinner than its halo, which halo_blocks refuses)
        hb = blocks(p.q, 0)
    else:
        q, _, _ = shard_problem_arrays(p, mesh, torch.float32)
        hb = halo_blocks(q, mesh, d, cfg)
    t2, e2 = blocks(p.topo.full), blocks(p.fc.get_real_field("extra").p)
    out = []
    for i in range(shape[0]):
        for j in range(shape[1]):
            out.append((hb[i][j], precompute_statics(t2[i][j][:3], e2[i][j])
                        .contiguous(), shard_flags(cfg, mesh, i, j)))
    return out


def held_edge_halo(cfg, q_blk, flags, d):
    """``q_blk`` with its halo on the domain edges ``flags`` holds
    rebuilt as ``halo_blocks`` fills it on a mesh: the edge formulas of
    the block's own lines, x edges first, then y."""
    from gapflow_torch.ops import stencil as S
    xe, xw, yn, ys = flags
    core = q_blk[:, d * xe:q_blk.shape[1] - d * xw,
                 d * ys:q_blk.shape[2] - d * yn]
    return S._edge_pad(cfg, core, flags, d).contiguous()


def check_equal(label, out, ref):
    """``out`` equals ``ref`` bit for bit, else the difference is printed
    and the phase fails."""
    out, ref = torch.as_tensor(out), torch.as_tensor(ref)
    if torch.equal(out, ref):
        print(f"  {label}: equal bit for bit")
        return
    err, abs_err = errors(label, out, ref)
    raise RuntimeError(f"{label}: NOT equal bit for bit: max scaled diff "
                       f"{err:.3e}, max abs diff {abs_err:.3e}")


def shard_kernel_checks():
    """Phase 2s: K9 against its twin on one N_CHECK² block (the perturbed
    four-edge D/N journal with its serial ghosts as the halo), for every
    flag pattern of a 2 x 2 and a 1 x 4 mesh and for zero flags: equal bit
    for bit; then the shard sweep at every depth k = 1..4 on the same
    state as a block with a 2k-deep halo (its held edges' halo as the
    loops fill it), against k one-step K9 launches on the shrinking halo
    and against its twin, bit for bit, and on 1024 x 1 and 1 x 1024
    blocks (x D/N, y periodic) against K9 and the serial boundary sweep.
    Returns (K9's max abs error, the sweep's, the witness launches)."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.parallel.pallas_halo import shard_flags
    p = shard_problem(N_CHECK, SHARD_CASE)
    cfg = p._solver_cfg
    q, st, _ = shard_blocks(p, (1, 1))[0]
    patterns = {(0, 0, 0, 0)}
    for shape in ((2, 2), (1, 4)):
        mesh = cuda_mesh(shape)
        patterns |= {shard_flags(cfg, mesh, i, j) for i in range(shape[0])
                     for j in range(shape[1])}
    reset_all()
    for flags in sorted(patterns):
        check_equal(f"K9 flags (xe, xw, yn, ys) = {flags} vs twin",
                    S.shard_step(q, st, p.dt, cfg, flags),
                    S.shard_step_ref(q, st, p.dt, cfg, flags))
    for k in range(1, S.K_MULTI + 1):
        q, st, _ = shard_blocks(p, (1, 1), k, extra=1)[0]
        for flags in sorted(patterns):
            qf = held_edge_halo(cfg, q, flags, 2 * k)
            out = S.shard_sweep(qf, st, p.dt, cfg, flags, k)
            check_equal(f"shard sweep k={k} flags {flags} vs {k} K9 "
                        f"launches", out,
                        S.shard_steps_once(qf, st, p.dt, cfg, flags, k))
            check_equal(f"shard sweep k={k} flags {flags} vs twin", out,
                        S.shard_sweep_ref(qf, st, p.dt, cfg, flags, k))
    from gapflow_torch.validate import BC_CASES
    for nx, ny in ((1024, 1), (1, 1024)):
        pt = perturbed(journal(nx, ny, *BC_CASES["dn_x"], dt=2e-11))
        ct = pt._solver_cfg
        for k in range(1, S.K_MULTI + 1):
            q, st, _ = shard_blocks(pt, (1, 1), k, extra=1)[0]
            out = S.shard_sweep(q, st, pt.dt, ct, (1, 1, 0, 0), k)
            check_equal(f"shard sweep k={k} on a {nx} x {ny} block vs {k} "
                        f"K9 launches", out,
                        S.shard_steps_once(q, st, pt.dt, ct, (1, 1, 0, 0),
                                           k))
            d = 2 * k + 1
            check_equal(f"shard sweep k={k} on a {nx} x {ny} block vs the "
                        f"serial boundary sweep", out, S.plain_steps_bc(
                            q[:, d - 1:1 - d, d - 1:1 - d].contiguous(),
                            st[:, d - 1:1 - d, d - 1:1 - d].contiguous(),
                            pt.dt, ct, k))
    torch.cuda.synchronize()
    lau = launched()
    print(f"  2s launches (witnesses): {lau}")
    return 0., 0., lau


def sweeps(n, k, every=None):
    """Shard sweeps per shard of an n-step sharded run, k steps per
    exchange, in chunks of ``every`` steps (the sharded EHL loop's
    deformation interval)."""
    every = every or n
    return (n // every) * -(-every // k)


def drive_sharded(label, p, n, shape, every=None, **kw):
    """run_steps_sharded(n) on a cuda:0 mesh of ``shape`` with the launch
    counts set to 0 just before it: the shard sweep once per shard and
    exchange of a 2k-deep halo, k = ``parallel.pallas_halo.SHARD_K``
    (chunks of ``every`` steps).  Returns (launches, wall s)."""
    from gapflow_torch.parallel import pallas_halo as PH
    reset_all()
    t0 = time.perf_counter()
    p.run_steps_sharded(n, cuda_mesh(shape), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lau = launched()
    print(f"  {label} on {shape[0]} x {shape[1]} cuda:0 shards, k = "
          f"{PH.SHARD_K}: launches {lau}, {wall / n * 1e3:.4f} ms per step")
    expect_launches(label, {"shard_sweep": sweeps(n, PH.SHARD_K, every)
                            * shape[0] * shape[1]})
    check_state(label, p, n)
    return lau["shard_sweep"], wall


def timed_run(label, run, n, want):
    """``run()``, ``n`` steps, with the launch counts set to 0 just before
    it and checked against ``want`` just after; returns its result."""
    reset_all()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"  {label}: launches {launched()}, {wall / n * 1e3:.4f} ms per "
          f"step")
    expect_launches(label, want)
    return out


def device_times(fn, reps):
    """torch.profiler's device time per call of ``fn`` over ``reps``
    calls, by kernel (and copy) name, in ms; empty where the profiler
    records no device time."""
    prof = profiled(fn, reps)
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.)
        if dev and not e.key.startswith("aten::"):
            out[e.key] = dev / 1e3 / reps
    return out


def k9_ms(times, key="shard_step_kernel"):
    return sum(v for k, v in times.items() if key in k)


def shard_split(p, n_steps=SHARD_SPLIT_STEPS):
    """The time of a 2 x 2 sharded step on ``p``'s state: the host
    clock's step, and torch.profiler's device time of the shard sweeps
    and of the other kernels (the exchange copies and the statics,
    computed once per call); the rest is the device's idle time, the
    host's launches."""
    from gapflow_torch.parallel.halo import (shard_problem_arrays,
                                             split_blocks)
    from gapflow_torch.parallel.pallas_halo import (
        SHARD_K, make_sharded_bc_pallas_loop, pad_blocks2_bc, statics_depth)
    mesh = cuda_mesh((2, 2))
    n = p.grid["Nx"]
    loop = make_sharded_bc_pallas_loop(p._solver_cfg, mesh, n, n)
    q, _, _ = shard_problem_arrays(p, mesh, torch.float32)
    t2, e2 = (split_blocks(pad_blocks2_bc(a, 2, 2, False, False,
                                          statics_depth()), mesh,
                           torch.float32)
              for a in (p.topo.full, p.fc.get_real_field("extra").p))
    loop(q, t2, e2, p.dt, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(q, t2, e2, p.dt, n_steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    dev = device_times(lambda: loop(q, t2, e2, p.dt, n_steps), 1)
    if not dev:
        print(f"  2 x 2 step at {n}²: {step_ms:.4f} ms; device times not "
              f"measured (the profiler recorded none)")
        return
    key = "shard_sweep_kernel"
    k9 = k9_ms(dev, key) / n_steps
    other = sum(dev.values()) / n_steps - k9
    top = sorted(((v, k) for k, v in dev.items() if key not in k),
                 reverse=True)[:3]
    print(f"  2 x 2 step at {n}², {n_steps} steps, k = {SHARD_K}: "
          f"{step_ms:.4f} ms = shard sweeps {k9:.4f} ms (4 launches per "
          f"{SHARD_K} steps, device time by torch.profiler) + other kernels "
          f"{other:.4f} ms (exchange copies, statics; "
          + ", ".join(f"{k[:36]} {v / n_steps:.4f}" for v, k in top)
          + f") + device idle {step_ms - k9 - other:.4f} ms (host "
          f"launches); sweep share {k9 / step_ms:.3f}, idle share "
          f"{(step_ms - k9 - other) / step_ms:.3f}")


def sharded_ehl_check():
    """Phase 3s, the sharded EHL loop: run_steps_sharded on the perturbed
    SHARD_EHL_N² EHL journal, 2 x 2 cuda:0 shards, deform_every
    SHARD_EHL_EVERY (the shard sweep with zero flags once per shard and
    exchange), held
    route against route: its distance from the same route in float64
    (its twins on the card) at most SHARD_EHL_FACTOR times the serial
    float32 EHL loop's (plain step) distance from its float64 run.
    All four start from the perturbed state of phase 2.  Returns the
    shard sweep's launches."""
    from gapflow_torch.core.ehl import make_ehl_loop
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.parallel.ehl import make_sharded_ehl_loop
    from gapflow_torch.parallel.halo import gather, shard_problem_arrays
    from gapflow_torch.validate import kernel_vs_plain_err
    n, steps, K = SHARD_EHL_N, SHARD_STEPS, SHARD_EHL_EVERY
    p = perturbed(ehl_journal(n))
    lau, wall = drive_sharded(f"sharded EHL loop {n}², deform_every {K}",
                              p, steps, (2, 2), every=K, deform_every=K)
    runs = {"sharded f32": torch.as_tensor(p.q[:, 1:-1, 1:-1])}
    p64 = perturbed(ehl_journal(n, dtype=torch.float64))
    mesh = cuda_mesh((2, 2))
    loop = make_sharded_ehl_loop(p64, mesh, K, use_pallas=True,
                                 sweep_fn=S.shard_sweep_ref)
    q, _, _ = shard_problem_arrays(p64, mesh)
    u = p64.topo.ElasticDeformation.u_prev
    runs["sharded f64"] = gather(timed_run(
        "sharded EHL loop, float64 on the twins",
        lambda: loop(q, u, p64.dt, steps), steps, {})[0])
    for label, dtype in (("serial f32", torch.float32),
                         ("serial f64", torch.float64)):
        ps = perturbed(ehl_journal(n, dtype=dtype))
        sloop = make_ehl_loop(ps, use_pallas=False, dtype=dtype,
                              deform_every=K)
        q_s = timed_run(f"serial EHL loop (plain step), {label[-3:]}",
                        lambda: sloop(ps._tensor(ps.q),
                                      ps.topo.ElasticDeformation.u_prev,
                                      ps.dt, steps)[0], steps, {})
        runs[label] = q_s[:, 1:-1, 1:-1]
    runs = {k: v.to("cpu", torch.float64) for k, v in runs.items()}
    d_sh = kernel_vs_plain_err(runs["sharded f32"], runs["sharded f64"])
    d_se = kernel_vs_plain_err(runs["serial f32"], runs["serial f64"])
    print(f"  sharded f32 (shard sweep) vs its float64 twin route "
          f"{d_sh:.3e} scaled; "
          f"serial f32 plain step vs float64 {d_se:.3e} (limit "
          f"{SHARD_EHL_FACTOR:g} x); sharded vs serial: float64 "
          f"{kernel_vs_plain_err(runs['sharded f64'], runs['serial f64']):.3e}"
          f" (the seam convention), float32 "
          f"{kernel_vs_plain_err(runs['sharded f32'], runs['serial f32']):.3e}"
          f"; max deformation {np.abs(p.topo.deformation).max():.4e} m")
    if not (np.isfinite(d_sh) and d_sh <= SHARD_EHL_FACTOR * d_se):
        raise RuntimeError(f"3s EHL: sharded f32 {d_sh} from its float64 "
                           f"route, serial f32 {d_se} from its own")
    return lau


SHARD_DEPTHS = (2, 3, 4)     # phase 3s: the depths timed per step


def sharded_phase():
    """Phase 3s: Problem.run_steps_sharded on cuda:0 meshes.  The
    perturbed four-edge D/N journal at N², SHARD_STEPS steps, on each of
    SHARD_MESHES at each depth of SHARD_DEPTHS (SHARD_K steps per
    exchange and sweep), equal bit for bit to the serial plain boundary
    route (K3p sweeps); the periodic journal on 2 x 2, equal bit for bit
    to K1 once per step; the split of a 2 x 2 step; the sharded EHL loop.
    The launches counted are those of the runs at the loops' own depth.
    Returns (the shard sweep's launches, the 2 x 2 D/N Problem)."""
    from gapflow_torch.parallel import pallas_halo as PH
    from gapflow_torch.parallel.pallas_halo import ici_bytes_per_step
    n, steps = N, SHARD_STEPS
    total = 0
    ref = shard_problem(n, SHARD_CASE)
    timed_run(f"serial plain boundary route (K3p), {n}²",
              lambda: ref.run_steps_fast(steps, compensated=False), steps,
              plain_launches(ref._solver_cfg, steps))
    k_main = PH.SHARD_K
    walls = {}
    try:
        for k in SHARD_DEPTHS:
            PH.SHARD_K = k
            for shape in SHARD_MESHES:
                p = shard_problem(n, SHARD_CASE)
                lau, wall = drive_sharded(f"D/N journal {n}²", p, steps,
                                          shape)
                walls[k, shape] = wall / steps * 1e3
                check_equal(f"{shape[0]} x {shape[1]}, k = {k} vs serial",
                            p.q, ref.q)
                if k == k_main:
                    total += lau
                    if shape == (2, 2):
                        p22 = p
    finally:
        PH.SHARD_K = k_main
    print("  wall per step (host ms) of the D/N journal, by depth: "
          + "; ".join(f"{a} x {b}: " + ", ".join(
              f"k={k} {walls[k, (a, b)]:.4f}" for k in SHARD_DEPTHS)
              for a, b in SHARD_MESHES)
          + f" (the loops take k = {k_main})")
    ref = shard_problem(n)
    timed_run(f"periodic journal {n}², K1 once per step",
              lambda: k1_run_steps(ref, steps), steps, {"fused_step": steps})
    p = shard_problem(n)
    lau, _ = drive_sharded(f"periodic journal {n}²", p, steps, (2, 2))
    total += lau
    check_equal("2 x 2 vs K1 once per step", p.q, ref.q)
    shard_split(p22)
    for shape in ((2, 2), (2, 4)):
        print(f"  halo copies per shard and step at {n}² on {shape[0]} x "
              f"{shape[1]}: {ici_bytes_per_step(n, n, *shape):.0f} B "
              f"({2 * k_main}-deep per {k_main} steps), one 2-deep per step "
              f"{ici_bytes_per_step(n, n, *shape, mode='step'):.0f} B, the "
              f"TPU package's blocked loop "
              f"{ici_bytes_per_step(n, n, *shape, mode='tpu_blocked'):.0f} "
              f"B (8-deep per 4 steps)")
    total += sharded_ehl_check()
    return total, p22


def shard_kernel_times(p, reps=100, plain_reps=5):
    """Phase 5: one 2 x 2 step of K9 on the 3s D/N state at N² (four
    launches on the shards' halo blocks), and SHARD_K steps of the shard
    sweep (four launches on 2 SHARD_K-deep blocks), each held against its
    twin, timed beside it and its bound, per step.  Returns {kernel: max
    abs err}, {kernel: (ms, twin ms)}, {kernel: bound}."""
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.parallel.pallas_halo import SHARD_K
    cfg, dt = p._solver_cfg, p.dt
    errs, times, bounds = {}, {}, {}
    for key, k, blocks in (
            ("shard_step", 1, shard_blocks(p, (2, 2))),
            ("shard_sweep", SHARD_K, shard_blocks(p, (2, 2), SHARD_K))):
        if key == "shard_step":
            kern, twin = S.shard_step, S.shard_step_ref
        else:
            def kern(q, st, dt_, cfg_, f, k=k):
                return S.shard_sweep(q, st, dt_, cfg_, f, k)

            def twin(q, st, dt_, cfg_, f, k=k):
                return S.shard_sweep_ref(q, st, dt_, cfg_, f, k)
        outs = []
        for q, st, flags in blocks:
            out = kern(q, st, dt, cfg, flags)
            check_equal(f"{key} flags {flags} (phase 5) vs twin", out,
                        twin(q, st, dt, cfg, flags))
            outs.append(out)
        errs[key] = 0.

        def run(fn):
            return lambda: [fn(q, st, dt, cfg, f) for q, st, f in blocks]

        # the wrapper's host time per launch exceeds a 512² launch's
        # device time, so events around a run of launches time the host;
        # the kernel's own time is the profiler's device time (events
        # where it records none)
        ev = time_ms(run(kern), reps) / k
        name = f"{key}_kernel"
        dev = k9_ms(device_times(run(kern), 20), name) / k
        print(f"  {key}, one 2 x 2 exchange ({k} step{'s' * (k > 1)}): "
              f"device time {dev:.4f} ms a step (torch.profiler, 4 "
              f"launches), events around the launches {ev:.4f} ms a step "
              f"(the wrapper's host time)")
        times[key] = (dev or ev, time_ms(run(twin), plain_reps) / k)
        ins = [t for q, st, _ in blocks for t in (q, st)]
        b = bound(ins, outs, N * N, k * OPS_PER_CELL)
        bounds[key] = (b[0] / k, b[1])
    return errs, times, bounds


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from gapflow_torch.ops import _build
    from gapflow_torch.ops import mixed_bc as M
    from gapflow_torch.ops import stencil as S
    from gapflow_torch.validate import BC_CASES, MIXED_CASES

    # -- phase 1: card, versions, build -----------------------------------
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.is_file():       # absent where the library was built earlier
        text = log.read_text()
        print("  ptxas, the sweep bodies (the compensated multi_step_kernel, "
              "the plain sweep_kernel) and the one-step compensated "
              "kernels: " + "; ".join(
                  entry for src in ("stencil.cu", "stencil_bc.cu",
                                    "stencil_plain.cu")
                  for entry in ptxas_entries(
                      text.split(f"== {src}")[-1].split("\n== ")[0])
                  if re.search("multi_step|sweep_kernel|comp_step|,2>",
                               entry)))
        shard = text.split("== stencil_shard.cu")[-1]
        print("  ptxas, K9 (stencil_shard.cu): " + "; ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in shard.splitlines()
            if "stack frame" in line or "Used" in line))
        print("  ptxas, K10 (cholesky.cu): " + "; ".join(
            ptxas_entries(text.split("== cholesky.cu")[-1]
                          .split("\n== ")[0])))
        print("  ptxas, K5-K7 (stencil_gp.cu): " + "; ".join(
            ptxas_entries(text.split("== stencil_gp.cu")[-1]
                          .split("\n== ")[0])))

    # -- phase 2: kernels vs plain twins, float32 on the card --------------
    print("phase 2: kernel vs plain twin (256 x 256 perturbed journal)")
    p = journal(N_CHECK, N_CHECK)
    cfg = p._solver_cfg
    q, st, dt = kernel_inputs(p, amp=0.01)
    err = {}
    err["fused_step"] = check("K1 fused_step", S.fused_step(q, st, dt, cfg),
                              S.fused_step_ref(q, st, dt, cfg))
    lo = torch.zeros_like(q)
    qk, lk = S.comp_steps(q, lo, st, dt, cfg, 8)
    qr, lr = S.comp_steps_ref(q, lo, st, dt, cfg, 8)
    err["comp_sweep"] = check("K2c comp_steps x8, two sweeps (q)", qk, qr)
    if not torch.isfinite(lk).all():
        raise RuntimeError("K2c: non-finite Kahan carry")
    qk, lk = q, lo
    for _ in range(8):
        qk, lk = S.comp_step_once(qk, lk, st, dt, cfg)
    err["comp_step"] = check("K2 comp_step_once x8 (q)", qk, qr)
    print("phase 2b: one K1 step per EOS / piezo model (64 x 128)")
    for label, props in _MODEL_CASES:
        pm = journal(64, 128, props=props)
        if not S._periodic_kernel_ok(pm._solver_cfg):
            raise RuntimeError(f"{label}: kernel gate refuses the model")
        qm, stm, dtm = kernel_inputs(pm, amp=0.01)
        check(label, S.fused_step(qm, stm, dtm, pm._solver_cfg),
              S.fused_step_ref(qm, stm, dtm, pm._solver_cfg))

    # dt 2e-11: at 5e-11 the Barus + Eyring state goes non-finite within
    # the 8 compensated steps (twin and kernel alike)
    print("phase 2c: K3 vs plain twin (256 x 256, amplitude 0.01, dt "
          "2e-11)")
    err["fused_step_bc"] = err["comp_step_bc"] = err["comp_sweep_bc"] = 0.
    for case, (grid, props) in BC_CASES.items():
        pb = journal(N_CHECK, N_CHECK, grid, props, dt=2e-11)
        cfg = pb._solver_cfg
        q, st, dt = kernel_inputs(pb, amp=0.01, ghosted=True)
        err["fused_step_bc"] = max(err["fused_step_bc"], check(
            f"K3 {case}", S.fused_step_bc(q, st, dt, cfg),
            S.fused_step_bc_ref(q, st, dt, cfg)))
        lo = torch.zeros_like(q)
        qk, lk = S.comp_steps_bc(q, lo, st, dt, cfg, 8)
        qr, _ = S.comp_steps_bc_ref(q, lo, st, dt, cfg, 8)
        err["comp_sweep_bc"] = max(err["comp_sweep_bc"], check(
            f"K3c {case} comp_steps_bc x8, sweeps (q)", qk, qr))
        if not torch.isfinite(lk).all():
            raise RuntimeError("K3c: non-finite Kahan carry")
        qk, lk = q, lo
        for _ in range(8):
            qk, lk = S.comp_step_bc_once(qk, lk, st, dt, cfg)
        err["comp_step_bc"] = max(err["comp_step_bc"], check(
            f"K3 {case} comp_step_bc_once x8 (q)", qk, qr))
    for case in ("dn_x", "dn_x_barus_eyring"):       # 1D: Ny = 1
        pb = journal(1024, 1, *BC_CASES[case])
        q, st, dt = kernel_inputs(pb, amp=0.01, ghosted=True)
        check(f"K3 {case} 1024 x 1", S.fused_step_bc(q, st, dt,
                                                     pb._solver_cfg),
              S.fused_step_bc_ref(q, st, dt, pb._solver_cfg))
    print("phase 2c: one K3 step per EOS / piezo model on D/N x edges "
          "(64 x 128)")
    for label, props in _MODEL_CASES:
        rho0 = re.search(r"rho0: ([0-9.e+-]+)", props).group(1)
        pm = journal(64, 128, f"xE: ['D', 'N', 'N'], xW: ['D', 'N', 'N'], "
                     f"xE_D: {rho0}, xW_D: {rho0}", props)
        qm, stm, dtm = kernel_inputs(pm, amp=0.01, ghosted=True)
        check(label, S.fused_step_bc(qm, stm, dtm, pm._solver_cfg),
              S.fused_step_bc_ref(qm, stm, dtm, pm._solver_cfg))

    print("phase 2d: K4 vs plain twin (256 x 256, amplitude 0.01)")
    err["mixed_step"] = 0.
    for case in ("x_mixed", "both_mixed"):
        pm = journal(N_CHECK, N_CHECK, MIXED_CASES[case], dt=2e-11)
        cfg = pm._solver_cfg
        q_g, st, gx, gy, dt = mixed_inputs(pm, amp=0.01)
        for d in (False, True):
            err["mixed_step"] = max(err["mixed_step"], check(
                f"K4 {case} emit_delta={d}",
                M.mixed_step(q_g, st, gx, gy, dt, cfg, emit_delta=d),
                M.mixed_step_ref(q_g, st, gx, gy, dt, cfg, emit_delta=d)))
        args = (q_g, pm.topo.full, pm.fc.get_real_field("extra").p, dt, 8)
        loops = [M.make_mixed_loop(cfg, N_CHECK, N_CHECK, compensated=True,
                                   step_fn=f)(*args)
                 for f in (M.mixed_step, M.mixed_step_ref)]
        err["mixed_step"] = max(err["mixed_step"], check(
            f"K4 {case} compensated loop x8 (ghosts included)", *loops))

    print(f"phase 2g: GP kernels vs plain twins, bit for bit ({N_CHECK} x "
          f"{N_CHECK} journal, synthetic surrogates, capacities "
          f"{GP_CHECK_CAPS}; the means kernel alone per feature and output "
          f"count; the written-out sqrt)")
    gp_fields_checks()
    from gapflow_torch.validate import GP_CASES, gp_kernel_parity, gp_yaml
    err["gp_step"] = err["gp_step_bc"] = err["gp_steps"] = 0.
    edges = {"periodic": "", "dn_x": BC_CASES["dn_x"][0],
             "dn_all_asymmetric": BC_CASES["dn_all_asymmetric"][0],
             "dn_y": "yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'], "
                     "yS_D: 877.7007, yN_D: 877.7007"}
    import tempfile
    for case in ("pressure", "all"):
        for edge, grid in edges.items():
            if edge != "periodic" and case != "all":
                continue
            pg = gp_problem(gp_yaml(N_CHECK, N_CHECK, gp=GP_CASES[case],
                                    grid=grid, out="data/smoke",
                                    dtool_path=tempfile.mkdtemp()))
            key = "gp_step" if edge == "periodic" else "gp_step_bc"
            for cap in GP_CHECK_CAPS:
                err[key] = max(err[key], gp_check(
                    f"{case} {edge} cap {cap}", pg, cap))
            # the kernel against the plain GP step (Gram-form distance):
            # the JAX package's bar for its kernel (validate.py:372)
            q_err, p_err = gp_kernel_parity(pg, 16)
            print(f"  {case} {edge} cap 16, kernel vs plain GP step: q "
                  f"{q_err:.3e} scaled, p {p_err:.3e} relative")
            if not (q_err < P_TOL and p_err < P_TOL):
                raise RuntimeError(f"{case} {edge}: kernel vs plain GP step "
                                   f"{q_err}, {p_err} >= {P_TOL}")
            if edge == "periodic" and case == "all":
                err["gp_steps"] = gp_check("all periodic cap 16", pg, 16,
                                           steps=8)

    print(f"phase 2h: K8 vs plain twin ({N_CHECK} x {N_CHECK} perturbed "
          f"journal, deformation 1e-9 N(0, 1) from numpy seed 7)")
    from gapflow_torch.validate import (ehl_inputs, ehl_kernel_bitexact,
                                        journal_problem)
    pe = journal_problem(N_CHECK, N_CHECK, device=DEVICE)
    q, hu, u, ls, dt = ehl_inputs(pe)
    err["ehl_step"], err["ehl_comp_step"] = ehl_checks(
        "K8", q, hu, u, ls, dt, pe._solver_cfg)
    p1 = journal_problem(1024, 1, device=DEVICE)
    q1, hu1, u1, ls1, dt1 = ehl_inputs(p1)
    ehl_checks("K8 on a 1024 x 1 journal", q1, hu1, u1, ls1, dt1,
               p1._solver_cfg)
    # the plain (emit_delta) K8 form runs on no float32 run: its path is
    # this identity, validate.ehl_kernel_bitexact, counted from 0
    reset_all()
    ident = [ehl_kernel_bitexact(n_steps=8, nx=N_CHECK, ny=N_CHECK,
                                 shift_ref=shift) for shift in (False, True)]
    torch.cuda.synchronize()
    ehl_ident_launches = launched()
    for shift, r in zip((False, True), ident):
        print(f"  compensated K8 vs emit_delta K8 + explicit Kahan two-sum, "
              f"8 steps, shift_ref {shift}: q max diff {r['q_maxdiff']:.3e}, "
              f"q_lo max diff {r['lo_maxdiff']:.3e}")
        if not r["ok"]:
            raise RuntimeError(f"K8 identity: {r}")
    print(f"  (launches {ehl_ident_launches})")

    print(f"phase 2i: plain whole-run kernels (Kv, the plain sweeps at "
          f"every depth and in one C call) vs K1/K3 launched once per step, "
          f"bit for bit, and vs their twins ({N_CHECK} x {N_CHECK} and 40 x "
          f"72 journal, BC_CASES, Eyring asperity, 1024 x 1 grids, "
          f"amplitude 0.01)")
    plain_witness = plain_kernel_checks(err)
    print(f"phase 2i: compensated sweeps vs the one-step compensated "
          f"kernels launched once per step, q and q_lo bit for bit, from a "
          f"nonzero carry ({N_CHECK} x {N_CHECK} and 40 x 72 journal, "
          f"BC_CASES, Eyring asperity), and vs their twins")
    witness_launches = comp_sweep_checks(err)

    print(f"phase 2s: K9 vs plain twin ({N_CHECK} x {N_CHECK} perturbed "
          f"four-edge D/N journal as one shard block with its serial "
          f"ghosts, the edge flags of a 2 x 2 and a 1 x 4 mesh and zero "
          f"flags); the shard sweep at k = 1..4 vs k K9 launches and vs "
          f"its twin on those patterns, and on 1024 x 1 and 1 x 1024 "
          f"blocks")
    err["shard_step"], err["shard_sweep"], shard_witness = \
        shard_kernel_checks()

    print(f"phase 2k: K10, cholesky and tril_solve with "
          f"GAPFLOW_PALLAS_LINALG=1 at n {', '.join(map(str, K10_SIZES))} "
          f"(A A^T / n + I, numpy seed n), the solve with m 128 and m n, "
          f"the gradient at n {K10_GRAD_N}")
    os.environ["GAPFLOW_PALLAS_LINALG"] = "1"
    try:
        k10 = linalg_phase()
    finally:
        del os.environ["GAPFLOW_PALLAS_LINALG"]

    # -- phase 3: the main paths ------------------------------------------
    n, max_it = N, MAX_IT
    print(f"phase 3: Problem.run(), silent float32 journal {n} x {n}, "
          f"max_it {max_it}")
    # chunks of 1024 steps and one of 2: 4 x 342 sweeps of 3 steps (the
    # last of each chunk 1 step) and one of 2; no one-step kernel
    one_step = ("comp_step", "comp_step_bc", "fused_step", "fused_step_bc")
    launches = drive("journal", journal(n, n, dt=1e-11, max_it=max_it),
                     {"comp_sweep": 1369}, one_step)
    launches["comp_step"] = witness_launches["comp_step"]

    print(f"phase 3b: Problem.run(), silent float32 inclined slider {n} x "
          f"{n}, D/N x edges, PL, adaptive dt, max_it {max_it}")
    lb = drive("inclined", problem(inclined_yaml(n, max_it)),
               {"comp_sweep_bc": 1369}, one_step)
    launches["comp_sweep_bc"] = lb["comp_sweep_bc"]
    launches["comp_step_bc"] = witness_launches["comp_step_bc"]
    # K3 runs on no main path since the plain boundary route takes its
    # remainder as a sweep: its launches are 2i's, as the plain sweeps'
    # witness
    launches["fused_step_bc"] = plain_witness["fused_step_bc"]

    print(f"phase 3c: Problem.run(), silent float32 asperity contact {n} x "
          f"{n}, D/N on four edges, BWR, Eyring thinning, max_it 1026")
    pa = problem(asperity_yaml(n, 1026))
    # with thinning the compensated sweeps are one step deep
    la = drive("asperity", pa, {"comp_sweep_bc": 1026}, one_step)
    launches["comp_sweep_bc"] += la["comp_sweep_bc"]
    from gapflow_torch.core.step import effective_viscosity
    from gapflow_torch.models.eos import eos_pressure
    qa = torch.as_tensor(pa.q, dtype=torch.float32, device=DEVICE)
    h = torch.as_tensor(pa.topo.full[0], dtype=torch.float32, device=DEVICE)
    cfg = pa._solver_cfg
    factor = (effective_viscosity(cfg, qa[0], eos_pressure(qa[0], cfg.prop), h)
              / cfg.shear)[1:-1, 1:-1]
    f_min = float(factor.min())
    print(f"  thinning factor eta/mu0: min {f_min:.4f}, "
          f"mean {float(factor.mean()):.4f} (tauE {ASPERITY_TAUE})")
    if not f_min < THINNING_ENGAGED:
        raise RuntimeError(f"thinning not engaged: min factor {f_min}")

    print("phase 3d: Problem.run(), silent float32 journal 256 x 256 on "
          "mixed P/D/N edges (both axes), max_it 256")
    pm = journal(N_CHECK, N_CHECK, MIXED_CASES["both_mixed"], dt=2e-11,
                 max_it=256)
    lm = drive("mixed journal", pm, {"mixed_step": 256})
    launches["mixed_step"] = lm["mixed_step"]

    # The plain torch step accumulates each increment into the f32 state,
    # so the check holds the uncompensated kernel route (K3 once per step)
    # to it.  The compensated route (the default) differs from it by the
    # plain step's f32 accumulation error, so it is held to the plain step
    # run in float64 instead, within COMP_ROUTE_TOL.
    print("phase 3e: route agreement, inclined slider 128 x 128, fixed dt "
          "1e-9, 200 steps: run_compiled_fast vs run_compiled (f32 on the "
          "card)")
    runs = {}
    for route, comp, expect in (
            ("run_compiled_fast", False, None),
            ("run_compiled_fast", True, {"comp_sweep_bc": 67}),
            ("run_compiled", None, {})):
        pr = problem(inclined_yaml(128, 200, adaptive=0, dt=1e-9))
        pr._pre_run()
        if expect is None:
            expect = plain_launches(pr._solver_cfg, 200)
        S.reset_launches()
        getattr(pr, route)(**({} if comp is None else {"compensated": comp}))
        label = route if comp is None else f"{route} compensated={comp}"
        got = {k: v for k, v in S.LAUNCHES.items() if v}
        print(f"  {label}: launches {got}")
        if got != expect:
            raise RuntimeError(f"{label}: unexpected launches {got}")
        if pr.step != 200:
            raise RuntimeError(f"{label} stopped at step {pr.step}")
        runs[comp] = torch.as_tensor(pr.q)
    from gapflow_torch import Problem
    from gapflow_torch.validate import kernel_vs_plain_err
    p64 = Problem.from_string(inclined_yaml(128, 200, adaptive=0, dt=1e-9),
                              device=DEVICE, dtype=torch.float64)
    p64.run_compiled()
    q64 = torch.as_tensor(p64.q)
    route_err = kernel_vs_plain_err(runs[False], runs[None])
    print(f"  scaled max difference, uncompensated kernel route (K3p "
          f"sweeps) vs plain step {route_err:.3e}; compensated kernel "
          f"route vs plain step "
          f"{kernel_vs_plain_err(runs[True], runs[None]):.3e}")
    to64 = {c: kernel_vs_plain_err(runs[c], q64) for c in runs}
    print("  scaled max difference to the float64 plain step: "
          + ", ".join(f"{k} {to64[c]:.3e}"
                      for k, c in (("plain step", None),
                                   ("uncompensated", False),
                                   ("compensated", True))))
    if not (np.isfinite(route_err) and route_err < ROUTE_TOL):
        raise RuntimeError(f"routes disagree: {route_err} >= {ROUTE_TOL}")
    if not (np.isfinite(to64[True]) and to64[True] < COMP_ROUTE_TOL):
        raise RuntimeError(f"compensated route vs float64 plain step: "
                           f"{to64[True]} >= {COMP_ROUTE_TOL}")

    print(f"phase 3f: Problem.run(), silent float32 GP journal {n} x {n} "
          f"(bench.py bench_gp_al_e2e: three surrogates, active learning, "
          f"mock oracle), max_it {GP_MAX_IT}")
    pj = gp_problem(gp_journal_yaml(n))
    lg, wall = drive_gp("GP journal, active learning", pj, "gp_chunked",
                        {"gp_step": 1})
    launches["gp_step"] = lg["gp_step"]
    err["gp_step"] = max(err["gp_step"],
                         gp_breakdown("3f", pj, lg, wall, "gp_step"))

    print(f"phase 3g: Problem.run(), the same with active_learning: False "
          f"(frozen surrogates), max_it {GP_MAX_IT}")
    pf = gp_problem(gp_journal_yaml(n, al=False))
    lg, wall = drive_gp("GP journal, frozen", pf, "gp_fast",
                        {"gp_steps": GP_MAX_IT})
    launches["gp_steps"] = lg["gp_steps"]
    err["gp_steps"] = max(err["gp_steps"],
                          gp_breakdown("3g", pf, lg, wall, "gp_steps"))

    print(f"phase 3h: Problem.run(), silent float32 GP asperity contact {n} "
          f"x {n} (examples/config/asperity_2d_lj_gp.yaml: BWR, D/N on four "
          f"edges, active learning), fixed dt, max_it {GP_MAX_IT}")
    pa = gp_problem(gp_asperity_yaml(n))
    lg, wall = drive_gp("GP asperity, active learning", pa, "gp_chunked",
                        {"gp_step_bc": 1})
    launches["gp_step_bc"] = lg["gp_step_bc"]
    err["gp_step_bc"] = max(err["gp_step_bc"],
                            gp_breakdown("3h", pa, lg, wall, "gp_step_bc"))
    print("phase 3h, again: the same configuration in a new Problem")
    pa2 = gp_problem(gp_asperity_yaml(n))
    drive_gp("GP asperity, active learning, again", pa2, "gp_chunked",
             {"gp_step_bc": 1})
    compare_triggers(pa.al_stats["triggers"], pa2.al_stats["triggers"])

    print(f"phase 3i: route agreement, the GP journal of 3f at "
          f"{GP_ROUTE_N} x {GP_ROUTE_N}, initial density spread "
          f"+-{GP_ROUTE_WIDTH:g}, {GP_ROUTE_STEPS} steps with active "
          f"learning: kernel route vs the plain GP step")
    gp_route_check()

    print(f"phase 3j: Problem.run_steps_ehl({EHL_STEPS}), silent float32 "
          f"EHL journal {n} x {n} (bench.py bench_ehl_step: DH, E 5e9, nu "
          f"0.3, alpha 1e-4, fixed dt 5e-11, fully periodic)")
    le, (e1, e2), _, pj3 = ehl_main(n)
    launches["ehl_comp_step"] = le["ehl_comp_step"]
    launches["ehl_step"] = ehl_ident_launches["ehl_step"]
    err["ehl_step"] = max(err["ehl_step"], e1)
    err["ehl_comp_step"] = max(err["ehl_comp_step"], e2)

    print(f"phase 3k: Problem.run(), the same configuration, max_it "
          f"{EHL_RUN_IT}")
    pk = ehl_journal(n, max_it=EHL_RUN_IT)
    reset_all()
    t0 = time.perf_counter()
    pk.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"  route {pk._route}, steps {pk.step}, launches {launched()}, "
          f"wall {wall:.3f} s, {n * n * pk.step / wall:.4e} cell-updates/s")
    if pk._route != "ehl_pass2":
        raise RuntimeError(f"3k took {pk._route}")
    expect_launches("3k", {"gp_step": EHL_RUN_IT})
    check_state("3k", pk, EHL_RUN_IT)
    e5, k_ms = k5_empty_check("3k final state and gap", pk, reps=50)
    err["gp_step"] = max(err["gp_step"], e5)
    f_ms = deform_ms(pk, ehl_run_inputs(pk)[-1], 50)
    step_ms = wall / EHL_RUN_IT * 1e3
    print(f"  3k per step: wall {step_ms:.4f} ms = K5 without surrogates "
          f"{k_ms:.4f} ms + deformation {f_ms:.4f} ms + rest "
          f"{step_ms - k_ms - f_ms:.4f} ms (the deformed gap's topography "
          f"and statics, EOS, host launches, chunk statistics); K5 share "
          f"{k_ms / step_ms:.3f}")
    print(f"phase 3k: route agreement on the pass-2 protocol, "
          f"{EHL_ROUTE_N} x {EHL_ROUTE_N}, {EHL_ROUTE_STEPS} steps")
    ehl_route_check()

    print(f"phase 3l: GP x elastic, frozen surrogates, {n} x {n} (bench.py "
          f"bench_gp_ehl: V 0.05, {GP_CAP} synthetic points x 3 "
          f"surrogates), run_steps_gp_fast({GP_EHL_STEPS})")
    _, e5, _ = gp_ehl_main(n)
    err["gp_step"] = max(err["gp_step"], e5)

    print(f"phase 3m: Problem.run(), the flagship rough-surface EHL "
          f"(examples/config/asperity_2d_ehl_gp.yaml at {FLAGSHIP_N} x "
          f"{FLAGSHIP_N}, seeded asperities, chunked active learning), "
          f"max_it {FLAGSHIP_IT}")
    pf3 = gp_problem(flagship_yaml(FLAGSHIP_N, FLAGSHIP_IT))
    lf, _ = drive_gp("flagship EHL", pf3, "gp_chunked", {"gp_step_bc": 1})
    launches["gp_step_bc"] += lf["gp_step_bc"]
    print(f"  its K6 step with the pass-2 pressure on the final state and "
          f"gap: {gp_kernel_ms(pf3):.4f} ms")
    if not np.isfinite(pf3.topo.full).all():
        raise RuntimeError("3m: non-finite topography")
    print(f"  max deformation {np.abs(pf3.topo.deformation).max():.4e} "
          f"(gap {pf3.topo.h.min():.4e}..{pf3.topo.h.max():.4e})")

    print(f"phase 3n: Problem.run(), adaptive dt on the device "
          f"(examples/config/parabolic_1d_elastic.yaml, silent), max_it "
          f"{ADAPTIVE_IT}")
    adaptive_check(err)

    print(f"phase 3o: bench.py bench_fv_step (journal, DH, dx 2e-5, dt "
          f"1e-11), run_steps_fast({FV_STEPS}, compensated=False) at "
          f"{', '.join(f'{m}²' for m in FV_SIZES)}: warm-up + median of 3, "
          f"then K1 once per step for the record")
    fv_throughput(launches)
    print(f"phase 3p: run_steps_fast(compensated=False) on the boundary "
          f"paths at {N} x {N}, fixed dt")
    plain_bc_paths(launches)
    print(f"phase 3p: route agreement at {N_CHECK} x {N_CHECK}, "
          f"{PLAIN_ROUTE_STEPS} steps")
    plain_route_check()

    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="gapflow_smoke_")
    try:
        print(f"phase 3q: the per-step GP loop (non-silent GP runs, float32, "
              f"output under a temporary directory): the GP example "
              f"configurations at their own grids, {GP_LOOP_IT} steps each")
        for k, v in gp_loop_phase(tmp).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 3r: the half-space on cuFFT against its float64 CPU path, "
          f"N x N interiors for N in {HALFSPACE_SIZES}, both fft_grid "
          f"conventions")
    halfspace_check()
    print(f"phase 3s: Problem.run_steps_sharded on meshes of cuda:0 shards "
          f"(the shard sweep once per shard and exchange of a 2k-deep "
          f"halo), {SHARD_STEPS} steps: the perturbed four-edge D/N journal "
          f"at {N}² on {', '.join(f'{a} x {b}' for a, b in SHARD_MESHES)} "
          f"at k = {', '.join(map(str, SHARD_DEPTHS))} against the serial "
          f"plain boundary route, the periodic journal on 2 x 2 against "
          f"K1, the sharded EHL loop at {SHARD_EHL_N}²")
    t0 = time.perf_counter()
    launches["shard_sweep"], p_shard = sharded_phase()
    # K9 runs on no main path since the sweep: its launches are 2s's
    launches["shard_step"] = shard_witness.get("shard_step", 0)
    print(f"  phase 3s took {time.perf_counter() - t0:.1f} s")

    # -- phase 4: physics ---------------------------------------------------
    from gapflow_torch.validate import sommerfeld_l2
    t0 = time.perf_counter()
    l2 = sommerfeld_l2(device=DEVICE)
    print(f"phase 4: Sommerfeld rel-L2 {l2:.5f} (256 x 128, 20000 "
          f"compensated f32 steps, {time.perf_counter() - t0:.1f} s)")
    if not l2 < SOMMERFELD_TOL:
        raise RuntimeError(f"Sommerfeld rel-L2 {l2} >= {SOMMERFELD_TOL}")

    # -- phase 5: the kernels at the main paths' shapes ----------------------
    print(f"phase 5: kernel vs plain twin on the main paths' inputs, {n} x "
          f"{n}, amplitude 0.01")
    errs, times, bounds = kernel_times(n)
    print(f"phase 5: plain whole-run kernels vs plain twins, {n} x {n} "
          f"(plain_run at {FV_SIZES[0]}², its main-path size, and forced "
          f"at {n}²), per step")
    perrs, ptimes, pbounds = plain_kernel_times(n)
    errs.update(perrs)
    times.update(ptimes)
    bounds.update(pbounds)
    print(f"phase 5: GP kernels vs plain twins on the GP paths' final "
          f"states, {n} x {n}, {GP_CAP} points x 3 surrogates")
    gerrs, gtimes, gbounds = gp_kernel_times(pj, pa, n)
    errs.update(gerrs)
    times.update(gtimes)
    bounds.update(gbounds)
    print(f"phase 5: K8 vs plain twin on 3j's final state and deformation, "
          f"{n} x {n}")
    q, hu, u, ls, dt, shift, _ = ehl_run_inputs(pj3)
    cfg = pj3._solver_cfg
    errs["ehl_step"], errs["ehl_comp_step"] = ehl_checks(
        "K8 (phase 5)", q, hu, u, ls, dt, cfg, (shift,))
    lo = torch.zeros_like(q)
    # a K8 launch lasts about as long as its wrapper's host work, so
    # events around back-to-back launches time the host: the kernel's
    # time is taken with the launches queued behind a spin kernel
    for key, fn, twin in (
            ("ehl_step",
             lambda: S.ehl_step(q, hu, u, ls, dt, cfg, shift_ref=shift),
             lambda: S.ehl_step_ref(q, hu, u, ls, dt, cfg, shift_ref=shift)),
            ("ehl_comp_step",
             lambda: S.ehl_comp_step(q, lo, hu, u, ls, dt, cfg, shift),
             lambda: S.ehl_comp_step_ref(q, lo, hu, u, ls, dt, cfg,
                                         shift))):
        ev = time_ms(fn, 200)
        dev = queued_ms(fn, 200)
        print(f"  {key}: device time {dev:.4f} ms (200 launches queued "
              f"behind a spin kernel), events around 200 launches as "
              f"they come {ev:.4f} ms")
        times[key] = (dev, time_ms(twin, 20))
    ops = OPS_PER_CELL + EHL_STATICS_OPS
    bounds["ehl_step"] = bound((q, hu, u, ls), (q,), n * n, ops)
    bounds["ehl_comp_step"] = bound((q, lo, hu, u, ls), (q, lo), n * n,
                                    ops)
    print(f"phase 5: K9 and the shard sweep on the 2 x 2 shards of 3s's "
          f"final D/N state, {n} x {n} (four launches an exchange)")
    serrs, stimes, sbounds = shard_kernel_times(p_shard)
    errs.update(serrs)
    times.update(stimes)
    bounds.update(sbounds)
    for k, e in errs.items():
        err[k] = max(err[k], e)
    for k, (ms, plain) in times.items():
        parts = ""
        if len(bounds[k]) > 2:
            parts = (" = max(HBM {:.4f}, FP32 {:.4f}, MUFU {:.4f})"
                     .format(*bounds[k][2]))
        m = FV_SIZES[0] if k == "plain_run" else n
        print(f"phase 5: {k} {m}x{m}: kernel {ms:.4f} ms/step, plain twin "
              f"{plain:.4f} ms/step, bound {bounds[k][0]:.4f} ms "
              f"({bounds[k][1]}){parts}")

    sources = {k: "gapflow_torch/csrc/stencil.cu"
               for k in ("fused_step", "comp_step", "comp_sweep")}
    sources.update({k: "gapflow_torch/csrc/stencil_plain.cu"
                    for k in ("plain_steps", "plain_steps_rem", "plain_run")})
    sources.update({k: "gapflow_torch/csrc/stencil_bc.cu"
                    for k in ("fused_step_bc", "comp_step_bc",
                              "comp_sweep_bc", "mixed_step",
                              "plain_steps_bc")})
    sources.update({k: "gapflow_torch/csrc/stencil_gp.cu"
                    for k in ("gp_step", "gp_step_bc", "gp_steps")})
    sources.update({k: "gapflow_torch/csrc/stencil_ehl.cu"
                    for k in ("ehl_step", "ehl_comp_step")})
    sources["shard_step"] = sources["shard_sweep"] = \
        "gapflow_torch/csrc/stencil_shard.cu"
    # the compensated sweeps replace K2c and K3c on the main paths; the
    # one-step compensated kernels stay listed as their witnesses (2i)
    replaces = {"fused_step": "gapflow_tpu/ops/stencil.py:897",
                "comp_sweep": "gapflow_tpu/ops/stencil.py:681",
                "comp_step": "gapflow_tpu/ops/stencil.py:681",
                "fused_step_bc": "gapflow_tpu/ops/stencil.py:370",
                "comp_sweep_bc": "gapflow_tpu/ops/stencil.py:759",
                "comp_step_bc": "gapflow_tpu/ops/stencil.py:759",
                "mixed_step": "gapflow_tpu/ops/mixed_bc.py:246",
                "gp_step": "gapflow_tpu/ops/stencil_gp.py:269",
                "gp_step_bc": "gapflow_tpu/ops/stencil_gp.py:570",
                "gp_steps": "gapflow_tpu/ops/stencil_gp.py:728",
                "ehl_step": "gapflow_tpu/ops/stencil.py:935",
                "ehl_comp_step": "gapflow_tpu/ops/stencil.py:1105",
                "plain_steps": "gapflow_tpu/ops/stencil.py:681",
                "plain_steps_rem": "gapflow_tpu/ops/stencil.py:1306",
                "plain_run": "gapflow_tpu/ops/stencil.py:1364",
                "plain_steps_bc": "gapflow_tpu/ops/stencil.py:759",
                "shard_step": "gapflow_tpu/ops/stencil.py:457",
                "shard_sweep": "gapflow_tpu/ops/stencil.py:457"}
    # no single PyTorch call computes a MacCormack step: library_ms null;
    # K10's are torch.linalg's, at n 2048 (the solve with m 2048)
    k10_launches, k10_err, k10_times, k10_bounds, library = k10
    for k in ("cholesky", "tril_solve"):
        sources[k] = "gapflow_torch/csrc/cholesky.cu"
        launches[k] = k10_launches[k]
        err[k] = k10_err[k]
        times[k] = k10_times[k]
        bounds[k] = k10_bounds[k]
    replaces.update({"cholesky": "gapflow_tpu/ops/cholesky.py:107",
                     "tril_solve": "gapflow_tpu/ops/cholesky.py:176"})
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k],
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": err[k], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library.get(k)}
        for k in replaces]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--gp-profile"]:
        gp_profile_child()
    else:
        main()
