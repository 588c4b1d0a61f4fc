"""CUDA kernels of the port against their plain twins, on a GPU.

K1/K2 (periodic), K3 (D/N edges and shear thinning, per step and
compensated), the compensated sweeps K2c/K3c (equal bit for bit to the
one-step compensated kernels launched once per step, q and q_lo), K4
(mixed per-component edges, per step and through its loop) on ragged
shapes (no multiple of the 8 x 32 tile), the plain
whole-run kernels (K2p/Ke, Kv, K3p: equal bit for bit to K1 or K3
launched once per step), K5/K6/K7 (the GP-closed steps) at 128 x 128
bit for bit, on every edge layout at 16-200 training points, the means
kernel alone for each feature and output count, the written-out sqrt,
K10 (the blocked Cholesky and triangular solve, forward and backward),
K9 (one shard of a sharded run: every flag pattern against its twin,
K1 and K3 bit for bit), the k-step shard sweep (every flag pattern and
depth against its twin and k one-step K9 launches, thin and 1D blocks,
the blocked sharded loops against the serial route), K8 on the register
body (bit for bit against K1 on the statics it forms) and runs that take
the kernels.  The
kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports no JAX; on a machine without it, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import itertools

import numpy as np
import pytest
import torch

from gapflow_torch import Problem
from gapflow_torch.ops import mixed_bc as M
from gapflow_torch.ops import stencil as S
from gapflow_torch.ops import stencil_gp as G
from gapflow_torch.validate import (BC_CASES, GP_CASES, MIXED_CASES,
                                    gp_kernel_inputs, gp_yaml, journal_yaml,
                                    kernel_vs_plain_err, perturbed_state,
                                    sqrt_sweep, synthetic_gp_ops)

SIM = """
options: {output: data/torch_gpu, write_freq: 1000, silent: True}
grid: {dx: 2.e-5, dy: 2.e-5, Nx: 40, Ny: 72}
geometry: {type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.}
numerics: {CFL: 0.5, adaptive: 0, tol: 1e-30, dt: 5e-11, max_it: 10}
properties: {shear: 0.0794, bulk: 0., EOS: DH, P0: 101325.,
             rho0: 877.7007, C1: 3.5e10, C2: 1.23}
"""


@pytest.fixture
def cuda_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    p = Problem.from_string(SIM, device="cuda", dtype=torch.float32)
    p._pre_run()
    return p


def _inputs(p):
    st = perturbed_state(p, seed=0, amp=0.01)
    q = st.q[:, 1:-1, 1:-1].contiguous()
    return q, S.interior_statics(st.topo, st.extra, torch.float32,
                                 q.device), p.dt


@pytest.mark.gpu
def test_fused_step_matches_twin(cuda_problem):
    """Ragged tiles (40 x 72 is no multiple of the 8 x 32 tile)."""
    cfg = cuda_problem._solver_cfg
    q, st, dt = _inputs(cuda_problem)
    out = S.fused_step(q, st, dt, cfg)
    ref = S.fused_step_ref(q, st, dt, cfg)
    assert kernel_vs_plain_err(out, ref) < 1e-5


@pytest.mark.gpu
def test_comp_steps_matches_twin(cuda_problem):
    cfg = cuda_problem._solver_cfg
    q, st, dt = _inputs(cuda_problem)
    lo = torch.zeros_like(q)
    qk, lk = S.comp_steps(q, lo, st, dt, cfg, 8)
    qr, _ = S.comp_steps_ref(q, lo, st, dt, cfg, 8)
    assert kernel_vs_plain_err(qk, qr) < 1e-5
    assert torch.isfinite(lk).all()
    assert torch.equal(lo, torch.zeros_like(q))     # inputs untouched


@pytest.mark.gpu
def test_run_takes_the_kernels(cuda_problem):
    """10 steps: compensated sweeps of ``_comp_k_steps`` (5 of 2) and one
    of the remainder, one C call."""
    S.reset_launches()
    cuda_problem.run()
    assert cuda_problem._route == "run_compiled_fast"
    sweeps = -(-10 // S._comp_k_steps(cuda_problem._solver_cfg))
    assert S.LAUNCHES == {**S.LAUNCHES, "comp_sweep": sweeps}
    assert sum(S.LAUNCHES.values()) == sweeps


@pytest.mark.gpu
def test_wrapper_rejects_float64(cuda_problem):
    q, st, dt = _inputs(cuda_problem)
    with pytest.raises(TypeError):
        S.fused_step(q.double(), st.double(), dt, cuda_problem._solver_cfg)


# -- boundary kernels ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _problem(grid, props=None, nx=40, ny=72, dt=2e-11, **kw):
    p = Problem.from_string(
        journal_yaml(nx, ny, grid, **({"props": props} if props else {}),
                     dt=dt, out="data/torch_gpu", **kw),
        device="cuda", dtype=torch.float32)
    p._pre_run()
    return p


def _ghosted_inputs(p):
    st = perturbed_state(p, seed=0, amp=0.01)
    q = st.q[:, 1:-1, 1:-1].contiguous()
    return q, S.ghost_statics(st.topo, st.extra, torch.float32,
                              q.device), p.dt


@pytest.mark.gpu
@pytest.mark.parametrize("case, ny", [(c, 72) for c in BC_CASES]
                         + [("dn_x", 1), ("dn_x_barus_eyring", 1)])
def test_fused_step_bc_matches_twin(cuda, case, ny):
    """K3 on every edge/thinning case, and on 1D grids (Ny = 1: the
    y-periodic tile wraps onto itself)."""
    p = _problem(*BC_CASES[case], ny=ny)
    cfg = p._solver_cfg
    q, st, dt = _ghosted_inputs(p)
    S.reset_launches()
    out = S.fused_step_bc(q, st, dt, cfg)
    ref = S.fused_step_bc_ref(q, st, dt, cfg)
    assert S.LAUNCHES["fused_step_bc"] == 1
    assert kernel_vs_plain_err(out, ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dn_x", "periodic_eyring",
                                  "dn_all_asymmetric"])
def test_comp_steps_bc_matches_twin(cuda, case):
    """8 compensated K3 steps (the Barus + Eyring state of this small
    journal goes non-finite within them, twin and kernel alike)."""
    p = _problem(*BC_CASES[case])
    cfg = p._solver_cfg
    q, st, dt = _ghosted_inputs(p)
    lo = torch.zeros_like(q)
    qk, lk = S.comp_steps_bc(q, lo, st, dt, cfg, 8)
    qr, _ = S.comp_steps_bc_ref(q, lo, st, dt, cfg, 8)
    assert kernel_vs_plain_err(qk, qr) < 1e-5
    assert torch.isfinite(lk).all()
    assert torch.equal(lo, torch.zeros_like(q))     # inputs untouched


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MIXED_CASES))
def test_mixed_step_matches_twin(cuda, case):
    """K4 for one step (state and increment, the carried ghosts standing in
    for the band lines) and through 8 compensated loop steps."""
    p = _problem(MIXED_CASES[case])
    cfg = p._solver_cfg
    state = perturbed_state(p, seed=0, amp=1e-3)
    q_g = state.q.contiguous()
    st = S.ghost_statics(state.topo, state.extra, torch.float32, q_g.device)
    gx = q_g[:, [0, -1]].contiguous()
    gy = q_g[:, :, [0, -1]].transpose(1, 2).contiguous()
    for emit_delta in (False, True):
        out = M.mixed_step(q_g, st, gx, gy, p.dt, cfg, emit_delta=emit_delta)
        ref = M.mixed_step_ref(q_g, st, gx, gy, p.dt, cfg,
                               emit_delta=emit_delta)
        assert kernel_vs_plain_err(out, ref) < 1e-5
    nx, ny = p.grid["Nx"], p.grid["Ny"]
    args = (state.q, state.topo, state.extra, p.dt, 8)
    S.reset_launches()
    qk = M.make_mixed_loop(cfg, nx, ny, compensated=True)(*args)
    assert S.LAUNCHES["mixed_step"] == 8
    qr = M.make_mixed_loop(cfg, nx, ny, compensated=True,
                           step_fn=M.mixed_step_ref)(*args)
    assert kernel_vs_plain_err(qk, qr) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dn_x", "dn_x_barus_eyring"])
def test_dn_run_takes_the_kernels(cuda, case):
    """A silent D/N (and thinning) run takes run_compiled_fast: 10 steps
    are compensated sweeps of k and one of 10 mod k, in one C call."""
    p = _problem(*BC_CASES[case], max_it=10)
    S.reset_launches()
    p.run()
    assert p._route == "run_compiled_fast" and p.step == 10
    k = S._comp_k_steps(p._solver_cfg)
    assert S.LAUNCHES["comp_sweep_bc"] == -(-10 // k)
    assert sum(S.LAUNCHES.values()) == -(-10 // k)
    assert np.isfinite(p.q).all() and (p.q[0] > 0).all()


# -- compensated sweeps (K2c, K3c) -------------------------------------------

# chip_smoke.py's Eyring asperity (BWR, D/N on four edges, LJ units) at
# 40 x 72: the sweeps of 2 steps
ASPERITY = """
options: {output: data/torch_gpu, write_freq: 100000, silent: True}
grid: {Lx: 1470., Ly: 1470., Nx: 40, Ny: 72, xE: ['D', 'N', 'N'],
       xW: ['D', 'N', 'N'], yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'],
       xE_D: 0.8, xW_D: 0.8, yS_D: 0.8, yN_D: 0.8}
geometry: {type: asperity, hmin: 12., hmax: 60., num: 2, seed: 0, U: 0.12,
           V: 0.06}
numerics: {CFL: 0.5, adaptive: 0, tol: 1e-30, dt: 0.05, max_it: 10}
properties: {shear: 2.15, bulk: 0., EOS: BWR, T: 1.0, rho0: 0.8,
             thinning: {name: Eyring, tauE: 0.002}}
"""
# D/N edges on y alone, without and with Eyring thinning: with BC_CASES
# (x alone, both axes, periodic with thinning) every instance of the
# sweeps, compiled per periodic axis and thinning
DN_Y = "yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'], yS_D: 877.7007, " \
       "yN_D: 877.7007"
EDGE_CASES = {**BC_CASES, "dn_y": (DN_Y, BC_CASES["dn_x"][1]),
              "dn_y_eyring": (DN_Y, BC_CASES["periodic_eyring"][1])}
# (case, Ny): the ragged 40 x 72 grid, and 1D grids (40 x 1), where a
# tile's window wraps onto its one column
COMP_CASES = [*((c, 72) for c in ("periodic", *EDGE_CASES,
                                  "asperity_eyring")),
              ("periodic", 1), ("dn_x", 1), ("dn_x_barus_eyring", 1)]


def _comp_problem(case, ny=72):
    """The case's problem on the card.  The Barus + Eyring journal takes dt
    2e-12: at 2e-11 its perturbed state goes non-finite within the 18
    compensated steps of these tests (at the fourth; the twin alike)."""
    if case == "periodic":
        return _problem("", ny=ny)
    if case == "asperity_eyring":
        p = Problem.from_string(ASPERITY, device="cuda", dtype=torch.float32)
        p._pre_run()
        return p
    return _problem(*EDGE_CASES[case], ny=ny,
                    dt=2e-12 if case == "dn_x_barus_eyring" else 2e-11)


def _comp_route(case):
    """(inputs, one-step witness, sweeps, C sweep entry, launch key) of a
    case."""
    if case == "periodic":
        return (_inputs, S.comp_step_once, S.comp_steps, "gf_comp_sweeps",
                "comp_sweep")
    return (_ghosted_inputs, S.comp_step_bc_once, S.comp_steps_bc,
            "gf_comp_sweeps_bc", "comp_sweep_bc")


def _sweeps_of(case, cfg, entry, key, q, lo, st, dt, n, k):
    """n compensated steps through the C sweep entry in sweeps of k."""
    extra = () if case == "periodic" else S._bc_params(cfg)
    return S._comp_sweeps(entry, key, q, lo, st, dt, cfg, n, k, *extra)


def _carry(p, inputs, once):
    """A perturbed state and a nonzero carry: 8 one-step compensated
    steps from a zero carry."""
    q, st, dt = inputs(p)
    lo = torch.zeros_like(q)
    for _ in range(8):
        q, lo = once(q, lo, st, dt, p._solver_cfg)
    assert lo.abs().max() > 0
    return q, lo, st, dt


@pytest.mark.gpu
@pytest.mark.parametrize("case, ny", COMP_CASES)
def test_comp_sweeps_match_one_step_kernel(cuda, case, ny):
    """K2c/K3c: n steps in sweeps of the main path's depth k equal n
    launches of the one-step compensated kernel bit for bit, q and q_lo,
    from a nonzero carry on the ragged 40 x 72 grid and on 1D grids,
    periodic, D/N on x, on y and on both, with and without Eyring
    thinning (every instance of comp_sweep_kernel), n = 1..KMAX and
    2 KMAX + 1; ceil(n / k) launches; the inputs untouched."""
    p = _comp_problem(case, ny)
    cfg = p._solver_cfg
    inputs, once, steps, _, key = _comp_route(case)
    q, lo, st, dt = _carry(p, inputs, once)
    q0, lo0 = q.clone(), lo.clone()
    kmax, k = S._k_steps(cfg), S._comp_k_steps(cfg)
    for n in [*range(1, kmax + 1), 2 * kmax + 1]:
        ref = (q, lo)
        for _ in range(n):
            ref = once(*ref, st, dt, cfg)
        S.reset_launches()
        out = steps(q, lo, st, dt, cfg, n)
        assert S.LAUNCHES[key] == -(-n // k)
        assert sum(S.LAUNCHES.values()) == S.LAUNCHES[key]
        assert torch.equal(out[0], ref[0]), n
        assert torch.equal(out[1], ref[1]), n
    assert torch.equal(q, q0) and torch.equal(lo, lo0)


@pytest.mark.gpu
@pytest.mark.parametrize("case, ny", COMP_CASES)
def test_comp_sweeps_of_every_depth_match_one_step_kernel(cuda, case, ny):
    """k = 1..KMAX steps in one sweep, and n = 2 KMAX + 1 steps in sweeps
    of each depth k (n no multiple of k but for k = 1: a remainder
    sweep), through the C sweep entry, equal as many one-step launches
    bit for bit, q and q_lo, from a nonzero carry, on every case of
    COMP_CASES."""
    p = _comp_problem(case, ny)
    cfg = p._solver_cfg
    inputs, once, _, entry, key = _comp_route(case)
    q, lo, st, dt = _carry(p, inputs, once)
    kmax = S._k_steps(cfg)
    n = 2 * kmax + 1
    ref = (q, lo)
    for _ in range(n):
        ref = once(*ref, st, dt, cfg)
    for k in range(1, kmax + 1):
        S.reset_launches()
        out = _sweeps_of(case, cfg, entry, key, q, lo, st, dt, n, k)
        assert S.LAUNCHES[key] == -(-n // k)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]), k
        one = (q, lo)
        for _ in range(k):
            one = once(*one, st, dt, cfg)
        out = _sweeps_of(case, cfg, entry, key, q, lo, st, dt, k, k)
        assert torch.equal(out[0], one[0]) and torch.equal(out[1], one[1]), k


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["periodic", "dn_x", "dn_x_barus_eyring",
                                  "asperity_eyring"])
def test_compensated_loop_launches_the_sweeps(cuda, case):
    """make_pallas_loop(compensated=True, with_lo=True) over 10 steps:
    ceil(10 / k) sweeps and no one-step kernel; q and q_lo equal 10
    one-step launches from the same carry bit for bit."""
    p = _comp_problem(case)
    cfg = p._solver_cfg
    inputs, once, _, _, key = _comp_route(case)
    q, lo, st, dt = _carry(p, inputs, once)
    nx, ny = p.grid["Nx"], p.grid["Ny"]
    state = perturbed_state(p, seed=0, amp=0.01)
    q_g = S.with_ghosts(q, cfg)
    loop = S.make_pallas_loop(cfg, nx, ny, compensated=True, with_lo=True)
    S.reset_launches()
    out, lo_out = loop(q_g, state.topo, state.extra, dt, 10, lo)
    k = S._comp_k_steps(cfg)
    assert {n: v for n, v in S.LAUNCHES.items() if v} == {key: -(-10 // k)}
    ref = (q, lo)
    for _ in range(10):
        ref = once(*ref, st, dt, cfg)
    assert torch.equal(out[:, 1:-1, 1:-1], ref[0])
    assert torch.equal(lo_out, ref[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["periodic", "dn_x", "asperity_eyring"])
def test_comp_sweep_depth_outside_range_raises(cuda, case):
    """A sweep of 0 or KMAX + 1 steps: the C entry refuses it, and its
    error raises through _build.check; nothing is counted and nothing
    falls back to the one-step kernel."""
    p = _comp_problem(case)
    cfg = p._solver_cfg
    inputs, _, _, entry, key = _comp_route(case)
    q, st, dt = inputs(p)
    lo = torch.zeros_like(q)
    S.reset_launches()
    for k in (0, S._k_steps(cfg) + 1):
        with pytest.raises(RuntimeError, match=entry):
            _sweeps_of(case, cfg, entry, key, q, lo, st, dt, 4, k)
    assert not any(S.LAUNCHES.values())


# -- plain whole-run kernels --------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_plain_steps_match_k1(cuda_problem, k):
    """K2p/Ke: k steps in one launch equal k launches of K1 bit for bit,
    and the twin within 1e-5 (40 x 72: ragged tiles)."""
    cfg = cuda_problem._solver_cfg
    q, st, dt = _inputs(cuda_problem)
    ref = q
    for _ in range(k):
        ref = S.fused_step(ref, st, dt, cfg)
    S.reset_launches()
    out = S.plain_steps(q, st, dt, cfg, k)
    assert S.LAUNCHES["plain_steps" if k == S._plain_k_steps(cfg)
                      else "plain_steps_rem"] == 1
    assert torch.equal(out, ref)
    assert kernel_vs_plain_err(out, S.plain_steps_ref(q, st, dt, cfg,
                                                      k)) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 9])
def test_plain_run_matches_k1(cuda_problem, n):
    """Kv: the whole run in one cooperative launch equals n launches of
    K1 bit for bit; the input is left untouched."""
    cfg = cuda_problem._solver_cfg
    q, st, dt = _inputs(cuda_problem)
    q0 = q.clone()
    ref = q
    for _ in range(n):
        ref = S.fused_step(ref, st, dt, cfg)
    S.reset_launches()
    out = S.plain_run(q, st, dt, cfg, n)
    assert S.LAUNCHES["plain_run"] == 1
    assert torch.equal(out, ref)
    assert torch.equal(q, q0)
    assert kernel_vs_plain_err(out, S.plain_run_ref(q, st, dt, cfg,
                                                    n)) < 1e-5


@pytest.mark.gpu
def test_plain_run_raises_when_the_launch_is_refused(cuda_problem):
    """More blocks than can be co-resident: the cooperative launch is
    refused and the wrapper raises (no fallback)."""
    cfg = cuda_problem._solver_cfg
    q, st, dt = _inputs(cuda_problem)
    S.reset_launches()
    with pytest.raises(RuntimeError, match="gf_plain_run"):
        S.plain_run(q, st, dt, cfg, 4, blocks=1 << 20)
    assert S.LAUNCHES["plain_run"] == 0
    torch.cuda.synchronize()          # the device is still usable
    assert torch.equal(S.plain_run(q, st, dt, cfg, 2),
                       S.fused_step(S.fused_step(q, st, dt, cfg), st, dt,
                                    cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("case, ny", [(c, 72) for c in BC_CASES]
                         + [("dn_x", 1), ("dn_x_barus_eyring", 1)])
def test_plain_steps_bc_match_k3(cuda, case, ny):
    """K3p: k steps (up to 4, or 2 with thinning) in one launch equal k
    launches of K3 bit for bit, and the twin within 1e-5."""
    p = _problem(*BC_CASES[case], ny=ny)
    cfg = p._solver_cfg
    q, st, dt = _ghosted_inputs(p)
    ref = q
    for k in range(1, S._k_steps(cfg) + 1):
        ref = S.fused_step_bc(ref, st, dt, cfg)
        S.reset_launches()
        out = S.plain_steps_bc(q, st, dt, cfg, k)
        assert S.LAUNCHES["plain_steps_bc"] == 1
        assert torch.equal(out, ref), k
        assert kernel_vs_plain_err(
            out, S.plain_steps_bc_ref(q, st, dt, cfg, k)) < 1e-5


def _plain_route(case):
    """(inputs, one-step kernel, sweeps wrapper) of a case."""
    if case == "periodic":
        return _inputs, S.fused_step, S.plain_sweeps
    return _ghosted_inputs, S.fused_step_bc, S.plain_sweeps_bc


def _plain_launches(case, cfg, n, k):
    """The launch counts of n plain steps in sweeps of k: every sweep as
    plain_steps_bc on D/N edges; on periodic ones a sweep of the main
    path's depth as plain_steps, any other as plain_steps_rem."""
    full, rem = divmod(n, k)
    if case != "periodic":
        return {"plain_steps_bc": full + (rem > 0)}
    got = {}
    for depth, count in ((k, full), (rem, int(rem > 0))):
        key = ("plain_steps" if depth == S._plain_k_steps(cfg)
               else "plain_steps_rem")
        got[key] = got.get(key, 0) + count
    return {key: v for key, v in got.items() if v}


@pytest.mark.gpu
@pytest.mark.parametrize("case, ny", COMP_CASES)
def test_plain_sweeps_match_one_step_kernel(cuda, case, ny):
    """K2p/Ke/K3p in one C call: n = 1..KMAX and 2 KMAX + 1 steps in
    sweeps of the main path's depth, and 2 KMAX + 1 steps in sweeps of
    every depth k through the C entry, equal n launches of K1 or K3 bit
    for bit on the ragged 40 x 72 grid and on 1D grids, periodic, every
    D/N layout and Eyring thinning; the launches are counted per sweep
    and the input is left untouched."""
    p = _comp_problem(case, ny)
    cfg = p._solver_cfg
    inputs, once, sweeps = _plain_route(case)
    q, st, dt = inputs(p)
    q0 = q.clone()
    kmax = S._k_steps(cfg)
    refs = [q]
    for _ in range(2 * kmax + 1):
        refs.append(once(refs[-1], st, dt, cfg))
    for n in [*range(1, kmax + 1), 2 * kmax + 1]:
        S.reset_launches()
        out = sweeps(q, st, dt, cfg, n)
        assert {k: v for k, v in S.LAUNCHES.items() if v} == \
            _plain_launches(case, cfg, n, S._plain_k_steps(cfg))
        assert torch.equal(out, refs[n]), n
    n = 2 * kmax + 1
    for k in range(1, kmax + 1):
        S.reset_launches()
        out = S._plain_sweeps(q, st, dt, cfg, n, k)
        assert {k: v for k, v in S.LAUNCHES.items() if v} == \
            _plain_launches(case, cfg, n, k)
        assert torch.equal(out, refs[n]), k
    assert torch.equal(q, q0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["periodic", "dn_x", "asperity_eyring"])
def test_plain_sweep_depth_outside_range_raises(cuda, case):
    """A plain sweep of 0 or KMAX + 1 steps: the C entry refuses it and
    the error raises; nothing is counted, nothing falls back."""
    p = _comp_problem(case)
    cfg = p._solver_cfg
    inputs, _, _ = _plain_route(case)
    q, st, dt = inputs(p)
    entry = "gf_plain_sweeps" if case == "periodic" else "gf_plain_sweeps_bc"
    S.reset_launches()
    for k in (0, S._k_steps(cfg) + 1):
        with pytest.raises(RuntimeError, match=entry):
            S._plain_sweeps(q, st, dt, cfg, 4, k)
    assert not any(S.LAUNCHES.values())


@pytest.mark.gpu
@pytest.mark.parametrize("grid, n, want", [
    ("", 9, {"plain_run": 1}),
    ("dn_x", 9, {"plain_steps_bc": 5}),
    ("dn_x_barus_eyring", 9, {"plain_steps_bc": 9})])
def test_plain_loop_takes_the_plain_kernels(cuda, grid, n, want):
    """run_steps_fast(compensated=False) reaches the plain kernels (40 x
    72 fits the L2 cache: one Kv launch; on D/N edges one C call of
    sweeps, 2 steps deep and a remainder sweep, 1 deep with thinning, no
    one-step kernel) and agrees with K1 or K3 once per step."""
    p = _problem(*(BC_CASES[grid] if grid else ("",)))
    S.reset_launches()
    p.run_steps_fast(n, compensated=False)
    assert {k: v for k, v in S.LAUNCHES.items() if v} == want
    cfg = p._solver_cfg
    ref = _problem(*(BC_CASES[grid] if grid else ("",)))
    step = S.fused_step if not grid else S.fused_step_bc
    statics = S.interior_statics if not grid else S.ghost_statics
    st = statics(ref.topo.full, ref.fc.get_real_field("extra").p,
                 torch.float32, "cuda")
    q = torch.as_tensor(ref.q[:, 1:-1, 1:-1], dtype=torch.float32,
                        device="cuda").contiguous()
    for _ in range(n):
        q = step(q, st, ref.dt, cfg)
    assert torch.equal(torch.as_tensor(p.q[:, 1:-1, 1:-1],
                                       dtype=torch.float32), q.cpu())


# -- GP-closed kernels --------------------------------------------------------

GP_GRIDS = {"periodic": "", "dn_x": BC_CASES["dn_x"][0],
            "dn_all_asymmetric": BC_CASES["dn_all_asymmetric"][0],
            "dn_y": DN_Y}


def _gp_problem(tmp_path, grid="", gp="all", n=128, **kw):
    p = Problem.from_string(
        gp_yaml(n, n, gp=GP_CASES[gp], grid=grid, out=str(tmp_path / "o"),
                dtool_path=str(tmp_path / "train"), **kw),
        device="cuda", dtype=torch.float32)
    p._pre_run()
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("edges", list(GP_GRIDS))
@pytest.mark.parametrize("gp,cap", [("pressure", 16), ("all", 16),
                                    ("all", 48), ("pressure", 128),
                                    ("all", 128), ("all", 200)])
def test_gp_kernels_match_twins(cuda, tmp_path, edges, gp, cap):
    """K5 (periodic: state and pass-2 pressure) or K6 (D/N edges, on
    both axes or one: state, and state with its ghost-inclusive pass-2
    pressure) against its twin at 128 x 128, bit for bit, synthetic
    surrogates of 16 to 200 points (48: a partial tile of staged training
    points; 200: a full tile and a partial one)."""
    p = _gp_problem(tmp_path, GP_GRIDS[edges], gp)
    cfg = p._solver_cfg
    periodic = edges == "periodic"
    q, st, dt, ops, _ = gp_kernel_inputs(p, cap, ghosted=not periodic,
                                         db_scales=True)
    G.reset_launches()
    if periodic:
        (qk, pk), (qr, pr) = (G.gp_step(q, st, dt, cfg, ops),
                              G.gp_step_ref(q, st, dt, cfg, ops))
        # the variant without the pressure output (the AL advance's)
        qn, pn = G.gp_step(q, st, dt, cfg, ops, need_p=False)
        assert pn is None and torch.equal(qn, qk)
        assert G.LAUNCHES["gp_step"] == 2
    else:
        qk = G.gp_step_bc(q, st, dt, cfg, ops)
        qr = G.gp_step_bc_ref(q, st, dt, cfg, ops)
        # with the ghost-inclusive pass-2 pressure (the per-step GP
        # loop's fused step)
        qp, pk = G.gp_step_bc(q, st, dt, cfg, ops, need_p=True)
        _, pr = G.gp_step_bc_ref(q, st, dt, cfg, ops, need_p=True)
        assert torch.equal(qp, qk) and pk.shape == pr.shape
        assert G.LAUNCHES["gp_step_bc"] == 2
    assert torch.equal(qk, qr)
    assert torch.equal(pk, pr)


@pytest.mark.gpu
@pytest.mark.parametrize("nx", [100, 300])
def test_gp_step_bc_on_a_1d_grid_matches_twin(cuda, tmp_path, nx):
    """K6 on a 1D grid (ny 1, periodic y: every tile's ring wraps onto
    one column) with its ghost-inclusive pass-2 pressure, bit for bit,
    as the per-step GP loop's fused step runs it on
    parabolic_1d_lj_gp.yaml."""
    p = Problem.from_string(
        gp_yaml(nx, 1, gp=GP_CASES["all"], grid=GP_GRIDS["dn_x"],
                out=str(tmp_path / "o"), dtool_path=str(tmp_path / "t")),
        device="cuda", dtype=torch.float32)
    p._pre_run()
    cfg = p._solver_cfg
    q, st, dt, ops, _ = gp_kernel_inputs(p, 48, ghosted=True,
                                         db_scales=True)
    qk, pk = G.gp_step_bc(q, st, dt, cfg, ops, need_p=True)
    qr, pr = G.gp_step_bc_ref(q, st, dt, cfg, ops, need_p=True)
    assert torch.equal(qk, qr) and torch.equal(pk, pr)
    assert torch.equal(G.gp_step_bc(q, st, dt, cfg, ops), qr)


@pytest.mark.gpu
@pytest.mark.parametrize("d,n_out", [(d, n) for d in range(1, 8)
                                     for n in (1, 2)])
def test_gp_fields_match_twin(cuda, tmp_path, d, n_out):
    """The means kernel alone (``gp_fields``) for each body it compiles,
    feature count d and output count n_out, against its twin bit for bit:
    a perturbed 37 x 53 journal state (no multiple of the 512 cells of a
    block), 200 training points (a full tile and a partial one)."""
    p = _gp_problem(tmp_path, n=64)
    q, st, _, _, _ = gp_kernel_inputs(p, 16)
    q = q[:, 3:40, 2:55].contiguous()
    st = st[:, 3:40, 2:55].contiguous()
    ops = synthetic_gp_ops([("z", d, n_out)], 200, 10 * d + n_out, "cuda")
    G.reset_launches()
    got = G.gp_fields(q, st, ops)
    assert G.LAUNCHES["gp_fields"] == 1
    ref = G.gp_fields_ref(q, st, ops)
    assert got["z"].shape == (n_out, 37, 53)
    assert torch.isfinite(got["z"]).all()
    assert torch.equal(got["z"], ref["z"])


@pytest.mark.gpu
def test_gp_fields_of_three_surrogates_match_twin(cuda, tmp_path):
    """All three surrogates in one launch (one block row each), their
    planes in the order z, x, y, at a capacity of one partial tile."""
    p = _gp_problem(tmp_path)
    q, st, _, _, _ = gp_kernel_inputs(p, 16)
    ops = synthetic_gp_ops([("z", 2, 1), ("x", 3, 2), ("y", 7, 2)], 48, 5,
                           "cuda")
    got, ref = G.gp_fields(q, st, ops), G.gp_fields_ref(q, st, ops)
    assert list(got) == ["z", "x", "y"]
    assert all(torch.equal(got[k], ref[k]) for k in got)


@pytest.mark.gpu
def test_written_out_sqrt_equals_sqrtf(cuda):
    """The kernels' sqrt (sqrtf's fast path without its range check)
    against sqrtf on the card, bit for bit, at every binade of [3e-14,
    2^125] with 4096 random mantissas each and at both ends.  Above
    2^125 the GP clamp's argument can reach FLT_MAX: there both are
    finite and above 104, so exp(-arg) is 0 and the Matern value
    e + arg e is 0 in both; at +inf both Matern values are NaN."""
    inside, above = sqrt_sweep()
    fast, ref = G.sqrt_pair(torch.as_tensor(inside, device="cuda"))
    assert torch.equal(fast, ref)
    fast, ref = G.sqrt_pair(torch.as_tensor(above, device="cuda"))
    for arg in (fast, ref):
        assert torch.isfinite(arg).all() and (arg > 104).all()
        e = torch.exp(-arg)
        assert (e + arg * e == 0).all()
    fast, ref = G.sqrt_pair(torch.tensor([float("inf")], device="cuda"))
    for arg in (fast, ref):
        e = torch.exp(-arg)
        assert torch.isnan(e + arg * e).all()


@pytest.mark.gpu
def test_gp_step_bc_without_surrogates_matches_twin_and_plain_step(
        cuda, tmp_path):
    """K6 with no surrogate and its ghost-inclusive pass-2 pressure (the
    EHL pass-2 route's step on D/N edges) against its twin and against
    the plain step with analytic closures."""
    from gapflow_torch.core.gp_step import make_gp_step_core
    p = _gp_problem(tmp_path, GP_GRIDS["dn_x"], "all")
    cfg = p._solver_cfg
    q, st, dt, _, state = gp_kernel_inputs(p, 16, ghosted=True)
    none = (None, None, None), (False, False, False)
    gp_state = {"Xscale": state["Xscale"]}
    ops = G.prep_gp_ops(gp_state, *none)
    G.reset_launches()
    qk, pk = G.gp_step_bc(q, st, dt, cfg, ops, need_p=True)
    assert G.LAUNCHES["gp_step_bc"] == 1
    qr, pr = G.gp_step_bc_ref(q, st, dt, cfg, ops, need_p=True)
    assert kernel_vs_plain_err(qk, qr) < 1e-5
    assert float((pk - pr).abs().max() / pr.abs().max()) < 2e-5
    plain = make_gp_step_core(cfg, *none[:1], p.database.num_features,
                              none[1], allow_pallas=False)
    qp, pp = plain(S.with_ghosts(q, cfg), p._tensor(p.topo.full).float(),
                   p._tensor(p.fc.get_real_field("extra").p).float(), dt, 0,
                   gp_state)
    assert kernel_vs_plain_err(qk, qp[:, 1:-1, 1:-1]) < 1e-4
    assert float((pk - pp).abs().max() / pp.abs().max()) < 2e-5


@pytest.mark.gpu
def test_gp_steps_match_twin(cuda, tmp_path):
    p = _gp_problem(tmp_path)
    cfg = p._solver_cfg
    q, st, dt, ops, _ = gp_kernel_inputs(p, 16, db_scales=True)
    q0 = q.clone()
    G.reset_launches()
    qk = G.gp_steps(q, st, dt, cfg, ops, 6)
    assert G.LAUNCHES["gp_steps"] == 6
    assert torch.equal(qk, G.gp_steps_ref(q, st, dt, cfg, ops, 6))
    assert torch.equal(q, q0)                       # input untouched


@pytest.mark.gpu
@pytest.mark.parametrize("al,route,kernel", [
    ("True", "gp_chunked", "gp_step"), ("False", "gp_fast", "gp_steps")])
def test_gp_run_takes_the_kernels(cuda, tmp_path, al, route, kernel):
    """A silent GP run at 128 x 128 through Problem.run(): chunked active
    learning steps through K5, frozen surrogates through K7."""
    text = gp_yaml(128, 128, max_it=8, out=str(tmp_path / "o"),
                   dtool_path=str(tmp_path / "train"),
                   gp=GP_CASES["all"].replace("max_steps: 2",
                                              f"max_steps: 2, "
                                              f"active_learning: {al}"))
    p = Problem.from_string(text, device="cuda", dtype=torch.float32)
    G.reset_launches()
    S.reset_launches()
    p.run()
    assert p._route == route and p.step == 8
    assert G.LAUNCHES[kernel] == 8
    assert sum(G.LAUNCHES.values()) == 8 and sum(S.LAUNCHES.values()) == 0
    assert np.isfinite(p.q).all() and (p.q[0] > 0).all()


# -- the EHL kernel K8 ---------------------------------------------------------

def _ehl_problem(nx=40, ny=72, max_it=1000000):
    from gapflow_torch.validate import ehl_yaml
    return Problem.from_string(ehl_yaml(nx, ny, max_it=max_it,
                                        out="data/torch_gpu"),
                               device="cuda", dtype=torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("emit_delta", [False, True])
def test_ehl_step_matches_twin(cuda, emit_delta):
    """Ragged tiles, a journal deformed by u ~ 1e-9 N(0, 1) drawn on the
    ghost-inclusive grid (its ghost ring is no wrap of the interior)."""
    from gapflow_torch.validate import ehl_inputs
    p = _ehl_problem()
    cfg = p._solver_cfg
    q, hu, u, ls, dt = ehl_inputs(p)
    for shift in (False, True):
        S.reset_launches()
        out = S.ehl_step(q, hu, u, ls, dt, cfg, emit_delta=emit_delta,
                         shift_ref=shift)
        assert S.LAUNCHES["ehl_step"] == 1
        ref = S.ehl_step_ref(q, hu, u, ls, dt, cfg, emit_delta=emit_delta,
                             shift_ref=shift)
        assert kernel_vs_plain_err(out, ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(40, 72), (33, 5), (64, 1)])
@pytest.mark.parametrize("shift", [False, True])
def test_ehl_step_equals_k1_on_its_statics(cuda, grid, shift):
    """K8 forms the statics of ehl_statics_ref from (h_und, u) itself: its
    step, increment and compensated step equal K1 and the K1-body
    compensated step on those statics bit for bit (the wrap of a 1-wide
    axis included)."""
    from gapflow_torch.validate import ehl_inputs, journal_problem
    p = journal_problem(*grid, device="cuda")
    cfg = p._solver_cfg
    q, hu, u, ls, dt = ehl_inputs(p)
    st = S._ehl_statics_of(hu, u, ls, cfg, shift).contiguous()
    k1 = S.fused_step(q, st, dt, cfg)
    assert torch.equal(S.ehl_step(q, hu, u, ls, dt, cfg, shift_ref=shift), k1)
    lo = (torch.rand_like(q) - 0.5) * 1e-6 * q.abs()
    qk, lk = S.ehl_comp_step(q, lo, hu, u, ls, dt, cfg, shift)
    qc, lc = S.comp_step_once(q, lo, st, dt, cfg)
    assert torch.equal(qk, qc) and torch.equal(lk, lc)
    delta = S.ehl_step(q, hu, u, ls, dt, cfg, emit_delta=True,
                       shift_ref=shift)
    y = delta + lo
    assert torch.equal(qk, q + y)


@pytest.mark.gpu
def test_ehl_comp_step_matches_twin_and_identity(cuda):
    """The compensated step against its twin, and against the emit_delta
    kernel plus an explicit two-sum (bit for bit with --fmad=false)."""
    from gapflow_torch.validate import ehl_inputs, ehl_kernel_bitexact
    p = _ehl_problem()
    cfg = p._solver_cfg
    q, hu, u, ls, dt = ehl_inputs(p)
    lo = torch.zeros_like(q)
    qk, lk = S.ehl_comp_step(q, lo, hu, u, ls, dt, cfg)
    qr, lr = S.ehl_comp_step_ref(q, lo, hu, u, ls, dt, cfg)
    assert kernel_vs_plain_err(qk, qr) < 1e-5
    assert float((lk - lr).abs().max()) <= 1e-6 * float(qr.abs().max())
    assert torch.equal(lo, torch.zeros_like(q))     # inputs untouched
    for shift in (False, True):
        r = ehl_kernel_bitexact(n_steps=4, nx=40, ny=72, shift_ref=shift)
        assert r["ok"], r


@pytest.mark.gpu
def test_ehl_wrapper_rejects_thinning_and_float64(cuda):
    from gapflow_torch.validate import ehl_inputs
    p = _ehl_problem()
    q, hu, u, ls, dt = ehl_inputs(p)
    with pytest.raises(TypeError):
        S.ehl_step(q.double(), hu.double(), u.double(), ls.double(), dt,
                   p._solver_cfg)
    thin = _problem("", BC_CASES["periodic_eyring"][1])._solver_cfg
    with pytest.raises(ValueError):
        S.ehl_step(q, hu, u, ls, dt, thin)
    with pytest.raises(ValueError):         # an interior gap
        S.ehl_step(q, hu[1:-1, 1:-1].contiguous(), u, ls, dt, p._solver_cfg)


@pytest.mark.gpu
def test_run_steps_ehl_launches_k8_per_step(cuda):
    p = _ehl_problem()
    p._pre_run()
    S.reset_launches()
    G.reset_launches()
    p.run_steps_ehl(6)
    assert S.LAUNCHES["ehl_comp_step"] == 6
    assert sum(S.LAUNCHES.values()) == 6 and sum(G.LAUNCHES.values()) == 0
    assert np.isfinite(p.q).all() and p.step == 6
    assert np.abs(p.topo.deformation).max() > 0.


@pytest.mark.gpu
def test_run_takes_the_pass2_route_through_k5(cuda):
    """Problem.run() on a silent elastic problem: the pass-2 route, one
    GP-kernel step without surrogates per step."""
    p = _ehl_problem(max_it=5)
    S.reset_launches()
    G.reset_launches()
    p.run()
    assert p._route == "ehl_pass2" and p.step == 5
    assert G.LAUNCHES == {**G.LAUNCHES, "gp_step": 5}
    assert sum(G.LAUNCHES.values()) == 5 and sum(S.LAUNCHES.values()) == 0
    assert np.isfinite(p.q).all()


# -- K10: blocked Cholesky and triangular solve -------------------------------

def _spd(n, seed=0, dtype=torch.float32):
    A = np.random.default_rng(seed).standard_normal((n, n))
    A = A @ A.T / n + np.eye(n)
    return torch.tensor(A, dtype=dtype, device="cuda")


@pytest.fixture
def linalg(cuda, monkeypatch):
    from gapflow_torch.ops import cholesky as C
    monkeypatch.setenv("GAPFLOW_PALLAS_LINALG", "1")
    C.reset_launches()
    return C


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 384, 1024, 2048])
def test_cholesky_kernel_matches_twin_and_library(linalg, n):
    """Bit for bit against the twin (the same operations in the same
    order); against the library rtol 2e-4, atol 5e-5, the reference's
    tolerance for its kernel against XLA (tests/test_cholesky.py).  At
    2048 the trailing updates take both their product tiles (64 x 64 while
    these launch a block per SM, then 32 x 32)."""
    A = _spd(n)
    L = linalg.cholesky(A)
    assert linalg.LAUNCHES["cholesky"] == 1
    assert torch.equal(L, linalg._chol_ref(A))
    torch.testing.assert_close(L, torch.linalg.cholesky(A), rtol=2e-4,
                               atol=5e-5)
    assert torch.equal(L, torch.tril(L))


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(256, 128), (384, 256), (2048, 128),
                                 (2048, 2048)])
def test_tril_solve_kernel_matches_twin_and_library(linalg, n, m):
    """As the factorization; at n = 2048, m = 128 and m = 2048 between
    them take every product tile of the solve (16 x 32 to 64 x 64)."""
    L = torch.linalg.cholesky(_spd(n))
    B = torch.tensor(np.random.default_rng(1).standard_normal((n, m)),
                     dtype=torch.float32, device="cuda")
    X = linalg.tril_solve(L, B)
    assert linalg.LAUNCHES["tril_solve"] == 1
    assert torch.equal(X, linalg._trsm_ref(L, B))
    torch.testing.assert_close(
        X, torch.linalg.solve_triangular(L, B, upper=False), rtol=2e-4,
        atol=5e-5)


@pytest.mark.gpu
def test_cholesky_kernel_on_a_side_stream(linalg):
    """Called on a non-default stream, the factorization's two streams
    (that one and its own high-priority stream) still meet before the
    result is read: bit for bit against the twin."""
    A = _spd(1024, seed=3)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        L = linalg.cholesky_kernel(A)
        same = torch.equal(L, linalg._chol_ref(A))
    torch.cuda.current_stream().wait_stream(s)
    assert same and linalg.LAUNCHES["cholesky"] == 1


@pytest.mark.gpu
def test_cholesky_gradient_launches_the_solve_kernel(linalg):
    """The backward pass's two upper solves run the solve kernel on
    reversed operands; the symmetrised gradient against autograd through
    torch.linalg.cholesky within 1e-3 of its largest entry (float32)."""
    A = _spd(256, seed=2)

    def grad(chol):
        X = A.clone().requires_grad_(True)
        torch.sum(torch.sin(chol(X))).backward()
        return X.grad + X.grad.T

    g = grad(linalg.cholesky)
    assert linalg.LAUNCHES == {"cholesky": 1, "tril_solve": 2}
    ref = grad(torch.linalg.cholesky)
    assert float((g - ref).abs().max()) < 1e-3 * float(ref.abs().max())


@pytest.mark.gpu
def test_linalg_gate_routes_to_the_library(linalg, monkeypatch):
    A = _spd(256)
    linalg.cholesky(A.double())
    linalg.cholesky(A[:200, :200])
    monkeypatch.setenv("GAPFLOW_PALLAS_LINALG", "0")
    linalg.cholesky(A)
    assert linalg.LAUNCHES["cholesky"] == 0
    with pytest.raises(ValueError):
        linalg.cholesky_kernel(A[:200, :200])


@pytest.mark.gpu
def test_per_step_gp_loop_fuses_through_the_kernels(cuda, tmp_path):
    """A non-silent GP run with frozen surrogates on D/N edges (the
    per-step loop): every step not followed by an output is one K6
    launch with its pressure."""
    text = gp_yaml(64, 64, max_it=6, grid=BC_CASES["dn_x"][0],
                   out=str(tmp_path / "o"), dtool_path=str(tmp_path / "tr"),
                   gp=GP_CASES["all"].replace("max_steps: 2",
                                              "max_steps: 2, "
                                              "active_learning: False"))
    text = text.replace("write_freq: 1000000, silent: True",
                        "write_freq: 3, silent: False")
    p = Problem.from_string(text, device="cuda", dtype=torch.float32)
    G.reset_launches()
    p.run()
    assert p._route == "host_loop" and p.step == 6
    assert p._fused_steps == 4 and G.LAUNCHES["gp_step_bc"] == 4
    assert np.isfinite(p.q).all()
    assert np.isfinite(p.pressure.pressure).all()


# -- the shard kernel K9 ------------------------------------------------------

def _shard_inputs(case, nx=40, ny=72):
    """A perturbed state of ``case`` at nx x ny (ragged tiles) as one shard
    block with its 2-deep halo (serial ghosts on the D/N edges), and its
    statics."""
    from gapflow_torch.models.closures_opt import precompute_statics
    from gapflow_torch.parallel.pallas_halo import pad_blocks2_bc
    p = _problem(*(BC_CASES[case] if case else ("",)), nx=nx, ny=ny)
    cfg = p._solver_cfg
    per = (all(cfg.bc_edge(0)["P"]), all(cfg.bc_edge(2)["P"]))
    st = perturbed_state(p, seed=0, amp=0.01)

    def blk(a):
        return torch.as_tensor(pad_blocks2_bc(a.cpu().numpy(), 1, 1, *per),
                               dtype=torch.float32, device="cuda")

    t2 = blk(st.topo)
    return (p, blk(st.q), precompute_statics(t2[:3], blk(st.extra))
            .contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("flags", list(itertools.product((0, 1), repeat=4)))
def test_shard_step_matches_twin(cuda, flags):
    """K9 on every flag pattern equals its twin bit for bit (40 x 72 is
    no multiple of the 8 x 32 tile)."""
    p, q, st = _shard_inputs("dn_all_asymmetric")
    cfg = p._solver_cfg
    S.reset_launches()
    out = S.shard_step(q, st, p.dt, cfg, flags)
    assert S.LAUNCHES["shard_step"] == 1
    assert torch.equal(out, S.shard_step_ref(q, st, p.dt, cfg, flags))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["", "dn_x", "dn_all_asymmetric"])
def test_shard_step_matches_k1_and_k3(cuda, case):
    """K9 on a whole-domain block: with zero flags on periodic edges it is
    K1's step, with every D/N edge flagged K3's, bit for bit."""
    p, q, st = _shard_inputs(case)
    cfg = p._solver_cfg
    q_int = q[:, 2:-2, 2:-2].contiguous()
    if case:
        from gapflow_torch.parallel.pallas_halo import shard_flags
        from gapflow_torch.parallel import grid_mesh
        flags = shard_flags(cfg, grid_mesh(["cuda"]), 0, 0)
        st_g = st[:, 1:-1, 1:-1].contiguous()
        ref = S.fused_step_bc(q_int, st_g, p.dt, cfg)
    else:
        flags = (0, 0, 0, 0)
        ref = S.fused_step(q_int, st[:, 2:-2, 2:-2].contiguous(), p.dt, cfg)
    assert torch.equal(S.shard_step(q, st, p.dt, cfg, flags), ref)


def _held_edge_halo(cfg, q_blk, flags, d):
    """``q_blk`` with its halo on the domain edges ``flags`` holds
    rebuilt as ``halo_blocks`` fills it: the edge formulas of the block's
    own lines, x edges first, then y."""
    xe, xw, yn, ys = flags
    core = q_blk[:, d * xe:q_blk.shape[1] - d * xw,
                 d * ys:q_blk.shape[2] - d * yn]
    return S._edge_pad(cfg, core, flags, d).contiguous()


def _sweep_inputs(case, k, nx=40, ny=72):
    """A perturbed state of ``case`` at nx x ny as one shard block with a
    2k-deep halo, and its statics with a (2k + 1)-deep one."""
    from gapflow_torch.models.closures_opt import precompute_statics
    from gapflow_torch.parallel.pallas_halo import pad_blocks2_bc
    p = _problem(*(BC_CASES[case] if case else ("",)), nx=nx, ny=ny)
    cfg = p._solver_cfg
    per = (all(cfg.bc_edge(0)["P"]), all(cfg.bc_edge(2)["P"]))
    st = perturbed_state(p, seed=0, amp=0.01)

    def blk(a, d):
        return torch.as_tensor(pad_blocks2_bc(a.cpu().numpy(), 1, 1, *per,
                                              d),
                               dtype=torch.float32, device="cuda")

    d = 2 * k
    t, e = blk(st.topo, d + 1), blk(st.extra, d + 1)
    return p, blk(st.q, d), precompute_statics(t[:3], e).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_shard_sweep_matches_twin_and_one_step_kernel(cuda, k):
    """The k-step shard sweep on every flag pattern (40 x 72: ragged
    tiles) equals k launches of the one-step K9 on the shrinking halo and
    its twin, bit for bit, with one launch."""
    p, q_all, st = _sweep_inputs("dn_all_asymmetric", k)
    cfg = p._solver_cfg
    for flags in itertools.product((0, 1), repeat=4):
        q = _held_edge_halo(cfg, q_all, flags, 2 * k)
        S.reset_launches()
        out = S.shard_sweep(q, st, p.dt, cfg, flags, k)
        assert S.LAUNCHES["shard_sweep"] == 1
        assert torch.equal(out, S.shard_steps_once(q, st, p.dt, cfg, flags,
                                                   k)), flags
        assert S.LAUNCHES["shard_step"] == k
        assert torch.equal(out, S.shard_sweep_ref(q, st, p.dt, cfg, flags,
                                                  k)), flags


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(64, 1), (1, 40), (37, 3)])
def test_shard_sweep_on_thin_blocks(cuda, grid):
    """1D and thin blocks (x D/N edges, y periodic): the sweep at every
    depth equals k one-step K9 launches and the serial boundary sweeps
    (K3p) on the whole domain, bit for bit."""
    for k in (1, 2, 3, 4):
        p, q_all, st = _sweep_inputs("dn_x", k, *grid)
        cfg = p._solver_cfg
        for flags in itertools.product((0, 1), (0, 1), (0,), (0,)):
            q = _held_edge_halo(cfg, q_all, flags, 2 * k)
            out = S.shard_sweep(q, st, p.dt, cfg, flags, k)
            assert torch.equal(out, S.shard_steps_once(q, st, p.dt, cfg,
                                                       flags, k)), flags
        d = 2 * k + 1
        serial = S.plain_steps_bc(q_all[:, 2 * k:-2 * k, 2 * k:-2 * k]
                                  .contiguous(),
                                  st[:, d - 1:1 - d, d - 1:1 - d].contiguous(),
                                  p.dt, cfg, k)
        assert torch.equal(out, serial)


@pytest.mark.gpu
def test_shard_sweep_refuses_what_it_does_not_take(cuda):
    p, q, st = _sweep_inputs("dn_all_asymmetric", 2)
    cfg = p._solver_cfg
    with pytest.raises(ValueError, match="steps per launch"):
        S.shard_sweep(q, st, p.dt, cfg, (1, 1, 1, 1), 5)
    with pytest.raises(ValueError, match="statics block"):
        S.shard_sweep(q, st[:, 2:-2, 2:-2].contiguous(), p.dt, cfg,
                      (1, 1, 1, 1), 2)
    with pytest.raises(TypeError):
        S.shard_sweep(q.double(), st.double(), p.dt, cfg, (1, 1, 1, 1), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["", "dn_all_asymmetric"])
def test_sharded_run_takes_k9(cuda, case):
    """run_steps_sharded on a 2 x 2 mesh of cuda:0 shards launches the
    shard sweep once per shard and exchange (7 steps: sweeps of SHARD_K
    and one of the remainder) and equals the serial plain kernel route bit
    for bit; a float64 CUDA state on the kernel route raises."""
    from gapflow_torch.parallel import grid_mesh
    from gapflow_torch.parallel.pallas_halo import SHARD_K
    grid = BC_CASES[case] if case else ("",)
    p, s = _problem(*grid), _problem(*grid)
    S.reset_launches()
    p.run_steps_sharded(7, grid_mesh(["cuda:0"] * 4, (2, 2)))
    assert {k: v for k, v in S.LAUNCHES.items() if v} == {
        "shard_sweep": 4 * -(-7 // SHARD_K)}
    s.run_steps_fast(7, compensated=False)
    np.testing.assert_array_equal(p.q, s.q)
    p64 = Problem.from_string(
        journal_yaml(40, 72, *grid, out="data/torch_gpu"), device="cuda",
        dtype=torch.float64)
    with pytest.raises(TypeError):
        p64.run_steps_sharded(1, grid_mesh(["cuda:0"] * 4, (2, 2)),
                              use_pallas=True)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3, 4])
def test_blocked_sharded_loops_match_serial(cuda, k):
    """The sharded loops at every timed depth, 2 x 2 and 1 x 4 meshes of
    cuda:0 shards, 7 steps (a remainder), periodic and four-edge D/N: bit
    for bit against the serial plain kernel route."""
    from gapflow_torch.parallel import grid_mesh
    from gapflow_torch.parallel.halo import gather, shard_problem_arrays
    from gapflow_torch.parallel.pallas_halo import (
        make_sharded_bc_pallas_loop, make_sharded_pallas_loop, pad_blocks2,
        pad_blocks2_bc, statics_depth)
    from gapflow_torch.parallel.halo import split_blocks
    for case in ("", "dn_all_asymmetric"):
        grid = BC_CASES[case] if case else ("",)
        for shape in ((2, 2), (1, 4)):
            p, s = _problem(*grid), _problem(*grid)
            cfg = p._solver_cfg
            mesh = grid_mesh(["cuda:0"] * 4, shape)
            d = statics_depth(k)
            if case:
                make = make_sharded_bc_pallas_loop

                def lay(a):
                    return pad_blocks2_bc(a, *shape, False, False, d)
            else:
                make = make_sharded_pallas_loop

                def lay(a):
                    return pad_blocks2(a, *shape, d)
            loop = make(cfg, mesh, 40, 72, k=k)
            q, _, _ = shard_problem_arrays(p, mesh, torch.float32)
            S.reset_launches()
            out = gather(loop(q, split_blocks(lay(p.topo.full), mesh,
                                              torch.float32),
                              split_blocks(lay(p.fc.get_real_field("extra").p),
                                           mesh, torch.float32), p.dt, 7))
            assert S.LAUNCHES["shard_sweep"] == 4 * -(-7 // k)
            s.run_steps_fast(7, compensated=False)
            np.testing.assert_array_equal(out.cpu().numpy(),
                                          s.q[:, 1:-1, 1:-1])
