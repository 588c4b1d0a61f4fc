"""The port's boundary step (D/N edges, shear thinning) agrees with JAX.

Same perturbed journal state (numpy, seed 0) into both packages, at
Nx 32, Ny 128 (the JAX kernels need a width that is a multiple of 128):

- (a) the K3 twin (``fused_step_bc_ref``, through the port's
  ``make_pallas_step``) against the JAX ``make_pallas_step`` in Pallas
  interpret mode, float32, scaled error < 1e-5, for the four edge and
  thinning cases of chip_smoke phase 2c;
- (b) the compensated K3 twin (``comp_steps_bc_ref``, 8 steps) against
  the JAX ``make_pallas_loop(compensated=True)`` at float64, < 1e-10,
  with and without thinning (sweep depths 4 and 2: whole sweeps, so the
  JAX loop compiles one kernel);
- (d) one twin step against the JAX ``make_det_step`` at float64,
  < 1e-10, for every EOS on D/N edges;
- (e) a silent CPU ``Problem.run()`` of a D/N + thinning configuration
  against the JAX run, and the port's kernel loop on the CPU twins;
- (f) the gates and parameter blocks.

(a) and (b) are the six interpret-mode runs of this file; the rest is
cheap.  The CUDA kernels themselves run only on a GPU:
tests/test_torch_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gapflow_tpu import Problem as JProblem
from gapflow_tpu.core.step import apply_bcs as japply_bcs
from gapflow_tpu.core.step import make_det_step as jmake_det_step

from gapflow_torch import Problem as TProblem
from gapflow_torch.core.state import SimState
from gapflow_torch.ops import stencil as S
from gapflow_torch.ops.mixed_bc import mixed_supported
from gapflow_torch.validate import (BC_CASES, DH, journal_yaml,
                                   kernel_vs_plain_err, perturbed_q)

NX, NY = 32, 128
DN_X = BC_CASES["dn_x"][0]
# the edge and thinning cases of chip_smoke phase 2c
CASES = BC_CASES

# one EOS per case at a journal state (chip_smoke's model cases), with
# Dirichlet density rho0 on the x edges
EOS = {
    "DH": (877.7007, DH),
    "PL": (1.1853, "EOS: PL, rho0: 1.1853, P0: 101325., alpha: 0."),
    "vdW": (1., "EOS: vdW, rho0: 1."),
    "MT": (700., "EOS: MT, rho0: 700."),
    "cubic": (1., "EOS: cubic, rho0: 1."),
    "BWR": (0.7, "EOS: BWR, rho0: 0.7, T: 2."),
    "Bayada": (850., "EOS: Bayada, rho0: 850., rho_l: 850., rho_v: 0.019, "
                     "c_l: 1600., c_v: 352."),
}


def yaml(grid, props):
    return journal_yaml(NX, NY, grid, props, max_it=6, out="data/torch_bc")


def scaled_err(a, b):
    return kernel_vs_plain_err(torch.as_tensor(np.array(a)),
                               torch.as_tensor(np.array(b)))


def states(text, amp=0.01):
    """(JAX Problem, JAX SimState, port SimState) from one perturbed f64
    state."""
    jp = JProblem.from_string(text)
    jp._pre_run()
    q = perturbed_q(jp.q, seed=0, amp=amp)
    js = jp._make_state()
    js = js._replace(q=japply_bcs(jnp.asarray(q), jp._solver_cfg))
    ts = SimState.from_numpy({k: np.asarray(v)
                              for k, v in js._asdict().items()},
                             "cpu", torch.float64)
    return jp, js, ts


def port_cfg(text):
    return TProblem.from_string(text, device="cpu",
                                dtype=torch.float64)._solver_cfg


def inputs(ts, cfg, dtype):
    q = ts.q.to(dtype)[:, 1:-1, 1:-1].contiguous()
    st = S.ghost_statics(ts.topo, ts.extra, dtype, q.device)
    return q, st, float(ts.dt)


def _jax_interpret(fn):
    from jax.experimental.pallas import tpu as pltpu
    from gapflow_tpu.ops.stencil import (_make_call, make_pallas_loop,
                                         make_pallas_step)
    caches = (make_pallas_step, make_pallas_loop, _make_call)
    with pltpu.force_tpu_interpret_mode():
        for c in caches:
            c.cache_clear()
        out = np.asarray(fn(make_pallas_step, make_pallas_loop))
        for c in caches:
            c.cache_clear()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_bc_twin_matches_pallas_interpret(case):
    """(a) One K3 twin step vs the JAX boundary kernel, f32."""
    text = yaml(*CASES[case])
    jp, js, ts = states(text)
    cfg = port_cfg(text)
    assert S.pallas_supported(cfg) and not S._periodic_kernel_ok(cfg)
    jout = _jax_interpret(lambda step, loop: step(
        jp._solver_cfg, NX, NY, bs=16, dtype=jnp.float32)(
            js.q, js.topo, js.extra, js.dt, 0))
    out = S.make_pallas_step(cfg, NX, NY, torch.float32)(
        ts.q, ts.topo, ts.extra, ts.dt, 0)
    assert scaled_err(out, jout) < 1e-5        # ghost ring included


@pytest.mark.parametrize("case", ["dn_x", "dn_x_barus_eyring"])
def test_comp_bc_twin_matches_pallas_loop(case):
    """(b) 8 compensated K3 twin steps vs the JAX whole-run kernel
    (nch = 6), f64: sweeps of 4 steps without thinning (2 sweeps), of 2
    with it (4 sweeps)."""
    text = yaml(*CASES[case])
    jp, js, ts = states(text, amp=1e-3)      # stable over the 8 steps
    cfg = port_cfg(text)
    assert S._k_steps(cfg) == (2 if cfg.thinning else 4)
    jout = _jax_interpret(lambda step, loop: loop(
        jp._solver_cfg, NX, NY, bs=16, dtype=jnp.float64,
        compensated=True)(js.q, js.topo, js.extra, js.dt, 8))
    q, st, dt = inputs(ts, cfg, torch.float64)
    out, lo = S.comp_steps_bc_ref(q, torch.zeros_like(q), st, dt, cfg, 8)
    assert scaled_err(out, jout[:, 1:-1, 1:-1]) < 1e-10
    assert torch.isfinite(lo).all()


@pytest.mark.parametrize("eos", list(EOS))
def test_bc_twin_matches_det_step(eos):
    """(d) One K3 twin step vs the JAX reference step on D/N x edges, f64;
    the increment form agrees with the state form."""
    rho0, props = EOS[eos]
    text = yaml(DN_X.replace("877.7007", str(rho0)), props)
    jp, js, ts = states(text)
    cfg = port_cfg(text)
    ref = np.asarray(jmake_det_step(jp._solver_cfg, with_aux=False)(js).q)
    q, st, dt = inputs(ts, cfg, torch.float64)
    out = S.fused_step_bc_ref(q, st, dt, cfg)
    assert scaled_err(out, ref[:, 1:-1, 1:-1]) < 1e-10
    delta = S.fused_step_bc_ref(q, st, dt, cfg, emit_delta=True)
    assert scaled_err(q + delta, out) < 1e-12


def test_problem_run_matches_jax():
    """(e) Silent CPU runs of a D/N + thinning journal (6 steps, f64): the
    port's Problem.run() (plain torch step) and its kernel loop on the
    CPU twins (run_compiled_fast, compensated) vs the JAX Problem.run()."""
    text = yaml(*CASES["dn_x_barus_eyring"])
    jp = JProblem.from_string(text)
    jp.run()
    # dtype pinned: the package default follows GAPFLOW_X64 at import
    tp = TProblem.from_string(text, device="cpu", dtype=torch.float64)
    tp.run()
    assert tp._route == "run_compiled" and tp.step == jp.step == 6
    assert scaled_err(tp.q, jp.q) < 1e-10
    fast = TProblem.from_string(text, device="cpu", dtype=torch.float64)
    S.reset_launches()
    fast.run_compiled_fast()
    assert fast.step == 6 and not any(S.LAUNCHES.values())
    assert scaled_err(fast.q, jp.q) < 1e-10


def test_gates_and_params():
    """(f) Thinning and D/N edges are admitted and take K3; MC_order 0 is
    refused; the Dirichlet values reach the kernel pre-swapped."""
    periodic = port_cfg(yaml("", DH))
    assert S._periodic_kernel_ok(periodic)
    for case in CASES:
        cfg = port_cfg(yaml(*CASES[case]))
        assert S.pallas_supported(cfg)
        assert not S._periodic_kernel_ok(cfg)
        assert not mixed_supported(cfg, NY, NX)
        assert not S.pallas_supported(dataclasses.replace(cfg, MC_order=0))
        assert S._kernels(cfg)[1] is S.fused_step_bc
    assert S._kernels(periodic)[1] is S.fused_step

    bprm, bfprm = S._bc_params(port_cfg(yaml(*CASES["dn_all_asymmetric"])))
    D, N = S._CODES["D"], S._CODES["N"]
    assert list(bprm) == [D, N, N] * 4 + [0]
    # xE (low x) takes xW_D, and so on: the reference's opposite-edge value
    np.testing.assert_allclose(bfprm[:4], [1700., 1800., 1720., 1760.])
    bprm, bfprm = S._bc_params(port_cfg(yaml(*CASES["periodic_eyring"])))
    assert list(bprm[:12]) == [S._CODES["P"]] * 12
    assert bprm[12] == 1
    np.testing.assert_allclose(bfprm[4:8], [-0.1, 2e-5, 2e-5, 5e5],
                               rtol=1e-7)
    carreau = port_cfg(yaml(DN_X, DH + ", thinning: {name: Carreau, "
                            "lam: 1.e-8, a: 2., N: 0.5}"))
    bprm, bfprm = S._bc_params(carreau)
    assert bprm[12] == 2
    np.testing.assert_allclose(bfprm[8:11], [1e-8, 2., -0.25], rtol=1e-7)


def test_bc_wrappers_use_twins_only_on_cpu():
    text = yaml(*CASES["dn_x_barus_eyring"])
    _, _, ts = states(text)
    cfg = port_cfg(text)
    q, st, dt = inputs(ts, cfg, torch.float32)
    S.reset_launches()
    S.fused_step_bc(q, st, dt, cfg)
    S.comp_steps_bc(q, torch.zeros_like(q), st, dt, cfg, 2)
    assert not any(S.LAUNCHES.values())
    with pytest.raises(ValueError):
        S.fused_step_bc(q.to("meta"), st.to("meta"), dt, cfg)
