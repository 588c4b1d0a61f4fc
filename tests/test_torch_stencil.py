"""The port's solver step and kernel twins agree with the JAX package.

Same perturbed journal state (numpy, seed 0) into both packages:

- ``core.step.make_det_step``: 1 and 10 steps at float64 (scaled error
  1e-12 / 1e-10);
- the plain twins of the CUDA kernels (``fused_step_ref``,
  ``comp_steps_ref``) against the JAX Pallas kernels run in interpret
  mode, as tests/test_pallas.py runs them: < 1e-5 at float32, < 1e-10 at
  float64.  The two interpret-mode runs are the expensive part of this
  file; everything else is cheap.

The CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from gapflow_tpu import Problem as JProblem
import jax.numpy as jnp
from gapflow_tpu.core.step import apply_bcs as japply_bcs
from gapflow_tpu.core.step import make_det_step as jmake_det_step

from gapflow_torch import Problem as TProblem
from gapflow_torch.core.state import SimState
from gapflow_torch.core.step import make_det_step
from gapflow_torch.ops import stencil as S
from gapflow_torch.validate import kernel_vs_plain_err, perturbed_q

SIM = """
options: {output: data/torch_stencil, write_freq: 1000, silent: True}
grid: {dx: 2.e-5, dy: 2.e-5, Nx: 32, Ny: 128}
geometry: {type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.}
numerics: {CFL: 0.5, adaptive: 0, tol: 1e-8, dt: 5e-11, max_it: 10}
properties: {shear: 0.0794, bulk: 0., EOS: DH, P0: 101325.,
             rho0: 877.7007, C1: 3.5e10, C2: 1.23}
"""
NX, NY = 32, 128


def scaled_err(a, b):
    return kernel_vs_plain_err(torch.as_tensor(np.array(a)),
                               torch.as_tensor(np.array(b)))


@pytest.fixture(scope="module")
def states():
    """(JAX SimState, port SimState) from the same perturbed f64 state."""
    jp = JProblem.from_string(SIM)
    jp._pre_run()
    q = perturbed_q(jp.q, seed=0, amp=0.01)
    js = jp._make_state()
    js = js._replace(q=japply_bcs(jnp.asarray(q), jp._solver_cfg))
    ts = SimState.from_numpy({k: np.asarray(v)
                              for k, v in js._asdict().items()},
                             "cpu", torch.float64)
    return jp, js, ts


def _port_cfg():
    return TProblem.from_string(SIM, device="cpu",
                                dtype=torch.float64)._solver_cfg


def test_state_round_trip(states):
    _, js, ts = states
    back = ts.to_numpy()
    for k, v in js._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))


@pytest.mark.parametrize("n, tol", [(1, 1e-12), (10, 1e-10)])
def test_det_step_matches_jax(states, n, tol):
    jp, js, ts = states
    jstep = jmake_det_step(jp._solver_cfg, with_aux=False)
    tstep = make_det_step(_port_cfg(), with_aux=False)
    for _ in range(n):
        js = jstep(js)
        ts = tstep(ts)
    assert int(ts.step) == int(js.step) == n
    assert scaled_err(ts.q, js.q) < tol
    np.testing.assert_allclose(float(ts.residual), float(js.residual),
                               rtol=1e-8)


def _interior(state, dtype):
    q = state.q.to(dtype)[:, 1:-1, 1:-1].contiguous()
    st = S.interior_statics(state.topo, state.extra, dtype, q.device)
    return q, st, float(state.dt)


def test_fused_step_ref_matches_det_step(states):
    _, _, ts = states
    cfg = _port_cfg()
    q, st, dt = _interior(ts, torch.float64)
    ref = make_det_step(cfg, with_aux=False)(ts).q[:, 1:-1, 1:-1]
    out = S.fused_step_ref(q, st, dt, cfg)
    assert scaled_err(out, ref) < 1e-10
    delta = S.fused_step_ref(q, st, dt, cfg, emit_delta=True)
    assert scaled_err(q + delta, out) < 1e-12


@pytest.mark.parametrize("kind", ["step_f32", "comp_loop_f64"])
def test_twins_match_pallas_interpret(states, kind):
    """K1 twin (1 step, f32) vs make_pallas_step; K2 twin (10 steps, f64)
    vs make_pallas_loop(compensated=True): 2 blocked sweeps + 2 remainder
    steps on the JAX side."""
    from jax.experimental.pallas import tpu as pltpu
    from gapflow_tpu.ops.stencil import (_make_call, make_pallas_loop,
                                         make_pallas_step)
    jp, js, ts = states
    cfg = _port_cfg()
    args = (js.q, js.topo, js.extra, js.dt)
    with pltpu.force_tpu_interpret_mode():
        make_pallas_step.cache_clear()
        make_pallas_loop.cache_clear()
        _make_call.cache_clear()
        if kind == "step_f32":
            step = make_pallas_step(jp._solver_cfg, NX, NY, bs=16,
                                    dtype=jnp.float32)
            jout = np.asarray(step(*args, 0))
        else:
            loop = make_pallas_loop(jp._solver_cfg, NX, NY, bs=16,
                                    dtype=jnp.float64, compensated=True)
            jout = np.asarray(loop(*args, 10))
        make_pallas_step.cache_clear()
        make_pallas_loop.cache_clear()
        _make_call.cache_clear()

    if kind == "step_f32":
        # the port's ghost-inclusive wrapper around fused_step (CPU twin)
        out = S.make_pallas_step(cfg, NX, NY, torch.float32)(
            ts.q, ts.topo, ts.extra, ts.dt, 0)
        assert scaled_err(out, jout) < 1e-5       # ghost ring included
        out = out[:, 1:-1, 1:-1]
        tol = 1e-5
    else:
        q, st, dt = _interior(ts, torch.float64)
        out, _ = S.comp_steps_ref(q, torch.zeros_like(q), st, dt, cfg, 10)
        tol = 1e-10
    assert scaled_err(out, jout[:, 1:-1, 1:-1]) < tol


def test_compensated_loop_matches_plain_loop(states):
    """The port's loop drivers on the CPU twins: compensated (2 sweeps + 2
    remainder steps) vs plain accumulation agree to f64 rounding, and
    ``with_lo`` exposes the same state."""
    _, _, ts = states
    cfg = _port_cfg()
    args = (ts.q, ts.topo, ts.extra, ts.dt)
    plain = S.make_pallas_loop(cfg, NX, NY, dtype=torch.float64)(*args, 10)
    comp = S.make_pallas_loop(cfg, NX, NY, dtype=torch.float64,
                              compensated=True)(*args, 10)
    comp_lo, lo = S.make_pallas_loop(cfg, NX, NY, dtype=torch.float64,
                                     compensated=True, with_lo=True)(*args, 10)
    assert scaled_err(comp, plain) < 1e-8
    assert torch.equal(comp, comp_lo)
    assert lo.shape == (3, NX, NY)
    # the ghost ring is the periodic wrap of the interior
    assert torch.equal(comp[:, 0, 1:-1], comp[:, -2, 1:-1])
    assert torch.equal(comp[:, 1:-1, -1], comp[:, 1:-1, 1])


def test_wrappers_use_twins_only_on_cpu(states):
    _, _, ts = states
    cfg = _port_cfg()
    q, st, dt = _interior(ts, torch.float32)
    before = dict(S.LAUNCHES)
    S.fused_step(q, st, dt, cfg)
    S.comp_steps(q, torch.zeros_like(q), st, dt, cfg, 2)
    assert S.LAUNCHES == before
    with pytest.raises(ValueError):
        S.fused_step(q.to("meta"), st.to("meta"), dt, cfg)


def test_kernel_gate_and_params():
    import dataclasses
    cfg = _port_cfg()
    assert S.pallas_supported(cfg) and S._periodic_kernel_ok(cfg)
    assert not S.pallas_supported(dataclasses.replace(cfg, MC_order=0))
    # shear thinning is covered by the boundary kernel, not by K1/K2
    thin = dataclasses.replace(cfg, thinning=(("name", "Eyring"),
                                              ("tauE", 5e5)))
    assert S.pallas_supported(thin) and not S._periodic_kernel_ok(thin)
    iprm, fprm = S._kernel_params(cfg)
    assert list(iprm) == [S._EOS_CODES["DH"], 0, 0]
    assert fprm.dtype == np.float32 and fprm.shape == (30,)
    np.testing.assert_allclose(fprm[:6], [5e4, 5e4, 0.1, 0., 0.0794, 0.],
                               rtol=1e-7)
    # DH block: rho0, P0, C1, C2, density clamp 0.99*C2*rho0
    np.testing.assert_allclose(
        fprm[6:11], [877.7007, 101325., 3.5e10, 1.23,
                     0.99 * 1.23 * 877.7007], rtol=1e-7)

