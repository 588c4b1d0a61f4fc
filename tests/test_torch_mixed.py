"""The port's mixed-edge driver (bands + K4 twin) agrees with JAX.

Mixed per-component P/D/N edges: the periodic component of a mixed edge
keeps an evolved ghost, carried as state (``ops.mixed_bc``).  Same
perturbed journal state (numpy, seed 0, amplitude 1e-3, dt 2e-11) into
both packages at Nx 8, Ny 128, for the four edge specs of
tests/test_pallas_mixed.py:

- (c) the port's ``make_mixed_loop`` on the CPU twins, plain and
  compensated, against the JAX ``make_mixed_loop`` run in Pallas
  interpret mode, six steps at float64, scaled error < 1e-10 over the
  whole ghost-inclusive field (the evolved ghost frame included).  One
  interpret run per spec: the JAX plain loop is the reference of both
  port loops (JAX's own compensated loop agrees with its plain one to
  f64 rounding, tests/test_pallas_mixed.py);
- the same trajectories against the JAX reference step
  (``make_det_step``), which is the scheme's specification;
- (f) the gate and the routing of mixed configurations.

The CUDA kernel itself runs only on a GPU: tests/test_torch_gpu.py.
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
from gapflow_torch.ops import mixed_bc as M
from gapflow_torch.ops import stencil as S
from gapflow_torch.validate import (BC_CASES, MIXED_CASES, journal_yaml,
                                   kernel_vs_plain_err, perturbed_q)

NX, NY, N_STEPS = 8, 128, 6
# the edge specs of tests/test_pallas_mixed.py
CASES = MIXED_CASES


def yaml(case):
    return journal_yaml(NX, NY, CASES[case], dt=2e-11, max_it=N_STEPS,
                        out="data/torch_mixed")


def scaled_err(a, b):
    return kernel_vs_plain_err(torch.as_tensor(np.array(a)),
                               torch.as_tensor(np.array(b)))


def states(text):
    """(JAX Problem, JAX SimState, port SimState, port cfg) from one
    perturbed f64 state."""
    jp = JProblem.from_string(text)
    jp._pre_run()
    q = perturbed_q(jp.q, seed=0, amp=1e-3)
    js = jp._make_state()
    js = js._replace(q=japply_bcs(jnp.asarray(q), jp._solver_cfg))
    ts = SimState.from_numpy({k: np.asarray(v)
                              for k, v in js._asdict().items()},
                             "cpu", torch.float64)
    cfg = TProblem.from_string(text, device="cpu",
                               dtype=torch.float64)._solver_cfg
    return jp, js, ts, cfg


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_loop_matches_pallas_interpret(case):
    """(c) Plain and compensated port loops vs the JAX mixed loop."""
    from jax.experimental.pallas import tpu as pltpu
    from gapflow_tpu.ops.mixed_bc import make_mixed_loop as jmake_mixed_loop

    jp, js, ts, cfg = states(yaml(case))
    assert M.mixed_supported(cfg, NY, NX)
    with pltpu.force_tpu_interpret_mode():
        jmake_mixed_loop.cache_clear()
        jloop = jmake_mixed_loop(jp._solver_cfg, NX, NY, bs=8,
                                 dtype=jnp.float64)
        jout = np.asarray(jloop(js.q, js.topo, js.extra, js.dt, N_STEPS))
        jmake_mixed_loop.cache_clear()

    args = (ts.q, ts.topo, ts.extra, ts.dt, N_STEPS)
    for compensated in (False, True):
        out = M.make_mixed_loop(cfg, NX, NY, dtype=torch.float64,
                                compensated=compensated)(*args)
        assert out.shape == (3, NX + 2, NY + 2)
        assert scaled_err(out, jout) < 1e-10
        # the evolved ghost lines themselves
        for edge in (out[:, 0], out[:, -1], out[:, :, 0], out[:, :, -1]):
            assert torch.isfinite(edge).all()
        assert scaled_err(out[:, :, 0], jout[:, :, 0]) < 1e-10
        assert scaled_err(out[:, 0], jout[:, 0]) < 1e-10


@pytest.mark.parametrize("case", ["x_mixed", "both_mixed"])
def test_mixed_loop_matches_det_step(case):
    """The port's plain mixed loop vs the JAX reference step (the scheme's
    specification), six steps at float64."""
    jp, js, ts, cfg = states(yaml(case))
    det = jmake_det_step(jp._solver_cfg, with_aux=False)
    for _ in range(N_STEPS):
        js = det(js)
    assert bool(js.valid)
    out = M.make_mixed_loop(cfg, NX, NY, dtype=torch.float64)(
        ts.q, ts.topo, ts.extra, ts.dt, N_STEPS)
    assert scaled_err(out, np.asarray(js.q)) < 1e-10


def test_mixed_step_twin_and_wrapper():
    """The K4 wrapper's state and increment forms agree; on the CPU it
    runs the twin without counting a launch, and it refuses a device
    without a kernel."""
    _, _, ts, cfg = states(yaml("both_mixed"))
    q_g = ts.q.to(torch.float32)
    st = S.ghost_statics(ts.topo, ts.extra, torch.float32, "cpu")
    # the carried ghost lines stand in for the bands' pass-1 lines
    gx = q_g[:, [0, -1]].contiguous()
    gy = q_g[:, :, [0, -1]].transpose(1, 2).contiguous()
    S.reset_launches()
    out = M.mixed_step(q_g, st, gx, gy, ts.dt, cfg)
    delta = M.mixed_step(q_g, st, gx, gy, ts.dt, cfg, emit_delta=True)
    assert not any(S.LAUNCHES.values())
    assert out.shape == delta.shape == (3, NX, NY)
    assert scaled_err(q_g[:, 1:-1, 1:-1] + delta, out) < 1e-6
    with pytest.raises(ValueError):
        M.mixed_step(q_g.to("meta"), st.to("meta"), gx.to("meta"),
                     gy.to("meta"), ts.dt, cfg)


def test_mixed_gate_and_routing():
    """(f) Mixed configurations go to make_mixed_loop, at any width; the
    gate refuses thinning, MC_order 0 and colliding band lines; uniform
    edges stay with the uniform kernels."""
    cfg = TProblem.from_string(yaml("x_mixed"), device="cpu",
                               dtype=torch.float64)._solver_cfg
    assert M.mixed_supported(cfg, NY, NX)
    assert M.mixed_supported(cfg, 127, NX)        # no width alignment
    assert not M.mixed_supported(cfg, NY, 4)      # band lines collide
    assert not M.mixed_supported(dataclasses.replace(cfg, MC_order=0),
                                 NY, NX)
    assert not M.mixed_supported(dataclasses.replace(
        cfg, thinning=(("name", "Eyring"), ("tauE", 5e5))), NY, NX)
    assert not S.pallas_supported(cfg)
    loop = S.make_pallas_loop(cfg, NX, NY, compensated=True)
    assert loop.__qualname__.startswith("make_mixed_loop")
    with pytest.raises(ValueError, match="Kahan carry"):
        S.make_pallas_loop(cfg, NX, NY, compensated=True, with_lo=True)

    uniform = TProblem.from_string(
        journal_yaml(NX, NY, BC_CASES["dn_x"][0]), device="cpu",
        dtype=torch.float64)._solver_cfg
    assert not M.mixed_supported(uniform, NY, NX)
    assert S.pallas_supported(uniform)

    bprm, bfprm = S._bc_params(cfg)
    P, D, N, G = (S._CODES[k] for k in "PDNG")
    # x edges: D, N and the evolved (given) jy ghost; y edges periodic
    assert list(bprm[:12]) == [D, N, G, D, N, G, P, P, P, P, P, P]
    np.testing.assert_allclose(bfprm[:2], [2 * 877.7007] * 2, rtol=1e-7)


def test_problem_run_steps_fast_on_cpu():
    """run_steps_fast on a mixed configuration takes the mixed loop (on
    the CPU twins here) and agrees with the plain torch step.  (The
    compensated loop differs from plain accumulation at f64 rounding,
    which the near-zero jy component scales up to ~1e-10.)"""
    text = yaml("y_mixed_x_uniform")
    fast = TProblem.from_string(text, device="cpu", dtype=torch.float64)
    plain = TProblem.from_string(text, device="cpu", dtype=torch.float64)
    assert fast._kernels_cover()
    fast.run_steps_fast(4, dtype=torch.float64, compensated=False)
    plain.run_steps(4)
    assert fast.step == plain.step == 4
    assert scaled_err(fast.q, plain.q) < 1e-10
