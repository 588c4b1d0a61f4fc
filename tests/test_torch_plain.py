"""The port's plain (uncompensated) whole-run loop agrees with JAX.

Same perturbed journal state (numpy, seed 0) into both packages, at
Nx 32, Ny 128 (the JAX kernels need a width that is a multiple of 128):

- the plain twins of the whole-run kernels against the JAX Pallas
  kernels in interpret mode, built as tests/test_pallas.py builds them,
  float32, scaled error < 1e-5: ``plain_steps_ref`` (K2p) against
  ``_kernel_fused_hbm_loop`` with ``_advance_plain`` (2 sweeps), its
  remainder form (Ke) against ``_kernel_fused_ext``, ``plain_run_ref``
  (Kv) against ``_kernel_fused_vmem`` (9 steps), and
  ``plain_steps_bc_ref`` (K3p) against ``_kernel_fused_bc_hbm`` with
  ``nch = 3`` on D/N x edges (one sweep of 4 steps) and with Barus and
  Eyring thinning (one sweep of 2);
- the slice: ``Problem.run_steps_fast(9, compensated=False)`` on the CPU
  at float64 against 9 steps of the JAX ``make_det_step``, < 1e-10, on
  periodic edges (the whole run in one Kv call), D/N x edges (4 sweeps
  of 2 and a remainder sweep of 1) and with thinning (9 sweeps of 1),
  and the one-call sweep wrappers' CPU path the same way;
- the routing of ``make_pallas_loop(compensated=False)`` (the measured
  sweep depths, the remainder sweep) and its L2 gate,
  ``validate.pallas_vs_xla_err`` on the twins, and the wrappers taking
  their twins only for CPU tensors.

The five interpret-mode runs are the expensive part of this file.  The
CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py.
"""

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
from gapflow_torch.validate import (BC_CASES, MIXED_CASES, journal_yaml,
                                    kernel_vs_plain_err, pallas_vs_xla_err,
                                    perturbed_q)

NX, NY = 32, 128


def yaml(grid="", props=None):
    kw = {"props": props} if props else {}
    return journal_yaml(NX, NY, grid, max_it=10, out="data/torch_plain",
                        **kw)


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


def _jax_call(cfg, fn):
    """``fn(_make_call(cfg, NX, NY, 16, float32), stencil)`` with the
    Pallas kernels in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    from gapflow_tpu.ops import stencil
    with pltpu.force_tpu_interpret_mode():
        stencil._make_call.cache_clear()
        out = np.asarray(fn(stencil._make_call(cfg, NX, NY, 16, jnp.float32),
                            stencil))
        stencil._make_call.cache_clear()
    return out


def _jax_args(js, stencil, extend):
    stat_ext = extend(stencil._statics_ghosted(
        js.topo.astype(jnp.float32), js.extra.astype(jnp.float32)))
    dt = jnp.asarray(js.dt, jnp.float32)[None]
    return extend(js.q.astype(jnp.float32)), stat_ext, dt


@pytest.fixture(scope="module")
def periodic():
    text = yaml()
    jp, js, ts = states(text)
    cfg = port_cfg(text)
    q = ts.q.to(torch.float32)[:, 1:-1, 1:-1].contiguous()
    st = S.interior_statics(ts.topo, ts.extra, torch.float32, "cpu")
    return jp, js, cfg, q, st, float(ts.dt)


@pytest.mark.parametrize("kernel", ["sweeps", "remainder", "whole_run"])
def test_periodic_twins_match_pallas_interpret(periodic, kernel):
    """K2p: 2 sweeps of 4 steps (``hbm_factory(2)``); Ke: 3 remainder
    steps, one ``call_ext`` each; Kv: 9 steps (``vmem_loop_factory(9)``).
    float32, < 1e-5 scaled."""
    jp, js, cfg, q, st, dt = periodic

    def run(call, stencil):
        (_, extend, _, fused, _, call_ext, vmem_factory, hbm_factory,
         *_) = call
        assert fused and call_ext is not None
        q_ext, stat_ext, jdt = _jax_args(js, stencil, extend)
        if kernel == "sweeps":
            out = hbm_factory(2)(q_ext, stat_ext, jdt)
        elif kernel == "remainder":
            out = q_ext
            for _ in range(3):
                out = call_ext(out, stat_ext, jdt)
        else:
            assert vmem_factory is not None
            out = vmem_factory(9)(q_ext, stat_ext, jdt)
        return out[:, stencil.HALO_X:stencil.HALO_X + NX, :]

    jout = _jax_call(jp._solver_cfg, run)
    if kernel == "sweeps":
        out = q
        for _ in range(2):
            out = S.plain_steps_ref(out, st, dt, cfg, S.K_MULTI)
    elif kernel == "remainder":
        out = S.plain_steps_ref(q, st, dt, cfg, 3)
    else:
        out = S.plain_run_ref(q, st, dt, cfg, 9)
    assert scaled_err(out, jout) < 1e-5
    assert scaled_err(out, q) > 1e-4         # the state moved


@pytest.mark.parametrize("case", ["dn_x", "dn_x_barus_eyring"])
def test_bc_twin_matches_pallas_interpret(case):
    """K3p: one sweep (4 steps on D/N x edges, 2 with thinning) of
    ``_kernel_fused_bc_hbm`` with ``nch = 3`` (``hbm_factory(1)``) against
    ``plain_steps_bc_ref``, float32, < 1e-5 scaled."""
    text = yaml(*BC_CASES[case])
    jp, js, ts = states(text)
    cfg = port_cfg(text)
    k = S._k_steps(cfg)
    assert k == (2 if cfg.thinning else 4)

    def run(call, stencil):
        (_, extend, _, fused, _, call_ext, _, hbm_factory, *_) = call
        assert fused and call_ext is None
        q_ext, stat_ext, jdt = _jax_args(js, stencil, extend)
        out = hbm_factory(1)(q_ext, stat_ext, jdt)
        return out[:, stencil.HALO_X:stencil.HALO_X + NX, :NY]

    jout = _jax_call(jp._solver_cfg, run)
    q = ts.q.to(torch.float32)[:, 1:-1, 1:-1].contiguous()
    st = S.ghost_statics(ts.topo, ts.extra, torch.float32, "cpu")
    out = S.plain_steps_bc_ref(q, st, float(ts.dt), cfg, k)
    assert scaled_err(out, jout) < 1e-5
    assert scaled_err(out, q) > 1e-4


@pytest.mark.parametrize("case", ["periodic", "dn_x", "dn_x_barus_eyring"])
def test_run_steps_fast_plain_matches_det_step(case):
    """The slice: 9 plain fused steps through ``run_steps_fast`` on the CPU
    (the twins of the route's kernels) against 9 JAX reference steps,
    float64, < 1e-10 scaled (ghost ring included)."""
    text = yaml(*BC_CASES[case]) if case != "periodic" else yaml()
    jp, js, _ = states(text, amp=1e-3)
    tp = TProblem.from_string(text, device="cpu", dtype=torch.float64)
    tp._pre_run()
    tp.q[...] = np.asarray(js.q)
    jstep = jmake_det_step(jp._solver_cfg, with_aux=False)
    for _ in range(9):
        js = jstep(js)
    entry, k, n_sweeps, n_rem = S._plain_route(tp._solver_cfg, NX, NY, 9,
                                               "cpu")
    assert (entry, k, n_sweeps, n_rem) == {
        "periodic": ("plain_run", 9, 1, 0),
        "dn_x": ("plain_steps_bc", 2, 4, 1),
        "dn_x_barus_eyring": ("plain_steps_bc", 1, 9, 0)}[case]
    S.reset_launches()
    tp.run_steps_fast(9, dtype=torch.float64, compensated=False)
    assert not any(S.LAUNCHES.values())
    assert tp.step == 9
    assert scaled_err(tp.q, js.q) < 1e-10


@pytest.mark.parametrize("case", ["periodic", "dn_x", "dn_x_barus_eyring"])
def test_plain_sweeps_cpu_path_matches_det_step(case):
    """The one-call sweep wrappers (``plain_sweeps``, ``plain_sweeps_bc``)
    on CPU tensors (their twins) over n = 9 steps against 9 JAX reference
    steps, float64, < 1e-10 scaled on the interior; nothing launches."""
    text = yaml(*BC_CASES[case]) if case != "periodic" else yaml()
    jp, js, ts = states(text, amp=1e-3)
    cfg = port_cfg(text)
    q = ts.q[:, 1:-1, 1:-1].contiguous()
    if case == "periodic":
        st = S.interior_statics(ts.topo, ts.extra, torch.float64, "cpu")
        sweeps = S.plain_sweeps
    else:
        st = S.ghost_statics(ts.topo, ts.extra, torch.float64, "cpu")
        sweeps = S.plain_sweeps_bc
    jstep = jmake_det_step(jp._solver_cfg, with_aux=False)
    for _ in range(9):
        js = jstep(js)
    S.reset_launches()
    out = sweeps(q, st, float(ts.dt), cfg, 9)
    assert not any(S.LAUNCHES.values())
    assert scaled_err(out, np.asarray(js.q)[:, 1:-1, 1:-1]) < 1e-10
    assert scaled_err(out, q) > 1e-6             # the state moved


def test_plain_route_and_l2_gate():
    """Which entry each shape and edge set takes (the JAX escalation),
    and the L2 gate: (2 * 3 + 8) * nx * ny floats against an H100's 50
    MiB for a CPU tensor."""
    assert S._plain_run_fits(512, 512, "cpu")            # 14 MiB
    assert S._plain_run_fits(1024, 896, "cpu")           # 49 MiB
    assert not S._plain_run_fits(1024, 1024, "cpu")      # 56 MiB
    assert not S._plain_run_fits(2048, 2048, "cpu")
    per = port_cfg(yaml())
    route = S._plain_route
    # the measured depths: 2 steps a sweep, 1 with shear thinning; the
    # deepest sweep stays the JAX package's K_MULTI (2 with thinning)
    assert S._plain_k_steps(per) == 2 and S._k_steps(per) == S.K_MULTI
    assert route(per, 512, 512, 5000, "cpu") == ("plain_run", 5000, 1, 0)
    assert route(per, 1024, 1024, 5000, "cpu") == ("plain_steps", 2, 2500,
                                                   0)
    # a remainder sweep of one step after 2 of 2 (JAX: call_ext)
    assert route(per, 2048, 2048, 5003, "cpu") == ("plain_steps", 2, 2501,
                                                   1)
    # one step: no whole-run launch, one remainder sweep
    assert route(per, 512, 512, 1, "cpu") == ("plain_steps", 2, 0, 1)
    for case, k in (("dn_x", 2), ("dn_all_asymmetric", 2),
                    ("dn_x_barus_eyring", 1), ("periodic_eyring", 1)):
        cfg = port_cfg(yaml(*BC_CASES[case]))
        assert S._plain_k_steps(cfg) == k
        assert route(cfg, 512, 512, 11, "cpu") == ("plain_steps_bc", k,
                                                   11 // k, 11 % k)
    # mixed per-component edges keep the mixed driver (K4)
    from gapflow_torch.ops.mixed_bc import mixed_supported
    mixed = port_cfg(yaml(MIXED_CASES["x_mixed"]))
    assert mixed_supported(mixed, NY, NX)
    loop = S.make_pallas_loop(mixed, NX, NY, dtype=torch.float64)
    assert loop.__module__ == "gapflow_torch.ops.mixed_bc"


def test_pallas_vs_xla_err_on_cpu_twins():
    """validate.pallas_vs_xla_err: the plain loop (the CPU twins of the
    whole-run route) against the plain step, 8 perturbed f32 steps."""
    S.reset_launches()
    assert pallas_vs_xla_err(NX, NY, device="cpu") < 1e-5
    assert not any(S.LAUNCHES.values())


def test_plain_wrappers_use_twins_only_on_cpu(periodic):
    _, _, cfg, q, st, dt = periodic
    bc_cfg = port_cfg(yaml(*BC_CASES["dn_x"]))
    st_g = S.ghost_statics(torch.ones(3, NX + 2, NY + 2) * 1e-6,
                           torch.zeros(1, NX + 2, NY + 2), torch.float32,
                           "cpu")
    S.reset_launches()
    out = S.plain_steps(q, st, dt, cfg, 2)
    assert torch.equal(out, S.plain_steps_ref(q, st, dt, cfg, 2))
    assert torch.equal(S.plain_run(q, st, dt, cfg, 2), out)
    S.plain_steps_bc(q, st_g, dt, bc_cfg, 4)
    assert not any(S.LAUNCHES.values())
    meta = (q.to("meta"), st.to("meta"))
    with pytest.raises(ValueError):
        S.plain_steps(*meta, dt, cfg, 4)
    with pytest.raises(ValueError):
        S.plain_run(*meta, dt, cfg, 4)
