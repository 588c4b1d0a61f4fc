"""The port's compensated loop (the sweeps K2c/K3c) agrees with JAX.

Same perturbed journal state (numpy, seed 0) and the same nonzero Kahan
carry (numpy, seed 1; 1e-8 of q, so that a carry dropped on the way in
moves q by 100x the tolerance) into both packages, at Nx 32, Ny 128 (the
JAX kernels need a width that is a multiple of 128):

- the slice: ``make_pallas_loop(compensated=True, with_lo=True)`` from
  that carry over a number of steps that is no multiple of the JAX
  loop's sweep depth k, 10 on periodic edges (k = 4: two sweeps and two
  steps; the port's sweeps of 3 leave one) and 7 on D/N x edges with
  Barus and Eyring thinning (k = 2: three sweeps and one step), against
  the JAX ``make_pallas_loop(..., compensated=True, with_lo=True)(...,
  q_lo)`` in Pallas interpret mode at float64: ``q``
  and ``q + q_lo`` scaled by q's magnitude < 1e-10, and ``q_lo`` on the
  same scale.  (The outgoing carry is the rounding residual of the last
  two-sum: two correct float64 evaluations whose increments differ in
  the last bit give carries that differ by their own size, so the carry
  is held on the scale of the state it corrects, not its own);
- the carry itself, where it is visible: the same loops at float32 and
  a hundredth of the step, so that the density moves by less than one
  ulp a step (the regime the carry is for), from an incoming carry of
  up to half an ulp.  The density's compensated value ``q + q_lo``
  (summed in float64) is held against the JAX loop's within 1e-3 ulp of
  q; an outgoing carry zeroed or an incoming carry dropped misses it by
  more than 0.25 ulp, which the test plants and checks.  (At float64 the
  carry is ~1e-16 of q, far below what the two packages' float64 loops
  agree to, 1e-10 above; at float32 their momenta differ by more than a
  carry and are held at 1e-4);
- the compensated wrappers (``comp_steps``, ``comp_steps_bc`` and their
  one-step witnesses ``comp_step_once``, ``comp_step_bc_once``) run
  their twins for CPU tensors and count no launch;
- the loop's split: the whole run goes to one call of the route's sweep
  wrapper, whose depth is ``_comp_k_steps`` (3, or 1 with shear
  thinning), which splits it into sweeps of that depth and one remainder
  sweep, one case per route; the depth lies in the kernel's range
  (``_k_steps``).

The sweeps themselves run only on a GPU: tests/test_torch_gpu.py holds
them bit for bit against the one-step compensated kernels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gapflow_torch.ops import stencil as S
from gapflow_torch.validate import BC_CASES, DH

from test_torch_bc import (NX, NY, _jax_interpret, port_cfg, scaled_err,
                           states, yaml)

# (grid and properties, steps): n mod k != 0 on both routes
LOOP_CASES = {"periodic": (("", DH), 10),
              "dn_x_barus_eyring": (BC_CASES["dn_x_barus_eyring"], 7)}


def carry(q_int):
    """A nonzero incoming carry, up to 1e-8 of ``q`` (numpy, seed 1)."""
    rng = np.random.default_rng(1)
    return (rng.random(q_int.shape) - 0.5) * np.abs(q_int) * 2e-8


def jax_loop(jp, js, q, lo, dt, n, dtype):
    """The JAX compensated loop with the carry exposed, in interpret mode:
    (6, NX, NY), the interior q, then q_lo."""
    return _jax_interpret(lambda step, loop: jnp.concatenate(
        [a[:, 1:-1, 1:-1] if a.shape[1] == NX + 2 else a
         for a in loop(jp._solver_cfg, NX, NY, bs=16, dtype=dtype,
                       compensated=True, with_lo=True)(
             jnp.asarray(q), js.topo, js.extra, dt, n, jnp.asarray(lo))]))


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_compensated_loop_with_carry_matches_pallas_interpret(case):
    """The slice at float64: the port's loop on the CPU twins against the
    JAX loop in interpret mode (whole-run kernel for the sweeps, the
    one-step kernel with ``emit_delta`` and a two-sum for the rest)."""
    (grid, props), n = LOOP_CASES[case]
    text = yaml(grid, props)
    jp, js, ts = states(text, amp=1e-3)
    cfg = port_cfg(text)
    assert n % S._k_steps(cfg)
    lo0 = carry(np.asarray(js.q)[:, 1:-1, 1:-1])
    jout = jax_loop(jp, js, js.q, lo0, js.dt, n, jnp.float64)
    loop = S.make_pallas_loop(cfg, NX, NY, dtype=torch.float64,
                              compensated=True, with_lo=True)
    S.reset_launches()
    q, lo = loop(ts.q, ts.topo, ts.extra, ts.dt, n, torch.as_tensor(lo0))
    assert not any(S.LAUNCHES.values())
    q, jq, jlo = q[:, 1:-1, 1:-1], jout[:3], jout[3:]
    assert scaled_err(q, jq) < 1e-10
    assert scaled_err(q + lo, jq + jlo) < 1e-10
    assert scaled_err(jq + lo.numpy(), jq + jlo) < 1e-10
    assert torch.count_nonzero(lo) > 0
    # the incoming carry reaches q: without it q moves by ~1e-8
    q_dropped, _ = loop(ts.q, ts.topo, ts.extra, ts.dt, n,
                        torch.zeros_like(lo))
    assert scaled_err(q_dropped[:, 1:-1, 1:-1], jq) > 1e-9


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_compensated_loop_carry_in_float32_matches_pallas_interpret(case):
    """The carry at float32, where it is half an ulp: the port's loop and
    the JAX loop from one float32 state and an incoming carry of up to
    half an ulp (numpy, seed 1), dt a hundredth of the case's (the
    density moves by less than one ulp over the run).  The density's
    q + q_lo agree within 1e-3 ulp of q; a zeroed outgoing carry and a
    dropped incoming carry each miss by more than 0.25 ulp."""
    (grid, props), n = LOOP_CASES[case]
    text = yaml(grid, props)
    jp, js, ts = states(text, amp=1e-3)
    cfg = port_cfg(text)
    q32 = np.asarray(js.q).astype(np.float32)
    q0 = q32[:, 1:-1, 1:-1]
    ulp = np.spacing(np.abs(q0[0])).astype(np.float64)
    rng = np.random.default_rng(1)
    lo0 = ((rng.random(q0.shape) - 0.5) * np.spacing(np.abs(q0))) \
        .astype(np.float32)
    dt = float(js.dt) / 100
    jout = jax_loop(jp, js, q32, lo0, dt, n, jnp.float32).astype(np.float64)
    loop = S.make_pallas_loop(cfg, NX, NY, dtype=torch.float32,
                              compensated=True, with_lo=True)
    q, lo = loop(torch.as_tensor(q32), ts.topo, ts.extra, dt, n,
                 torch.as_tensor(lo0))
    q, lo = q[:, 1:-1, 1:-1].double().numpy(), lo.double().numpy()
    want = jout[0] + jout[3]

    def ulps(rho):
        return (np.abs(rho - want) / ulp).max()

    assert ulps(q0[0] + lo0[0].astype(np.float64)) < 1
    assert ulps(q[0] + lo[0]) < 1e-3
    assert ulps(q[0]) > 0.25                     # outgoing carry zeroed
    q_dropped, lo_dropped = loop(torch.as_tensor(q32), ts.topo, ts.extra,
                                 dt, n, torch.zeros(q0.shape))
    assert ulps(q_dropped[0, 1:-1, 1:-1].double().numpy()
                + lo_dropped[0].double().numpy()) > 0.25
    assert scaled_err(q[1:], jout[1:3]) < 1e-4


@pytest.mark.parametrize("case", ["periodic", "dn_x"])
def test_comp_wrappers_use_twins_only_on_cpu(case):
    """On CPU tensors the sweeps and the one-step witnesses run their
    twins (n steps = n one-step twins, bit for bit) and count nothing;
    tensors on another device are refused."""
    grid, props = ("", DH) if case == "periodic" else BC_CASES[case]
    text = yaml(grid, props)
    _, _, ts = states(text)
    cfg = port_cfg(text)
    q = ts.q.to(torch.float32)[:, 1:-1, 1:-1].contiguous()
    statics = S.interior_statics if case == "periodic" else S.ghost_statics
    st = statics(ts.topo, ts.extra, torch.float32, "cpu")
    dt = float(ts.dt)
    steps, once = ((S.comp_steps, S.comp_step_once) if case == "periodic"
                   else (S.comp_steps_bc, S.comp_step_bc_once))
    lo = torch.as_tensor(carry(q.numpy())).to(torch.float32)
    S.reset_launches()
    out = steps(q, lo, st, dt, cfg, 5)
    ref = (q, lo)
    for _ in range(5):
        ref = once(*ref, st, dt, cfg)
    assert not any(S.LAUNCHES.values())
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    meta = (q.to("meta"), lo.to("meta"), st.to("meta"))
    with pytest.raises(ValueError):
        steps(*meta, dt, cfg, 5)
    with pytest.raises(ValueError):
        once(*meta, dt, cfg)


@pytest.mark.parametrize("case, route, k", [
    ("periodic", "comp_steps", 3), ("dn_x", "comp_steps_bc", 3),
    ("dn_x_barus_eyring", "comp_steps_bc", 1),
    ("periodic_eyring", "comp_steps_bc", 1)])
def test_compensated_loop_hands_the_whole_run_to_the_sweeps(
        monkeypatch, case, route, k):
    """``make_pallas_loop(compensated=True)`` calls the route's sweep
    wrapper once with all ``n`` steps, whose depth is ``k``
    (``_comp_k_steps``; on the card ``n // k`` sweeps and one of
    ``n mod k``, tests/test_torch_gpu.py), and no one-step kernel."""
    grid, props = ("", DH) if case == "periodic" else BC_CASES[case]
    text = yaml(grid, props)
    _, _, ts = states(text, amp=1e-3)
    cfg = port_cfg(text)
    assert S._comp_k_steps(cfg) == k <= S._k_steps(cfg)
    calls = []
    real = getattr(S, route)

    def spy(*args, **kw):
        calls.append((args[5], kw))
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a one-step kernel on the compensated loop")

    monkeypatch.setattr(S, route, spy)
    for name in ("fused_step", "fused_step_bc", "comp_step_once",
                 "comp_step_bc_once"):
        monkeypatch.setattr(S, name, refuse)
    loop = S.make_pallas_loop(cfg, NX, NY, dtype=torch.float64,
                              compensated=True)
    q = loop(ts.q, ts.topo, ts.extra, ts.dt, 10)
    assert calls == [(10, {})]
    assert torch.isfinite(q).all()
