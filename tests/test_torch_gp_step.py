"""The port's GP-closed step and the twins of its CUDA kernels agree with
the JAX package (CPU).

Same synthetic padded GP state (numpy generator, float32 values) and the
same perturbed journal state (32 x 128) into both packages:

- (a) the K5 / K6 twins (``gp_step_ref``, ``gp_step_bc_ref``) and the
  port's plain GP step against the JAX plain GP step
  (``make_gp_step_core(allow_pallas=False)``) at float64: scaled 1e-10
  (the twins' expanded distance differs from the Gram form only at
  rounding), plain step 1e-12; periodic, D/N x, D/N y and D/N on all
  four edges with an asymmetric Dirichlet pair;
- (b) the twins against the JAX Pallas kernels in interpret mode at
  float32, scaled 2e-5 on q and relative 2e-5 on the pressure (the JAX
  package's bar): K5 at capacities 16 (pressure only) and 64 (all three
  surrogates), K6 at 16 (all three) and 64 (pressure only); the four
  interpret-mode runs of this file;
- (c) the ``gp_steps`` twin against repeated twin steps, exactly;
- (d) the operands against the JAX package's, the JAX padded state
  carried across as numpy arrays (``models.gp.state_from_numpy``), the
  gates, the routes and the wrappers' CPU behaviour.

The CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gapflow_tpu import Problem as JProblem
from gapflow_tpu.core.gp_step import make_gp_step_core as jmake_gp_step
from gapflow_tpu.ops import stencil_gp as JG

from gapflow_torch import Problem
from gapflow_torch.core.gp_step import make_gp_step_core
from gapflow_torch.ops import stencil_gp as G
from gapflow_torch.ops.stencil import with_ghosts
from gapflow_torch.validate import (BC_CASES, GP_CASES, gp_dims_use,
                                    gp_kernel_inputs, gp_yaml,
                                    kernel_vs_plain_err)

NX, NY = 32, 128
GRIDS = {
    "periodic": "",
    "dn_x": BC_CASES["dn_x"][0],
    "dn_y": ("yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'], yS_D: 877.7007, "
             "yN_D: 877.7007"),
    "dn_all_asymmetric": BC_CASES["dn_all_asymmetric"][0],
}


def problems(tmp_path, grid, gp):
    """(port Problem after _pre_run, JAX Problem) of one configuration;
    the JAX one only lends its solver configuration and topography."""
    text = gp_yaml(NX, NY, gp=GP_CASES[gp], grid=GRIDS[grid],
                   out=str(tmp_path / "out"),
                   dtool_path=str(tmp_path / "train"))
    p = Problem.from_string(text, device="cpu", dtype=torch.float64)
    p._pre_run()
    jp = JProblem.from_string(text.replace(str(tmp_path / "train"),
                                           str(tmp_path / "jtrain")))
    return p, jp


def to_jax(state):
    return {k: ({kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
                if isinstance(v, dict) else jnp.asarray(v.numpy()))
            for k, v in state.items()}


def jax_inputs(jp, q_int, cfg, dtype):
    q = jnp.asarray(with_ghosts(q_int, cfg).numpy(), dtype)
    return (q, jnp.asarray(jp.topo.full, dtype),
            jnp.asarray(jp.fc.get_real_field("extra").p, dtype))


def twin(q, st, dt, cfg, ops, periodic):
    if periodic:
        return G.gp_step_ref(q, st, dt, cfg, ops)
    return G.gp_step_bc_ref(q, st, dt, cfg, ops, need_p=True)


@pytest.mark.parametrize("grid,gp,cap", [
    ("periodic", "pressure", 16), ("periodic", "all", 64),
    ("dn_x", "all", 16), ("dn_y", "all", 16),
    ("dn_all_asymmetric", "pressure", 64)])
def test_twin_and_plain_step_match_jax_f64(tmp_path, grid, gp, cap):
    """(a)"""
    p, jp = problems(tmp_path, grid, gp)
    cfg = p._solver_cfg
    dims, use = gp_dims_use(p)
    periodic = grid == "periodic"
    q, st, dt, ops, state = gp_kernel_inputs(p, cap, ghosted=not periodic,
                                             dtype=torch.float64)
    jq, jtopo, jextra = jax_inputs(jp, q, cfg, jnp.float64)
    jqr, jpr = jmake_gp_step(jp._solver_cfg, dims, 7, use,
                             allow_pallas=False)(jq, jtopo, jextra, dt, 0,
                                                 to_jax(state))
    jqr, jpr = torch.as_tensor(np.asarray(jqr)), np.asarray(jpr)

    qk, pk = twin(q, st, dt, cfg, ops, periodic)
    assert kernel_vs_plain_err(qk, jqr[:, 1:-1, 1:-1]) < 1e-10
    # the pass-2 pressure: interior (periodic), or with its ghost ring
    pj = jpr[1:-1, 1:-1] if periodic else jpr
    assert np.abs(pk.numpy() - pj).max() / np.abs(pj).max() < 1e-10

    plain = make_gp_step_core(cfg, dims, 7, use, allow_pallas=False)
    qr, pr = plain(with_ghosts(q, cfg), torch.as_tensor(p.topo.full),
                   torch.as_tensor(p.fc.get_real_field("extra").p), dt, 0,
                   state)
    assert kernel_vs_plain_err(qr, jqr) < 1e-12
    np.testing.assert_allclose(pr.numpy(), jpr, rtol=1e-12)


@pytest.mark.parametrize("grid,gp,cap", [
    ("periodic", "pressure", 16), ("periodic", "all", 64),
    ("dn_x", "all", 16), ("dn_all_asymmetric", "pressure", 64)])
def test_twin_matches_pallas_interpret(tmp_path, grid, gp, cap):
    """(b)"""
    from jax.experimental.pallas import tpu as pltpu
    p, jp = problems(tmp_path, grid, gp)
    cfg = p._solver_cfg
    dims, use = gp_dims_use(p)
    periodic = grid == "periodic"
    q, st, dt, ops, state = gp_kernel_inputs(p, cap, ghosted=not periodic)
    jq, jtopo, jextra = jax_inputs(jp, q, cfg, jnp.float32)
    caps = tuple(cap if u else 0 for u in use)
    with pltpu.force_tpu_interpret_mode():
        if periodic:
            fn = JG.make_pallas_gp_step_fn(jp._solver_cfg, dims, 7, use, NX,
                                           NY, caps, bs=16)
            jqk, jpk = fn(jq, jtopo, jextra, jnp.float32(dt), 0,
                          to_jax(state))
        else:
            fn = JG.make_pallas_gp_step_bc_fn(jp._solver_cfg, dims, 7, use,
                                              NX, NY, caps, bs=16)
            jqk = fn(jq, jtopo, jextra, jnp.float32(dt), to_jax(state))
    jqk = torch.as_tensor(np.asarray(jqk))[:, 1:-1, 1:-1]

    qk, pk = twin(q, st, dt, cfg, ops, periodic)
    assert kernel_vs_plain_err(qk, jqk) < 2e-5
    if periodic:
        pj = np.asarray(jpk)[1:-1, 1:-1]
        assert np.abs(pk.numpy() - pj).max() / np.abs(pj).max() < 2e-5


def test_gp_steps_twin_is_repeated_steps(tmp_path):
    """(c)"""
    p, _ = problems(tmp_path, "periodic", "all")
    cfg = p._solver_cfg
    q, st, dt, ops, _ = gp_kernel_inputs(p, 16)
    ref = q
    for _ in range(3):
        ref, _ = G.gp_step_ref(ref, st, dt, cfg, ops)
    assert torch.equal(G.gp_steps(q, st, dt, cfg, ops, 3), ref)
    assert torch.equal(G.gp_steps_ref(q, st, dt, cfg, ops, 3), ref)
    assert torch.equal(G.gp_steps(q, st, dt, cfg, ops, 0), q)


def test_operands_match_jax(tmp_path):
    """(d) ``prep_gp_ops`` against ``_prep_gp_ops`` (float64), and the
    packed layout the CUDA entry points read."""
    p, _ = problems(tmp_path, "periodic", "all")
    dims, use = gp_dims_use(p)
    _, _, _, ops, state = gp_kernel_inputs(p, 16, dtype=torch.float64)
    jstate = to_jax(state)
    for key, d in zip(G.KEYS, dims):
        jc, jW, jw2, ja = JG._prep_gp_ops(jstate, d, key)
        dd, c, W, w2, a = ops.models[key]
        assert dd == d
        for t, j in ((c, jc[0]), (W, jW), (w2, jw2[:, 0]), (a, ja)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    meta, coef, data = ops.device_args()
    assert data.dtype == torch.float32
    off = 0
    for m, key in enumerate(G.KEYS):
        dd, c, W, w2, a = ops.models[key]
        cap, d = W.shape
        assert list(meta[m, :5]) == [1, d, cap, a.shape[1], off]
        assert list(meta[m, 5:5 + d]) == list(dd)
        # rows [Wm2, w2, alpha, zeros], padded to a multiple of 4 floats
        width = -(-(d + 1 + a.shape[1]) // 4) * 4
        rows = data[off:off + cap * width].reshape(cap, width)
        assert torch.equal(rows[:, :d], W.float())
        assert torch.equal(rows[:, d], w2.float())
        assert torch.equal(rows[:, d + 1:d + 1 + a.shape[1]], a.float())
        assert not rows[:, d + 1 + a.shape[1]:].any()
        off += rows.numel()
    assert off == data.numel()


def test_gates_routes_and_wrappers(tmp_path):
    """(d)"""
    from dataclasses import replace
    p, _ = problems(tmp_path, "dn_x", "all")
    cfg = p._solver_cfg
    dims, use = gp_dims_use(p)
    assert G.gp_bc_kernel_supported(cfg, dims, use)
    assert not G.gp_kernel_supported(cfg, dims, use)
    assert not G.gp_bc_kernel_supported(cfg, ((0, 7),) + dims[1:], use)
    assert not G.gp_bc_kernel_supported(replace(cfg, MC_order=0), dims, use)
    thin = replace(cfg, thinning=(("name", "Eyring"), ("tauE", 5e5)))
    assert not G.gp_bc_kernel_supported(thin, dims, use)

    q, st, dt, ops, _ = gp_kernel_inputs(p, 16, ghosted=True)
    assert torch.equal(G.gp_step_bc(q, st, dt, cfg, ops),
                       G.gp_step_bc_ref(q, st, dt, cfg, ops))
    with pytest.raises(ValueError, match="no kernel"):
        G.gp_step_bc(q.to("meta"), st, dt, cfg, ops)

    # the plain step on the CPU, whatever the dtype (on a float32 CUDA
    # state the boundary kernel, with or without the pressure)
    for need_p in (False, True):
        step = make_gp_step_core(cfg, dims, 7, use, need_p=need_p)
        assert step.route(torch.as_tensor(p.q, dtype=torch.float32)) is None


def test_periodic_gate(tmp_path):
    p, _ = problems(tmp_path, "periodic", "pressure")
    cfg = p._solver_cfg
    dims, use = gp_dims_use(p)
    assert G.gp_kernel_supported(cfg, dims, use)
    assert not G.gp_bc_kernel_supported(cfg, dims, use)
    q, st, dt, ops, _ = gp_kernel_inputs(p, 16)
    for a, b in zip(G.gp_step(q, st, dt, cfg, ops),
                    G.gp_step_ref(q, st, dt, cfg, ops)):
        assert torch.equal(a, b)
    # the variant without the pressure output
    q1, p1 = G.gp_step(q, st, dt, cfg, ops, need_p=False)
    assert p1 is None and torch.equal(q1, G.gp_step_ref(q, st, dt, cfg,
                                                        ops)[0])


def test_state_from_numpy_carries_the_jax_state(tmp_path):
    """The JAX package's synthetic padded state, carried across as numpy
    arrays, is the port's own draw from the same generator, exactly."""
    from gapflow_tpu.validate import synthetic_gp_state as jsynthetic
    from gapflow_torch.models.gp import state_from_numpy
    from gapflow_torch.validate import synthetic_gp_state
    p, _ = problems(tmp_path, "periodic", "all")
    dims, use = gp_dims_use(p)
    jstate = jsynthetic(dims, use, 16, np.random.default_rng(4))
    carried = state_from_numpy(
        {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else np.asarray(v))
         for k, v in jstate.items()}, dtype=torch.float32)
    own = synthetic_gp_state(dims, use, 16, np.random.default_rng(4))
    assert carried.keys() == own.keys()
    for k, v in own.items():
        for kk, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            c = carried[k][kk] if kk else carried[k]
            assert c.dtype == t.dtype and torch.equal(c, t), (k, kk)
