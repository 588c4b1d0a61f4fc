"""The port's sharded path agrees with its serial path and with JAX.

Shards on ``"cpu"`` (a :class:`gapflow_torch.parallel.Mesh` whose
devices repeat, the counterpart of the JAX package's virtual devices);
states from numpy (seed 5), grids of 32 x 32 (16 x 32 for the kernel
block), at most 5 steps:

- (a) the K9 twin ``shard_step_ref`` against the JAX package's
  ``make_bc_shard_call`` in Pallas interpret mode, on one D/N block laid
  out by the JAX package's own ``_to_kernel_layout``, for all 16 flag
  patterns: float64 within 1e-12 and float32 within 1e-5 (component
  scaled; XLA's float32 rounding of the momentum update parts the two by
  1.5e-6 on this block, which float64 shows to be rounding);
- (b) ``Problem.run_steps_sharded`` against the port's serial run bit
  for bit, on meshes (1, 1), (2, 2), (1, 4), (2, 4), periodic, x-D/N
  and all-edge-D/N journals (the JAX test's ``EDGES_XDN`` and
  ``EDGES_ALL``), both routes (``use_pallas=True``: K9's twin against
  ``make_pallas_loop(compensated=False)``; ``False``: the plain sharded
  step against ``run_steps``), float64 and float32;
- (c) the port against the JAX package's ``run_steps_sharded`` (XLA
  route) on the same mesh shape at float64, within 1e-12 scaled: fixed
  dt, and the adaptive state route with dt, simtime and the residual
  within 1e-12 relative;
- (d) the sharded EHL loop against the JAX package's (XLA route) at
  float64, within 1e-12 scaled, and against the port's serial EHL loop
  (plain step, and bit for bit on the kernel route's twins);
- (a') the shard sweep's twin ``shard_sweep_ref`` on 2k-deep halo
  blocks against k one-step twins with a 2-deep exchange before each,
  bit for bit, k = 1-4, float32 and float64, every flag pattern of a
  2 x 2 and a 1 x 4 mesh; on a 1D block against the serial boundary
  twin; the blocked sharded loops at k = 2-4 with a remainder against
  the serial routes, and at ``SHARD_K`` against the JAX package's
  sharded run (1e-12 at float64);
- (e) ``pad_blocks``, ``pad_blocks2``, ``pad_blocks2_bc`` equal to the
  JAX package's arrays; ``ici_bytes_per_step`` against the JAX
  package's counts and a hand count;
- the JAX package's sharded q through the port's ``shard_problem_arrays``
  and back, unchanged, each block equal to the JAX shard;
- (f) the refusals: GP problems, a grid that does not divide the mesh, a
  CUDA mesh without CUDA, a kernel route the kernel does not cover.

The CUDA kernel itself runs only on a GPU: tests/test_torch_gpu.py.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gapflow_tpu import Problem as JProblem
from gapflow_tpu.core.step import apply_bcs as japply_bcs
from gapflow_tpu.parallel import grid_mesh as jgrid_mesh

from gapflow_torch import Problem as TProblem
from gapflow_torch.models.closures_opt import precompute_statics
from gapflow_torch.ops import stencil as S
from gapflow_torch.parallel import Mesh, gather, grid_mesh, pad_blocks
from gapflow_torch.parallel.halo import (halo_blocks, shard_problem_arrays,
                                         split_blocks)
from gapflow_torch.parallel.pallas_halo import (SHARD_K, ici_bytes_per_step,
                                                pad_blocks2, pad_blocks2_bc,
                                                shard_flags)
from gapflow_torch.validate import (EHL_ELASTIC, gp_yaml, kernel_vs_plain_err,
                                    perturbed_q)

# the JAX package's sharded bc test configuration (tests/
# test_pallas_sharded.py sim_bc) at 32 x 32
SIM = """
options: {{output: data/torch_shard, write_freq: 1000, silent: True}}
grid: {{dx: 2.e-5, dy: 2.e-5, Nx: {nx}, Ny: {ny}{edges}}}
geometry: {{type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.05}}
numerics: {{CFL: 0.5, adaptive: {adaptive}, tol: 1e-8, dt: 5e-11,
            max_it: 10, MC_order: {mc}}}
properties: {{shear: 0.0794, bulk: 0., EOS: DH, P0: 101325.,
              rho0: 877.7007, C1: 3.5e10, C2: 1.23{props}}}
"""
EDGES_XDN = (", xE: ['D', 'N', 'N'], xW: ['D', 'N', 'N'], xE_D: 877.7007, "
             "xW_D: 877.7007")
EDGES_ALL = EDGES_XDN + (", yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'], "
                         "yS_D: 877.7007, yN_D: 877.7007")
# an asymmetric Dirichlet pair on each axis, for the kernel block
EDGES_ASYM = (", xE: ['D', 'N', 'N'], xW: ['D', 'N', 'N'], xE_D: 900., "
              "xW_D: 850., yS: ['D', 'N', 'N'], yN: ['D', 'N', 'N'], "
              "yS_D: 880., yN_D: 860.")
EDGES = {"periodic": "", "xdn": EDGES_XDN, "all": EDGES_ALL}
SHAPES = [(1, 1), (2, 2), (1, 4), (2, 4)]
N_STEPS = 5


def sim(edges="", nx=32, ny=32, adaptive=0, mc=1, props=""):
    return SIM.format(nx=nx, ny=ny, edges=edges, adaptive=adaptive, mc=mc,
                      props=props)


def cpu_mesh(shape):
    return grid_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def port(text, dtype, q=None):
    p = TProblem.from_string(text, device="cpu", dtype=dtype)
    p._pre_run()
    if q is not None:
        p.q[...] = q
    return p


def pair(text, seed=5):
    """(JAX Problem, port Problem at float64) on one perturbed state."""
    jp = JProblem.from_string(text)
    jp._pre_run()
    q = np.asarray(japply_bcs(jnp.asarray(perturbed_q(jp.q, seed=seed)),
                              jp._solver_cfg))
    jp.q[...] = q
    return jp, port(text, torch.float64, q)


def scaled_err(a, b):
    return kernel_vs_plain_err(torch.as_tensor(np.array(a)),
                               torch.as_tensor(np.array(b)))


# -- (a) the K9 twin against the Pallas kernel ------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_shard_twin_matches_pallas_interpret(dtype, tol):
    from jax.experimental.pallas import tpu as pltpu
    from gapflow_tpu.ops.stencil import (HALO_X, _statics_ghosted,
                                         make_bc_shard_call)
    from gapflow_tpu.parallel.pallas_halo import (_pad_width,
                                                  _to_kernel_layout)

    bx, by = 16, 32
    jp, tp = pair(sim(EDGES_ASYM, nx=bx, ny=by))
    cfg = tp._solver_cfg
    assert S.shard_supported(cfg)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    blocks = [pad_blocks2_bc(a, 1, 1, False, False).astype(np_dtype)
              for a in (tp.q, tp.topo.full, tp.fc.get_real_field("extra").p)]
    q_blk, topo2, extra2 = map(torch.as_tensor, blocks)
    st = precompute_statics(topo2[:3], extra2)
    dt = float(np_dtype(tp.dt))

    W = _pad_width(by)

    def wrap_layout(rows):
        rows = jnp.concatenate([jnp.repeat(rows[:, :1], HALO_X - 2, axis=1),
                                rows,
                                jnp.repeat(rows[:, -1:], HALO_X - 2, axis=1)],
                               axis=1)
        return _to_kernel_layout(rows, by, W)

    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        call = jax.jit(make_bc_shard_call(jp._solver_cfg, bx, by, W,
                                          dtype=jdtype))
        q_ext = wrap_layout(jnp.asarray(blocks[0]))
        st_ext = wrap_layout(_statics_ghosted(jnp.asarray(blocks[1]),
                                              jnp.asarray(blocks[2])))
        for flags in itertools.product((0, 1), repeat=4):
            out = np.asarray(call(q_ext, st_ext, jnp.asarray([dt], jdtype),
                                  jnp.asarray(flags, jnp.int32)))[:, :, :by]
            ref = S.shard_step_ref(q_blk, st, dt, cfg, flags)
            assert ref.dtype == dtype
            assert scaled_err(out, ref) < tol, flags


def test_shard_step_takes_its_twin_on_the_cpu():
    tp = port(sim(EDGES_ASYM, nx=16, ny=32), torch.float32)
    cfg = tp._solver_cfg
    q = torch.as_tensor(pad_blocks2_bc(tp.q, 1, 1, False, False),
                        dtype=torch.float32)
    st = precompute_statics(q.new_ones((3,) + q.shape[1:]),
                            q.new_zeros((1,) + q.shape[1:]))
    S.reset_launches()
    out = S.shard_step(q, st, tp.dt, cfg, (1, 0, 0, 1))
    assert torch.equal(out, S.shard_step_ref(q, st, tp.dt, cfg,
                                             (1, 0, 0, 1)))
    assert tuple(out.shape) == (3, 16, 32)
    assert S.LAUNCHES["shard_step"] == 0


def test_shard_supported():
    def cfg(**kw):
        return port(sim(**kw), torch.float64)._solver_cfg
    assert S.shard_supported(cfg())
    assert S.shard_supported(cfg(edges=EDGES_ALL))
    assert not S.shard_supported(cfg(mc=0))
    assert not S.shard_supported(cfg(
        props=", thinning: {name: Eyring, tauE: 5.e5}"))
    assert not S.shard_supported(cfg(
        edges=", xE: ['D', 'N', 'P'], xW: ['D', 'N', 'P'], xE_D: 877.7007, "
              "xW_D: 877.7007"))


# -- (a') the shard sweep's twin --------------------------------------------

def shard_statics(p, shape, mesh, dtype, depth, per=(False, False)):
    """Each shard's statics from its ``depth``-deep topography block."""
    def lay(a):
        return split_blocks(pad_blocks2_bc(a, *shape, *per, depth), mesh,
                            dtype)
    t, e = lay(p.topo.full), lay(p.fc.get_real_field("extra").p)
    return [[precompute_statics(t[i][j][:3], e[i][j])
             for j in range(shape[1])] for i in range(shape[0])]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_shard_sweep_twin_equals_exchanged_steps(dtype, shape, k):
    """``shard_sweep_ref`` on each shard's 2k-deep halo block (its statics
    one cell deeper) equals k one-step twins with a 2-deep exchange
    before each, bit for bit, on every flag pattern of the mesh (the
    four-edge D/N journal with an asymmetric Dirichlet pair on each
    axis)."""
    text = sim(EDGES_ASYM)
    p = port(text, dtype, perturbed_q(port(text, torch.float64).q, seed=5))
    p._communicate_ghost_buffers()
    cfg = p._solver_cfg
    mesh = cpu_mesh(shape)
    q, _, _ = shard_problem_arrays(p, mesh, dtype)
    st2 = shard_statics(p, shape, mesh, dtype, 2)
    stk = shard_statics(p, shape, mesh, dtype, 2 * k + 1)
    flags = [[shard_flags(cfg, mesh, i, j) for j in range(shape[1])]
             for i in range(shape[0])]
    ref = q
    for _ in range(k):
        hb = halo_blocks(ref, mesh, 2, cfg)
        ref = [[S.shard_step_ref(hb[i][j], st2[i][j], p.dt, cfg, flags[i][j])
                for j in range(shape[1])] for i in range(shape[0])]
    hb = halo_blocks(q, mesh, 2 * k, cfg)
    for i in range(shape[0]):
        for j in range(shape[1]):
            out = S.shard_sweep_ref(hb[i][j], stk[i][j], p.dt, cfg,
                                    flags[i][j], k)
            assert out.dtype == dtype
            assert torch.equal(out, ref[i][j]), flags[i][j]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_shard_sweep_twin_on_a_1d_block(k):
    """A 1D domain (32 x 1, x D/N, y periodic) as one block with a
    2k-deep halo (the y wrap repeating its one column): the sweep twin
    and the shard sweep's CPU route equal the serial boundary sweep's
    twin on the whole domain, bit for bit."""
    text = sim(EDGES_XDN, ny=1)
    p = port(text, torch.float64, perturbed_q(port(text, torch.float64).q,
                                              seed=5))
    p._communicate_ghost_buffers()
    cfg = p._solver_cfg
    d = 2 * k
    q = torch.as_tensor(pad_blocks2_bc(p.q, 1, 1, False, True, d))
    lay = [torch.as_tensor(pad_blocks2_bc(a, 1, 1, False, True, d + 1))
           for a in (p.topo.full, p.fc.get_real_field("extra").p)]
    st = precompute_statics(lay[0][:3], lay[1])
    flags = (1, 1, 0, 0)
    out = S.shard_sweep_ref(q, st, p.dt, cfg, flags, k)
    assert tuple(out.shape) == (3, 32, 1)
    S.reset_launches()
    assert torch.equal(S.shard_sweep(q, st, p.dt, cfg, flags, k), out)
    assert S.LAUNCHES["shard_sweep"] == 0
    ref = S.plain_steps_bc_ref(torch.as_tensor(p.q)[:, 1:-1, 1:-1],
                               st[:, d:-d, d:-d], p.dt, cfg, k)
    assert torch.equal(out, ref)


def test_shard_sweep_refuses_a_shallow_block():
    tp = port(sim(EDGES_ASYM, nx=16, ny=32), torch.float32)
    cfg = tp._solver_cfg
    q = torch.as_tensor(pad_blocks2_bc(tp.q, 1, 1, False, False, 4))
    st = precompute_statics(q.new_ones((3,) + q.shape[1:]),
                            q.new_zeros((1,) + q.shape[1:]))
    with pytest.raises(ValueError, match="statics block"):
        S.shard_sweep(q, st[:, 1:-1, 1:-1], tp.dt, cfg, (1, 1, 1, 1), 2)
    with pytest.raises(ValueError, match="steps per launch"):
        S.shard_sweep(q, st, tp.dt, cfg, (1, 1, 1, 1), 5)
    with pytest.raises(ValueError, match="halo"):
        S.shard_sweep(q[:, :5, :5], st, tp.dt, cfg, (1, 1, 1, 1), 2)


# -- (b) sharded == serial, bit for bit -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("edges", list(EDGES))
def test_sharded_run_matches_serial(edges, shape, use_pallas, dtype):
    text = sim(EDGES[edges])
    q = perturbed_q(port(text, torch.float64).q, seed=5)
    p = port(text, dtype, q)
    p._communicate_ghost_buffers()
    s = port(text, dtype, p.q)

    out = p.run_steps_sharded(N_STEPS, cpu_mesh(shape), use_pallas=use_pallas)
    assert p.step == N_STEPS
    assert p.simtime == pytest.approx(N_STEPS * p.dt, rel=1e-15)
    if use_pallas:
        loop = S.make_pallas_loop(s._solver_cfg, 32, 32, dtype=dtype,
                                  compensated=False)
        ref = loop(s._tensor(s.q), s.topo.full,
                   s.fc.get_real_field("extra").p, s.dt, N_STEPS).numpy()
    else:
        s.run_steps(N_STEPS)
        ref = s.q
    np.testing.assert_array_equal(p.q, ref)
    np.testing.assert_array_equal(out.numpy(), p.q[:, 1:-1, 1:-1])


def test_plain_route_alternating_pass_order():
    """MC_order 0 (the pass order alternates by step) takes the plain
    sharded step, equal to the serial one; the kernel route raises."""
    text = sim(EDGES_XDN, mc=0)
    q = perturbed_q(port(text, torch.float64).q, seed=5)
    p, s = port(text, torch.float64, q), port(text, torch.float64, q)
    p._communicate_ghost_buffers()
    s._communicate_ghost_buffers()
    p.run_steps_sharded(N_STEPS, cpu_mesh((2, 2)))
    s.run_steps(N_STEPS)
    np.testing.assert_array_equal(p.q, s.q)
    with pytest.raises(ValueError, match="static-order"):
        p.run_steps_sharded(1, cpu_mesh((2, 2)), use_pallas=True)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("edges", ["periodic", "all"])
def test_blocked_sharded_loop_matches_serial(edges, k):
    """The sharded kernel loops at each timed depth on a 2 x 4 mesh, 7
    steps (sweeps of k and one of 7 mod k), float32 on the twins: bit for
    bit against the serial plain kernel route, one sweep per shard and
    exchange (none counted on the twins)."""
    from gapflow_torch.parallel.pallas_halo import (
        make_sharded_bc_pallas_loop, make_sharded_pallas_loop,
        statics_depth)
    text = sim(EDGES[edges])
    dtype = torch.float32
    q0 = perturbed_q(port(text, torch.float64).q, seed=5)
    p = port(text, dtype, q0)
    p._communicate_ghost_buffers()
    cfg = p._solver_cfg
    shape = (2, 4)
    mesh = cpu_mesh(shape)
    make = (make_sharded_pallas_loop if edges == "periodic"
            else make_sharded_bc_pallas_loop)
    loop = make(cfg, mesh, 32, 32, dtype, k=k)
    assert loop.k == k
    calls = []

    def sweep(q_blk, st, dt, cfg_, flags, depth):
        calls.append(depth)
        return S.shard_sweep(q_blk, st, dt, cfg_, flags, depth)

    loop = make(cfg, mesh, 32, 32, dtype, sweep_fn=sweep, k=k)
    per = (edges == "periodic",) * 2
    d = statics_depth(k)
    lay = [split_blocks(pad_blocks2_bc(a, *shape, *per, d), mesh, dtype)
           for a in (p.topo.full, p.fc.get_real_field("extra").p)]
    q, _, _ = shard_problem_arrays(p, mesh, dtype)
    out = gather(loop(q, *lay, p.dt, 7))
    depths = [k] * (7 // k) + [7 % k] * (7 % k > 0)
    assert calls == [dep for dep in depths for _ in range(8)]
    s = port(text, dtype, p.q)
    ref = S.make_pallas_loop(s._solver_cfg, 32, 32, dtype=dtype,
                             compensated=False)(
        s._tensor(s.q), s.topo.full, s.fc.get_real_field("extra").p, s.dt,
        7)
    np.testing.assert_array_equal(out.numpy(), ref[:, 1:-1, 1:-1].numpy())


def test_thin_blocks_take_shallower_sweeps():
    """A 32 x 8 grid on a 1 x 4 mesh (blocks of 32 x 2) takes one step a
    sweep, 32 x 12 (blocks 32 x 3) one, 32 x 16 (32 x 4) two, each bit
    for bit against the serial route; thinner blocks are refused."""
    from gapflow_torch.parallel.pallas_halo import make_sharded_pallas_loop
    for ny, k in ((8, 1), (12, 1), (16, 2)):
        text = sim(ny=ny)
        p = port(text, torch.float64)
        cfg = p._solver_cfg
        assert make_sharded_pallas_loop(cfg, cpu_mesh((1, 4)), 32, ny,
                                        k=4).k == k
        q = perturbed_q(p.q, seed=5)
        a, s = port(text, torch.float64, q), port(text, torch.float64, q)
        a._communicate_ghost_buffers()
        s._communicate_ghost_buffers()
        a.run_steps_sharded(5, cpu_mesh((1, 4)), use_pallas=True)
        ref = S.make_pallas_loop(s._solver_cfg, 32, ny, dtype=torch.float64,
                                 compensated=False)(
            s._tensor(s.q), s.topo.full, s.fc.get_real_field("extra").p,
            s.dt, 5)
        np.testing.assert_array_equal(a.q, ref.numpy())
    with pytest.raises(ValueError, match="halo needs blocks"):
        port(sim(ny=4), torch.float64).run_steps_sharded(
            1, cpu_mesh((1, 4)), use_pallas=True)


# -- (c) the port against the JAX package's sharded run ---------------------

@pytest.mark.parametrize("edges,shape", [("periodic", (2, 2)),
                                         ("all", (2, 4))])
def test_sharded_run_matches_jax(edges, shape):
    jp, tp = pair(sim(EDGES[edges]))
    k = shape[0] * shape[1]
    jp.run_steps_sharded(N_STEPS, mesh=jgrid_mesh(jax.devices()[:k],
                                                  shape=shape),
                         use_pallas=False)
    tp.run_steps_sharded(N_STEPS, cpu_mesh(shape), use_pallas=False)
    assert scaled_err(tp.q, jp.q) < 1e-12
    assert (tp.step, tp.simtime) == (jp.step, jp.simtime)


@pytest.mark.parametrize("edges", ["periodic", "all"])
def test_blocked_sharded_run_matches_jax(edges):
    """The sharded kernel route (the shard sweep's twin, SHARD_K steps per
    exchange, 7 steps: a remainder sweep) at float64 on a 2 x 2 mesh
    against the JAX package's sharded run, within 1e-12 scaled."""
    jp, tp = pair(sim(EDGES[edges]))
    jp.run_steps_sharded(7, mesh=jgrid_mesh(jax.devices()[:4],
                                            shape=(2, 2)),
                         use_pallas=False)
    tp.run_steps_sharded(7, cpu_mesh((2, 2)), use_pallas=True)
    assert 7 % SHARD_K
    assert scaled_err(tp.q, jp.q) < 1e-12
    assert (tp.step, tp.simtime) == (jp.step, jp.simtime)


def test_sharded_adaptive_matches_jax_and_serial():
    """The adaptive state route: q, dt, simtime and the residual against
    the JAX package's sharded run (1e-12), and against the port's serial
    run (the shards' sums reassociate the kinetic energy)."""
    text = sim(EDGES_ALL, adaptive=1)
    jp, tp = pair(text)
    sp = port(text, torch.float64, tp.q)
    jp.run_steps_sharded(N_STEPS, mesh=jgrid_mesh(jax.devices()[:8],
                                                  shape=(2, 4)))
    tp.run_steps_sharded(N_STEPS, cpu_mesh((2, 4)))
    sp.run_steps(N_STEPS)
    for ref in (jp, sp):
        assert scaled_err(tp.q, ref.q) < 1e-12
        assert tp.step == ref.step == N_STEPS
        for key in ("dt", "simtime", "residual"):
            assert getattr(tp, key) == pytest.approx(getattr(ref, key),
                                                     rel=1e-12), key
    assert tp.dt != 5e-11


# -- (d) the sharded EHL loop -------------------------------------------------

EHL = ", " + EHL_ELASTIC


def ehl_u(p):
    return np.asarray(p.topo.ElasticDeformation.u_prev)


def test_sharded_ehl_matches_jax():
    """deform_every 2 (the compounded relaxation factor), 2 x 2 mesh."""
    jp, tp = pair(sim(props=EHL))
    jp.run_steps_sharded(4, mesh=jgrid_mesh(jax.devices()[:4], shape=(2, 2)),
                         use_pallas=False, deform_every=2)
    tp.run_steps_sharded(4, cpu_mesh((2, 2)), deform_every=2)
    assert np.abs(ehl_u(tp)).max() > 0.
    assert scaled_err(tp.q, jp.q) < 1e-12
    assert np.abs(ehl_u(tp) - ehl_u(jp)).max() / np.abs(ehl_u(jp)).max() \
        < 1e-12
    assert scaled_err(tp.topo.full, jp.topo.full) < 1e-12
    assert tp.step == jp.step == 4


@pytest.mark.parametrize("deform_every", [1, 2])
def test_sharded_ehl_matches_serial(deform_every):
    """The plain sharded EHL loop against the port's serial EHL loop
    (``run_steps_ehl``, the plain step on the CPU), on a 2 x 4 mesh."""
    text = sim(props=EHL)
    q = perturbed_q(port(text, torch.float64).q, seed=5)
    a, b = port(text, torch.float64, q), port(text, torch.float64, q)
    a._communicate_ghost_buffers()
    b._communicate_ghost_buffers()
    a.run_steps_sharded(4, cpu_mesh((2, 4)), deform_every=deform_every)
    b.run_steps_ehl(4, deform_every=deform_every)
    assert scaled_err(a.q, b.q) < 1e-12
    assert np.abs(ehl_u(a) - ehl_u(b)).max() / np.abs(ehl_u(b)).max() < 1e-12
    np.testing.assert_array_equal(a.fc.get_real_field("pressure").p,
                                  b.fc.get_real_field("pressure").p)


def test_sharded_ehl_kernel_route_matches_serial_kernel_route():
    """The periodic K9 route of the sharded EHL loop (its twin here)
    against the serial EHL loop's kernel route (``make_ehl_loop`` with
    ``use_pallas``, K1's twin on the interior statics), bit for bit.  The
    plain step differs from both at the seam: it reads the ghost cells'
    one-sided gap slopes where the kernel routes wrap the interior."""
    from gapflow_torch.core.ehl import make_ehl_loop
    text = sim(props=EHL)
    q = perturbed_q(port(text, torch.float64).q, seed=5)
    a, b = port(text, torch.float64, q), port(text, torch.float64, q)
    a._communicate_ghost_buffers()
    b._communicate_ghost_buffers()
    a.run_steps_sharded(4, cpu_mesh((2, 2)), use_pallas=True, deform_every=2)
    loop = make_ehl_loop(b, use_pallas=True, dtype=torch.float64,
                         deform_every=2)
    qs, u = loop(b._tensor(b.q), b.topo.ElasticDeformation.u_prev, b.dt, 4)
    np.testing.assert_array_equal(a.q, qs.numpy())
    np.testing.assert_array_equal(a.topo.ElasticDeformation.u_prev.numpy(),
                                  u.numpy())


# -- (e) the block layouts, and the state carried across --------------------

@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (4, 2)])
def test_block_layouts_equal_jax(shape):
    from gapflow_tpu.parallel.halo import pad_blocks as jpad_blocks
    from gapflow_tpu.parallel.pallas_halo import (
        pad_blocks2 as jpad_blocks2, pad_blocks2_bc as jpad_blocks2_bc)
    g = np.random.default_rng(5).standard_normal((4, 34, 34))
    np.testing.assert_array_equal(pad_blocks(g, *shape),
                                  jpad_blocks(g, *shape))
    np.testing.assert_array_equal(pad_blocks2(g, *shape),
                                  jpad_blocks2(g, *shape))
    for per in itertools.product((False, True), repeat=2):
        np.testing.assert_array_equal(pad_blocks2_bc(g, *shape, *per),
                                      jpad_blocks2_bc(g, *shape, *per))


def test_jax_sharded_state_carried_across():
    """The JAX package's sharded q, topography and extra blocks through
    the port's shard_problem_arrays: each port block equals the JAX
    shard at the same mesh position, and gathered back, the interior is
    unchanged."""
    from gapflow_tpu.parallel.halo import (
        shard_problem_arrays as jshard_problem_arrays)
    jp, tp = pair(sim(EDGES_ALL))
    shape = (2, 4)
    jmesh = jgrid_mesh(jax.devices()[:8], shape=shape)
    jq, jtopo, jextra = jshard_problem_arrays(jp, jmesh)
    tp.q[:, 1:-1, 1:-1] = np.asarray(jq)
    mesh = cpu_mesh(shape)
    q, topo, extra = shard_problem_arrays(tp, mesh)
    for jarr, blocks in ((jq, q), (jtopo, topo), (jextra, extra)):
        for s in jarr.addressable_shards:
            _, sx, sy = s.index
            b = blocks[sx.start // (sx.stop - sx.start)][
                sy.start // (sy.stop - sy.start)]
            np.testing.assert_array_equal(b.numpy(), np.asarray(s.data))
    np.testing.assert_array_equal(gather(q).numpy(), np.asarray(jq))
    assert all(b.device == torch.device("cpu") for row in q for b in row)


def test_halo_copy_bytes_match_jax():
    """ici_bytes_per_step: one 2-deep exchange per step ("step") is the
    JAX package's one-step ("gp") count, the 8-deep exchange per 4 steps
    ("tpu_blocked") its temporally blocked ("det") count, and the loops'
    own count at k = 4 equals the latter."""
    from gapflow_tpu.parallel.pallas_halo import (
        ici_bytes_per_step as jici_bytes_per_step)
    for shape in ((1, 1), (2, 2), (2, 4), (1, 8)):
        args = (1024, 1024) + shape
        assert ici_bytes_per_step(*args, mode="step") \
            == jici_bytes_per_step(*args, mode="gp")
        assert ici_bytes_per_step(*args, mode="tpu_blocked") \
            == jici_bytes_per_step(*args, mode="det") \
            == ici_bytes_per_step(*args, k=4)
    assert ici_bytes_per_step(1024, 1024, 1, 1) == 0


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ici_bytes_per_step_hand_count(k):
    """The loops' halo bytes per shard and step against a hand count at
    1024² on 2 x 4 float32 shards (bx 512, by 256): a 2k-deep exchange per
    k steps moves 2 x 3 x 2k x 256 floats along x and 2 x 3 x (512 + 4k)
    x 2k along y; a 1 x 4 mesh moves only the y halo, 4 x 1 only the x
    halo."""
    d = 2 * k
    x = 2 * 3 * d * 256 * 4
    y = 2 * 3 * (512 + 2 * d) * d * 4
    assert ici_bytes_per_step(1024, 1024, 2, 4, k=k) == (x + y) / k
    assert ici_bytes_per_step(1024, 1024, 1, 4, k=k) \
        == 2 * 3 * (1024 + 2 * d) * d * 4 / k
    assert ici_bytes_per_step(1024, 1024, 4, 1, k=k) \
        == 2 * 3 * d * 1024 * 4 / k
    assert ici_bytes_per_step(1024, 1024, 2, 4) \
        == ici_bytes_per_step(1024, 1024, 2, 4, k=SHARD_K)
    with pytest.raises(ValueError):
        ici_bytes_per_step(1024, 1024, 2, 4, mode="blocked")


# -- (f) refusals -------------------------------------------------------------

@pytest.mark.parametrize("al,elastic,item", [(False, False, "11a"),
                                             (False, True, "11b"),
                                             (True, False, "11c")])
def test_refuses_gp_families(tmp_path, al, elastic, item):
    from gapflow_torch.validate import GP_CASES
    gp = GP_CASES["pressure"]
    if not al:
        gp = gp.replace("max_steps: 2", "max_steps: 2, active_learning: False")
    text = gp_yaml(16, 16, gp=gp, out=str(tmp_path / "out"),
                   dtool_path=str(tmp_path / "db"))
    if elastic:
        text = text.replace("C2: 1.23", "C2: 1.23, " + EHL_ELASTIC)
    p = TProblem.from_string(text, device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        p.run_steps_sharded(1, cpu_mesh((2, 2)))


def test_refuses_adaptive_elastic():
    p = port(sim(adaptive=1, props=EHL), torch.float64)
    with pytest.raises(NotImplementedError, match="item 11b"):
        p.run_steps_sharded(1, cpu_mesh((2, 2)))


def test_refuses_a_grid_that_does_not_divide_the_mesh():
    p = port(sim(), torch.float64)
    with pytest.raises(RuntimeError, match="divide"):
        p.run_steps_sharded(1, cpu_mesh((3, 1)))
    with pytest.raises(ValueError, match="divide"):
        pad_blocks(p.q, 3, 1)
    assert p.step == 0


def test_refuses_a_cuda_mesh_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        grid_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        Mesh(["cuda"] * 4, (2, 2))
    p = port(sim(), torch.float64)
    with pytest.raises(RuntimeError, match="is_available"):
        p.run_steps_sharded(1)


def test_kernel_route_refuses_thinning():
    p = port(sim(EDGES_XDN, props=", thinning: {name: Eyring, tauE: 5.e5}"),
             torch.float64)
    with pytest.raises(ValueError, match="thinning"):
        p.run_steps_sharded(1, cpu_mesh((2, 2)), use_pallas=True)
    with pytest.raises(NotImplementedError, match="thinning"):
        p.run_steps_sharded(1, cpu_mesh((2, 2)), use_pallas=False)


def test_grid_mesh_default_shape():
    assert grid_mesh(["cpu"] * 8).shape == {"x": 2, "y": 4}
    assert grid_mesh(["cpu"] * 6).shape == {"x": 2, "y": 3}
    assert grid_mesh(["cpu"] * 7).shape == {"x": 1, "y": 7}
    assert grid_mesh(["cpu"] * 4, shape=(4, 1)).shape == {"x": 4, "y": 1}
