"""The port's EHL slice agrees with the JAX package's (CPU).

- K8's plain twins (``ops.stencil.ehl_step``, ``ehl_comp_step`` on CPU
  tensors) against the JAX Pallas kernels ``_kernel_fused_ehl`` and
  ``_kernel_fused_ehl6`` in interpret mode, 32 x 128 with ``bs=16``,
  float32, within 1e-5 component-scaled, on a journal deformed by a
  field drawn on the whole ghost-inclusive grid, so that the gap's ghost
  ring is no wrap of its interior (the boundary patches matter);
- the twins on (h_und, u, shift_ref), the inputs of the kernel that
  forms the gap itself, bit for bit against the step on the statics the
  loop formed before (``ehl_patches`` of the shifted gap), at float32
  and float64, and ``make_ehl_loop``'s kernel route against that loop
  over 5 steps, q and the deformation;
- the EHL loops at float64 after 20 steps within 1e-10 scaled:
  ``make_ehl_loop`` (plain route), ``make_gp_ehl_loop`` deterministic
  and with frozen synthetic surrogates, ``_run_steps_ehl_pass2`` and
  the adaptive loops (dt and simulated time to rtol 1e-12); the kernel
  routes of ``make_ehl_loop`` on their twins against the route with
  the statics outside the kernel;

GP surrogates on the mock oracle with elastic coupling, adaptive dt with
frozen surrogates, ``Problem.run()``'s routes and the refusals that
remain: tests/test_torch_ehl_gp.py.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gapflow_tpu import Problem as JProblem
from gapflow_tpu.core import ehl as jehl
from gapflow_tpu.validate import synthetic_gp_state as j_synthetic_gp_state

from gapflow_torch import Problem
from gapflow_torch.core import ehl
from gapflow_torch.core.step import apply_bcs
from gapflow_torch.ops import stencil as S
from gapflow_torch.validate import (kernel_vs_plain_err, perturbed_q,
                                    synthetic_gp_state)

F32, F64 = torch.float32, torch.float64

ELASTIC = "elastic: {{E: 5e9, v: 0.3, alpha_underrelax: {alpha}}}"


def sim(nx, ny, edges="", alpha="1e-3", adaptive=0, silent="True",
        out="data/torch_ehl", dt="5e-11", max_it=100000, write_freq=1000):
    edges = ", " + edges if edges else ""
    return (f"options: {{output: {out}, write_freq: {write_freq}, "
            f"silent: {silent}, use_tstamp: False}}\n"
            f"grid: {{dx: 2.e-5, dy: 2.e-5, Nx: {nx}, Ny: {ny}{edges}}}\n"
            "geometry: {type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, "
            "V: 0.05}\n"
            f"numerics: {{CFL: 0.25, adaptive: {adaptive}, tol: 1e-30, "
            f"dt: {dt}, max_it: {max_it}}}\n"
            "properties: {shear: 0.0794, bulk: 0., EOS: DH, P0: 101325., "
            "rho0: 877.7007, C1: 3.5e10, C2: 1.23, "
            + ELASTIC.format(alpha=alpha) + "}\n")


DN_X = ("xE: ['D', 'N', 'N'], xW: ['D', 'N', 'N'], xE_D: 877.7007, "
        "xW_D: 877.7007")


def pair(text, dtype=F64, amp=1e-3):
    """(JAX Problem, port Problem) after _pre_run, on one perturbed state
    (ghost cells refilled from the perturbed interior)."""
    with contextlib.redirect_stdout(io.StringIO()):
        jp = JProblem.from_string(text)
        tp = Problem.from_string(text, device="cpu", dtype=dtype)
        q = apply_bcs(torch.as_tensor(perturbed_q(jp.q, seed=0, amp=amp)),
                      tp._solver_cfg).numpy()
        jp.q[...] = q
        tp.q[...] = q
        jp._pre_run()
        tp._pre_run()
    return jp, tp


def scaled(a, b):
    return kernel_vs_plain_err(torch.as_tensor(np.array(a, np.float64)),
                               torch.as_tensor(np.array(b, np.float64)))


def u_err(a, b):
    """Max abs difference over max|b| (absolute where b is zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1.))


# ---------------------------------------------------------------------------
# K8 twins vs the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k8_case():
    """32 x 128 journal (f32 values), u ~ 1e-9 N(0, 1) (numpy seed 3),
    and the JAX Pallas EHL steps in interpret mode, bs = 16."""
    from jax.experimental.pallas import tpu as pltpu
    from gapflow_tpu.ops import stencil as js
    jp, tp = pair(sim(32, 128), amp=1e-2)
    rng = np.random.default_rng(3)
    u = (rng.standard_normal((34, 130)) * 1e-9).astype(np.float32)
    h_und = np.asarray(jp.topo.h_undeformed, np.float32)
    extra = np.asarray(jp.fc.get_real_field("extra").p, np.float32)
    q0 = np.asarray(jp.q, np.float32)
    cfg_j = jp._solver_cfg
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for f in (js.make_pallas_ehl_step, js.make_pallas_ehl_loop_step,
                  js._make_call):
            f.cache_clear()
        for d in (False, True):
            step = js.make_pallas_ehl_step(cfg_j, 32, 128, bs=16,
                                           emit_delta=d)
            out[d] = np.asarray(step(jnp.asarray(q0), jnp.asarray(u),
                                     jnp.asarray(h_und), jnp.asarray(extra),
                                     jnp.float32(jp.dt)))
        hf = jnp.asarray(h_und) + jnp.asarray(u)
        rdx2, rdy2 = 0.5 / cfg_j.dx, 0.5 / cfg_j.dy
        H = js.HALO_X
        px = jnp.stack([(hf[2, 1:-1] - hf[0, 1:-1]) * rdx2,
                        (hf[-1, 1:-1] - hf[-3, 1:-1]) * rdx2])

        def wrapv(v):
            return jnp.concatenate([v[-H:], v, v[:H]], 0)

        py = jnp.stack([wrapv((hf[1:-1, 2] - hf[1:-1, 0]) * rdy2),
                        wrapv((hf[1:-1, -1] - hf[1:-1, -3]) * rdy2)], axis=1)
        step6 = js.make_pallas_ehl_loop_step(cfg_j, 32, 128, bs=16)
        q6 = jnp.concatenate([jnp.asarray(q0)[:, 1:-1, 1:-1],
                              jnp.zeros((3, 32, 128), jnp.float32)], 0)
        for _ in range(4):
            q6 = step6(q6, hf[1:-1, 1:-1], jnp.asarray(extra)[0, 1:-1, 1:-1],
                       px, py, jnp.float32(jp.dt))
        out["q6"] = np.asarray(q6)
        for f in (js.make_pallas_ehl_step, js.make_pallas_ehl_loop_step,
                  js._make_call):
            f.cache_clear()
    return tp, q0, u, h_und, extra, out


@pytest.mark.parametrize("emit_delta", [False, True])
def test_ehl_step_twin_matches_jax_pallas(k8_case, emit_delta):
    tp, q0, u, h_und, extra, out = k8_case
    cfg = tp._solver_cfg
    step = S.make_pallas_ehl_step(cfg, 32, 128, emit_delta=emit_delta)
    S.reset_launches()
    got = step(torch.as_tensor(q0), torch.as_tensor(u),
               torch.as_tensor(h_und), torch.as_tensor(extra), tp.dt)
    assert S.LAUNCHES["ehl_step"] == 0          # the twin counts nothing
    assert got.dtype == F32
    assert scaled(got, out[emit_delta]) < 1e-5


def test_ehl_comp_step_twin_matches_jax_pallas(k8_case):
    tp, q0, u, h_und, extra, out = k8_case
    cfg = tp._solver_cfg
    step6 = S.make_pallas_ehl_loop_step(cfg, 32, 128)
    q6 = torch.cat([torch.as_tensor(q0)[:, 1:-1, 1:-1],
                    torch.zeros((3, 32, 128))])
    for _ in range(4):
        q6 = step6(q6, torch.as_tensor(h_und), torch.as_tensor(u),
                   torch.as_tensor(extra)[0, 1:-1, 1:-1].contiguous(),
                   tp.dt)
    assert scaled(q6[:3], out["q6"][:3]) < 1e-5
    # the Kahan carry is a rounding residue: hold it to the state's scale
    assert np.abs(q6[3:].numpy() - out["q6"][3:]).max() <= \
        1e-6 * np.abs(out["q6"][:3]).max()


def test_ehl_statics_are_the_gradient_of_the_ghosted_gap(k8_case):
    """The in-kernel statics equal precompute_statics of the topography
    the plain loop builds (np.gradient over the ghost-inclusive gap),
    interior rows/columns next to the ghost ring included."""
    from gapflow_torch.models.closures_opt import precompute_statics
    tp, _, u, h_und, extra, _ = k8_case
    cfg = tp._solver_cfg
    hf = torch.as_tensor(h_und, dtype=F64) + torch.as_tensor(u, dtype=F64)
    ex = torch.as_tensor(extra, dtype=F64)
    px, py = S.ehl_patches(hf, cfg)
    st = S.ehl_statics_ref(hf[1:-1, 1:-1].clone(), ex[0, 1:-1, 1:-1], px, py,
                           cfg)
    topo = ehl._topo_from_deformation(torch.as_tensor(h_und, dtype=F64),
                                      torch.as_tensor(u, dtype=F64), cfg.dx,
                                      cfg.dy)
    ref = precompute_statics(topo[:3], ex)[:, 1:-1, 1:-1]
    np.testing.assert_allclose(st.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12 * float(ref[:2].abs().max()))
    # the patches differ from a wrap of the interior here
    wrap = (hf[1, 1:-1] - hf[-2, 1:-1]) * (0.5 / cfg.dx)
    assert float((px[0] - wrap).abs().max()) > 1e-3 * float(px.abs().max())


def test_ehl_bitexact_identity_on_the_twins():
    from gapflow_torch.validate import ehl_kernel_bitexact
    r = ehl_kernel_bitexact(n_steps=3, nx=24, ny=16, device="cpu")
    assert r["ok"] and r["q_maxdiff"] == 0. and r["lo_maxdiff"] == 0.


def _patch_form(h_und, u, ls, cfg, shift_ref):
    """The statics as the loop formed them before K8 read the gap itself:
    ``u_eff``, the gap, :func:`ehl_patches` and the interior gap, torch
    op by torch op, into :func:`ehl_statics_ref`."""
    u_eff = u - u[0, 0] if shift_ref else u
    px, py = S.ehl_patches(h_und + u_eff, cfg)
    h_int = h_und[1:-1, 1:-1] + u_eff[1:-1, 1:-1]
    return S.ehl_statics_ref(h_int, ls, px, py, cfg)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("shift_ref", [False, True])
def test_ehl_twins_equal_the_patch_form(k8_case, shift_ref, dtype):
    """The twins on (h_und, u, shift_ref) equal the step on the statics of
    the patch form bit for bit: the plain step, the increment and the
    compensated step, on a gap whose ghost ring is no wrap of its
    interior."""
    tp, q0, u, h_und, extra, _ = k8_case
    cfg = tp._solver_cfg
    q = torch.as_tensor(q0, dtype=dtype)[:, 1:-1, 1:-1]
    hu = torch.as_tensor(h_und, dtype=dtype)
    uu = torch.as_tensor(u, dtype=dtype) + 3e-9   # the shift matters
    ls = torch.as_tensor(extra, dtype=dtype)[0, 1:-1, 1:-1]
    st = _patch_form(hu, uu, ls, cfg, shift_ref)
    lo = (torch.rand(q.shape, generator=torch.Generator().manual_seed(3),
                     dtype=dtype) - 0.5) * 1e-5 * q.abs()
    for d in (False, True):
        assert torch.equal(S.ehl_step_ref(q, hu, uu, ls, tp.dt, cfg, d,
                                          shift_ref),
                           S.fused_step_ref(q, st, tp.dt, cfg, d))
    qk, lk = S.ehl_comp_step_ref(q, lo, hu, uu, ls, tp.dt, cfg, shift_ref)
    qr, lr = S._kahan(q, lo, S.fused_step_ref(q, st, tp.dt, cfg, True))
    assert torch.equal(qk, qr) and torch.equal(lk, lr)
    if shift_ref:           # the shift moves the gap
        assert not torch.equal(st, _patch_form(hu, uu, ls, cfg, False))


def test_ehl_step_takes_its_twin_on_the_cpu(k8_case):
    tp, q0, u, h_und, extra, _ = k8_case
    cfg = tp._solver_cfg
    q = torch.as_tensor(q0)[:, 1:-1, 1:-1]
    hu, uu = torch.as_tensor(h_und), torch.as_tensor(u)
    ls = torch.as_tensor(extra)[0, 1:-1, 1:-1]
    S.reset_launches()
    for shift in (False, True):
        assert torch.equal(S.ehl_step(q, hu, uu, ls, tp.dt, cfg,
                                      shift_ref=shift),
                           S.ehl_step_ref(q, hu, uu, ls, tp.dt, cfg,
                                          shift_ref=shift))
        lo = torch.zeros_like(q)
        for a, b in zip(S.ehl_comp_step(q, lo, hu, uu, ls, tp.dt, cfg, shift),
                        S.ehl_comp_step_ref(q, lo, hu, uu, ls, tp.dt, cfg,
                                            shift)):
            assert torch.equal(a, b)
    assert sum(S.LAUNCHES.values()) == 0


@pytest.mark.parametrize("shift_ref", [False, True])
def test_ehl_kernel_loop_equals_the_patch_form_loop(monkeypatch, shift_ref):
    """``make_ehl_loop``'s K8 route (float32, the compensated interior
    carry; its twins on the CPU) equals the loop that formed the gap and
    its patches in torch every step, bit for bit, q and the deformation,
    with and without the reference shift."""
    from gapflow_torch.core.gp_step import _wrap_pad
    from gapflow_torch.models.eos import eos_pressure
    _, tp = pair(sim(24, 16))
    hs_deform, alpha, _ = ehl._elastic(tp)
    monkeypatch.setattr(ehl, "_elastic",
                        lambda p: (hs_deform, alpha, shift_ref))
    cfg = tp._solver_cfg
    rng = np.random.default_rng(9)
    u0 = torch.as_tensor(rng.standard_normal((26, 18)) * 1e-9, dtype=F32)
    q = torch.as_tensor(tp.q)
    qk, uk = ehl.make_ehl_loop(tp, use_pallas=True)(q, u0, tp.dt, 5)

    h_und = torch.as_tensor(tp.topo.h_undeformed, dtype=F32)
    ls = torch.as_tensor(tp.fc.get_real_field("extra").p, dtype=F32)[0,
                                                                      1:-1,
                                                                      1:-1]
    q_int = q.to(F32)[:, 1:-1, 1:-1]
    lo = torch.zeros_like(q_int)
    u = u0
    for _ in range(5):
        st = _patch_form(h_und, u, ls, cfg, shift_ref)
        q_int, lo = S._kahan(q_int, lo, S.fused_step_ref(q_int, st, tp.dt,
                                                         cfg, True))
        p = _wrap_pad(eos_pressure(q_int[0], cfg.prop))
        u = (1. - alpha) * u + alpha * hs_deform(p.to(u.dtype))
    assert torch.equal(qk[:, 1:-1, 1:-1], q_int)
    assert torch.equal(uk, u)


# ---------------------------------------------------------------------------
# Loops vs the JAX package at float64
# ---------------------------------------------------------------------------

N = 20


@pytest.mark.parametrize("edges", ["", DN_X])
def test_make_ehl_loop_plain_matches_jax(edges):
    jp, tp = pair(sim(24, 16, edges))
    u0 = np.zeros(np.asarray(jp.topo.deformation).shape)
    qj, uj = jehl.make_ehl_loop(jp, use_pallas=False)(jp.q, u0, jp.dt, N)
    qt, ut = ehl.make_ehl_loop(tp, use_pallas=False)(
        torch.as_tensor(tp.q), torch.as_tensor(u0), tp.dt, N)
    assert qt.dtype == F64
    assert scaled(qt, qj) < 1e-10
    assert u_err(ut, uj) < 1e-10
    # K = 2: the compounded relaxation factor
    qj, uj = jehl.make_ehl_loop(jp, use_pallas=False, deform_every=2)(
        jp.q, u0, jp.dt, N)
    qt, ut = ehl.make_ehl_loop(tp, use_pallas=False, deform_every=2)(
        torch.as_tensor(tp.q), torch.as_tensor(u0), tp.dt, N)
    assert scaled(qt, qj) < 1e-10 and u_err(ut, uj) < 1e-10


def test_make_ehl_loop_kernel_routes_on_their_twins():
    """On CPU tensors the kernel routes run the twins.  In float64 the
    statics-in-kernel step (K8's plain form) equals the route with the
    statics outside the kernel (K1 twin) to rounding; the float32
    compensated interior-carry loop (the K8 main path) and the K = 2
    compensated chunk loop track a float64 run at least as closely as the
    plain float32 loop does."""
    _, tp = pair(sim(32, 24))
    u0 = torch.zeros(tp.topo.deformation.shape, dtype=F64)
    q = torch.as_tensor(tp.q)
    qk, uk = ehl.make_ehl_loop(tp, use_pallas=True, dtype=F64)(q, u0, tp.dt,
                                                                N)
    qo, uo = ehl.make_ehl_loop(tp, use_pallas=True, dtype=F64,
                               statics_in_kernel=False)(q, u0, tp.dt, N)
    assert scaled(qk, qo) < 1e-12 and u_err(uk, uo) < 1e-10
    q64, _ = ehl.make_ehl_loop(tp, use_pallas=False)(q, u0, tp.dt, N)
    assert scaled(qk, q64) < 5e-6          # the wrap/ghost statics convention
    q32, u32 = ehl.make_ehl_loop(tp, use_pallas=False, dtype=F32)(
        q, u0, tp.dt, N)
    err_plain = scaled(q32, q64)
    qc, uc = ehl.make_ehl_loop(tp, use_pallas=True)(q, u0, tp.dt, N)
    assert qc.dtype == F32 and uc.dtype == F32
    assert scaled(qc, q64) < err_plain * 1.05
    q2, _ = ehl.make_ehl_loop(tp, use_pallas=True, deform_every=2)(
        q, u0, tp.dt, N)
    q64, _ = ehl.make_ehl_loop(tp, use_pallas=False, deform_every=2)(
        q, u0, tp.dt, N)
    q32, _ = ehl.make_ehl_loop(tp, use_pallas=False, deform_every=2,
                               dtype=F32)(q, u0, tp.dt, N)
    assert scaled(q2, q64) < scaled(q32, q64) * 1.05
    # the K8 main path is what run_steps_ehl drives on CUDA; on CPU the
    # auto route is the plain step
    assert ehl.make_ehl_loop(tp)(q, u0, tp.dt, 1)[0].dtype == F64


def j_gp_state(dims, use, cap, seed=0):
    """The same synthetic frozen surrogates for both packages, float64."""
    js = j_synthetic_gp_state(dims, use, cap, np.random.default_rng(seed))
    ts = synthetic_gp_state(dims, use, cap, np.random.default_rng(seed),
                            dtype=F64)
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), js), ts


DIMS = ((0, 3), (0, 1, 3), (0, 2, 3))
NONE = (None, None, None)

#: The adaptive cases run the LJ line contact of the JAX package's
#: tests/test_adaptive_device.py (BWR, D/N x edges, a free half-space):
#: on the DH journal the EOS's r - 1 cancellation turns the two
#: frameworks' last-bit differences into 1e-11 of dt within 20 steps.
LJ = """
options: {{output: {out}, write_freq: 1000, use_tstamp: False, silent: True}}
grid: {{Lx: 1470., Ly: 1., Nx: 100, Ny: 1, xE: ['D', 'N', 'N'],
        xW: ['D', 'N', 'N'], xE_D: 0.8, xW_D: 0.8}}
geometry: {{type: parabolic, hmin: 12., hmax: 60., U: 0.12, V: 0.}}
numerics: {{CFL: 0.4, adaptive: {adaptive}, tol: 1e-30, dt: 0.02,
           max_it: {max_it}}}
properties: {{shear: 2.15, bulk: 0., EOS: BWR, T: 1.0, rho0: 0.8{elastic}}}
"""
LJ_GP = """gp:
    press: {{fix_noise: True, atol: 1.e-3, rtol: 0., obs_stddev: 2.e-2,
            max_steps: 2, active_learning: {al}}}
    shear: {{fix_noise: True, atol: 1.e-3, rtol: 0., obs_stddev: 4.e-3,
            max_steps: 2, active_learning: {al}}}
db: {{init_size: 4, init_method: lhc, dtool_path: {out}/train}}
"""


def lj_sim(out="data/torch_ehl_lj", adaptive=1, elastic=True, al=None,
           max_it=100):
    el = (", elastic: {E: 100., v: 0.3, alpha_underrelax: 1e-02}"
          if elastic else "")
    text = LJ.format(out=out, adaptive=adaptive, max_it=max_it, elastic=el)
    return text + (LJ_GP.format(al=al, out=out) if al is not None else "")


@pytest.mark.parametrize("case", ["det", "det_dn", "gp", "gp_k2",
                                  "det_adaptive"])
def test_make_gp_ehl_loop_matches_jax(case):
    if case == "det_adaptive":
        with pytest.warns(UserWarning, match="line contact"):
            jp, tp = pair(lj_sim())
    else:
        jp, tp = pair(sim(24, 16, DN_X if case == "det_dn" else ""))
    if case.startswith("gp"):
        dims, use = DIMS, (True, True, True)
        gj, gt = j_gp_state(dims, use, 16)
    else:
        dims, use = NONE, (False, False, False)
        gj = {"Xscale": jnp.ones((7,))}
        gt = {"Xscale": torch.ones(7, dtype=F64)}
    K = 2 if case == "gp_k2" else 1
    adaptive = case == "det_adaptive"
    u0 = np.zeros(np.asarray(jp.topo.deformation).shape)
    lj = jehl.make_gp_ehl_loop(jp, dims, 7, use, deform_every=K,
                               adaptive=adaptive)
    lt = ehl.make_gp_ehl_loop(tp, dims, 7, use, deform_every=K,
                              adaptive=adaptive)
    oj = lj(jp.q, u0, jp.topo.full, jp.dt, jnp.asarray(0, jnp.int32), N, gj)
    ot = lt(torch.as_tensor(tp.q), torch.as_tensor(u0),
            torch.as_tensor(tp.topo.full), tp.dt, 0, N, gt)
    assert scaled(ot[0], oj[0]) < 1e-10
    assert u_err(ot[1], oj[1]) < 1e-10
    if adaptive:
        assert float(ot[2]) != jp.dt
        np.testing.assert_allclose(float(ot[2]), float(oj[2]), rtol=1e-12)
        np.testing.assert_allclose(float(ot[3]), float(oj[3]), rtol=1e-12)


@pytest.mark.parametrize("edges,adaptive", [(DN_X, 0), ("lj", 1)])
def test_pass2_route_matches_jax(edges, adaptive):
    """``_run_steps_ehl_pass2`` (the run() route), twice in a row: the
    state, the deformation state, the synced topography and fields, dt
    and the simulated time."""
    if edges == "lj":
        with pytest.warns(UserWarning, match="line contact"):
            jp, tp = pair(lj_sim())
    else:
        jp, tp = pair(sim(24, 16, edges))
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(2):
            jp._run_steps_ehl_pass2(N // 2)
            tp._run_steps_ehl_pass2(N // 2)
    assert tp.step == jp.step == N
    assert scaled(tp.q, jp.q) < 1e-10
    assert u_err(tp.topo.ElasticDeformation.u_prev,
                 jp.topo.ElasticDeformation.u_prev) < 1e-10
    for c in range(4):
        assert u_err(tp.topo.full[c], np.asarray(jp.topo.full)[c]) < 1e-10
    assert u_err(tp.pressure.pressure, jp.pressure.pressure) < 1e-10
    np.testing.assert_allclose(tp.dt, jp.dt, rtol=1e-12)
    np.testing.assert_allclose(tp.simtime, jp.simtime, rtol=1e-12)


def test_run_steps_ehl_matches_jax_and_syncs():
    jp, tp = pair(sim(24, 16))
    jp.run_steps_ehl(N)
    tp.run_steps_ehl(N)
    assert tp.step == N and tp.simtime == pytest.approx(N * tp.dt)
    assert scaled(tp.q, jp.q) < 1e-10
    np.testing.assert_allclose(tp.topo.h, tp.topo.h_undeformed
                               + tp.topo.deformation, rtol=1e-15)
    assert u_err(tp.topo.deformation, np.asarray(jp.topo.deformation)) \
        < 1e-10
    assert u_err(tp.pressure.pressure, jp.pressure.pressure) < 1e-10
    tp.update()                              # host steps continue from it
    assert np.isfinite(tp.q).all() and tp.step == N + 1
