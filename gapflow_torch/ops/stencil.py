"""Fused MacCormack steps: CUDA kernels, their plain twins, drivers.

Counterpart of :mod:`gapflow_tpu.ops.stencil`.  Thirteen kernels, in
``csrc/stencil.cu`` (periodic), ``csrc/stencil_plain.cu`` (the plain
periodic loop), ``csrc/stencil_bc.cu`` (boundary),
``csrc/stencil_ehl.cu`` (periodic, statics from the deformed gap) and
``csrc/stencil_shard.cu`` (one shard of a sharded run):

- :func:`fused_step` (replaces ``_kernel_fused``): one periodic step on
  the interior ``(3, nx, ny)`` state, returning the new state;
- :func:`comp_steps` (replaces ``_kernel_fused_hbm_loop`` with
  ``_advance_comp``): ``n`` Kahan-compensated periodic steps on the
  ``(q, q_lo)`` carry in one C call, sweeps of :func:`_comp_k_steps`
  steps temporally blocked on chip and one sweep of the remainder,
  ping-ponging two buffer pairs;
- :func:`comp_step_once`: one compensated periodic step, the witness
  that :func:`comp_steps` equals ``n`` launches of it bit for bit (on
  no main path);
- :func:`plain_sweeps` (replaces ``_kernel_fused_hbm_loop`` with
  ``_advance_plain`` and, for the remainder, ``_kernel_fused_ext``): ``n``
  plain periodic steps in one C call, sweeps of :func:`_plain_k_steps`
  steps, each tile advanced that many steps on chip with each cell's
  values in registers (temporal blocking), and one sweep of the
  remainder; :func:`plain_steps` is one such sweep of ``k <= K_MULTI``
  steps;
- :func:`plain_run` (replaces ``_kernel_fused_vmem``): a whole plain
  periodic run of ``n`` steps in one cooperative launch, the state
  ping-ponging between two buffers that stay in L2 where they fit
  (:func:`_plain_run_fits`);
- :func:`fused_step_bc` (replaces ``_kernel_fused_bc``): one step on
  Dirichlet/Neumann edges, with shear thinning on any edges, the ghosts
  built from the interior by the edge formulas and refilled between the
  passes;
- :func:`comp_steps_bc` (replaces ``_kernel_fused_bc_hbm``, ``nch = 6``):
  its compensated form, ``n`` steps in one C call, sweeps of
  :func:`_comp_k_steps` steps and one of the remainder, the ghosts
  refilled in the block after every pass and average;
- :func:`comp_step_bc_once`: one compensated boundary step, the witness
  of :func:`comp_steps_bc` (on no main path);
- :func:`plain_sweeps_bc` (replaces ``_kernel_fused_bc_hbm``, ``nch =
  3``): its boundary form, ``n`` steps in one C call, the ghosts refilled
  after every pass and average; :func:`plain_steps_bc` is one sweep of
  ``k <= _k_steps(cfg)`` steps;
- :func:`ehl_step` (replaces ``_kernel_fused_ehl``) and
  :func:`ehl_comp_step` (replaces ``_kernel_fused_ehl6``): K1's step and
  the compensated step on the interior ``(q, q_lo)`` carry, on the
  register sweep body one step deep, with the statics formed in-kernel
  from the ghost-inclusive undeformed gap and deformation (the gap
  :func:`ehl_gap`, its slopes over ghost-inclusive neighbours) and the
  slip length (the EHL loop deforms the gap every step, so its statics
  cannot be hoisted);
- :func:`shard_sweep` (replaces ``_kernel_fused_bc_shard`` on the
  sharded loops of :mod:`gapflow_torch.parallel`): ``k`` steps of one
  shard's block with a ``2k``-deep halo in one launch, the ghost ring of
  each domain edge the shard holds refilled in the sweep, gated on the
  shard's edge flags; :func:`shard_step`, one step of a block with a
  2-deep halo, is its witness (:func:`shard_steps_once`).

The mixed-edge kernel (``_kernel_fused_bc_mixed``) and its driver are in
:mod:`gapflow_torch.ops.mixed_bc`.

Beside each kernel is its plain torch twin (``*_ref``), which mirrors
``_one_pass_fused`` with ``torch.roll``: on the periodic interior, or on
the ghost-inclusive layout with the ghosts refilled by ``apply_bcs``
between the passes and shear thinning from ``torch.gradient`` of the
ghost-inclusive pressure (``core.step.effective_viscosity``).  A wrapper
takes the twin only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.  Every launch adds one to its entry in
:data:`LAUNCHES`.

Coverage (:func:`pallas_supported`): a static pass order
(``MC_order != 0``) and edges that are each fully periodic or have no
periodic component, with every EOS, piezoviscosity and shear-thinning
model.  Fully periodic edges without thinning take K1/K2 and the plain
periodic kernels, everything else K3 and its plain sweeps.  Mixed
per-component edges: :func:`ops.mixed_bc.mixed_supported`.
"""

import functools
import inspect
import math

import numpy as np
import torch

from . import _build
from ..core.step import apply_bcs, effective_viscosity, mc_directions
from ..models.closures_opt import (N_STATIC, fused_pass_top_pre,
                                   precompute_statics)
from ..models.eos import _PRESSURE, _bwr_terms, eos_pressure, true_div
from ..models.viscosity import _PIEZO, _THINNING

#: The most steps a temporally blocked sweep takes on periodic edges (the
#: JAX package's sweep kernel advances K_MULTI steps per launch); halved
#: by shear thinning (:func:`_k_steps`).  The loops' own depths are the
#: measured :func:`_plain_k_steps` and :func:`_comp_k_steps`.
K_MULTI = 4

#: Halo cells a side one step of the shard kernels consumes: a k-step
#: shard sweep takes a block with a ``HALO_SHARD * k``-deep halo.
HALO_SHARD = 2

#: Kernel launches per wrapper since the last reset (the plain twins
#: count nothing).  ``mixed_step`` counts :func:`ops.mixed_bc.mixed_step`;
#: :func:`plain_sweeps` and :func:`plain_steps` count a sweep of
#: :func:`_plain_k_steps` steps as ``plain_steps`` and one of any other
#: depth (the remainder) as ``plain_steps_rem``; :func:`plain_sweeps_bc` and
#: :func:`plain_steps_bc` count every sweep as ``plain_steps_bc``;
#: :func:`comp_steps` and
#: :func:`comp_steps_bc` count every launch of their C call, the
#: remainder sweep included, as ``comp_sweep`` and ``comp_sweep_bc``;
#: ``comp_step`` and ``comp_step_bc`` count the one-step witnesses;
#: ``shard_sweep`` counts every shard sweep, of any depth.
LAUNCHES = {"fused_step": 0, "comp_step": 0, "comp_sweep": 0,
            "plain_steps": 0, "plain_steps_rem": 0, "plain_run": 0,
            "fused_step_bc": 0, "comp_step_bc": 0, "comp_sweep_bc": 0,
            "plain_steps_bc": 0, "mixed_step": 0, "ehl_step": 0,
            "ehl_comp_step": 0, "shard_step": 0, "shard_sweep": 0}

#: L2 cache of an H100 (bytes), the size :func:`_plain_run_fits` assumes
#: for a tensor on the CPU; on a CUDA device the device's own is read.
H100_L2_BYTES = 50 * 2 ** 20


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fully_periodic(cfg):
    return all(all(dict(cfg.bc[i])["P"]) for i in range(4))


def _edge_mixed(cfg, i):
    """Edge ``i`` has periodic and non-periodic components."""
    P = cfg.bc_edge(i)["P"]
    return any(P) and not all(P)


def _edges_uniform(cfg):
    """Every edge is either fully periodic or has no periodic component.

    Mixed P/D components on one edge keep the serial quirk of leaving the
    periodic component's ghost stale; those run through
    :mod:`ops.mixed_bc`, which carries the ghosts as state.
    """
    return not any(_edge_mixed(cfg, i) for i in range(4))


def pallas_supported(cfg):
    """Whether the fused kernels cover ``cfg``: a static pass order and
    per-edge uniform edges (fully periodic, or Dirichlet/Neumann per
    component), with any EOS, piezoviscosity and shear thinning.  Unlike
    the TPU kernels the grid width needs no alignment."""
    return cfg.MC_order != 0 and _edges_uniform(cfg)


def _periodic_kernel_ok(cfg):
    """K1/K2's coverage: fully periodic edges and no shear thinning."""
    return pallas_supported(cfg) and cfg.thinning is None \
        and _fully_periodic(cfg)


def _k_steps(cfg):
    """The most steps a temporally blocked sweep takes: the TPU kernel's
    depth, halved by shear thinning (its viscosity reads the pressure at
    +-1, tripling the halo each step consumes)."""
    return K_MULTI // 2 if cfg.thinning is not None else K_MULTI


def _plain_k_steps(cfg):
    """Steps per sweep of the plain loop (:func:`plain_sweeps`,
    :func:`plain_sweeps_bc`), the fastest depth timed at 1024² on the
    H100 (``tests/comp_sweep_bench.py``, PERF.md): 2 without shear
    thinning, whose 32-column window loses a column a side per step; 1
    with it, which consumes three.  Any depth in ``1.._k_steps(cfg)``
    gives the same result bit for bit."""
    return 1 if cfg.thinning is not None else 2


def _comp_k_steps(cfg):
    """Steps per sweep of the compensated loop (:func:`comp_steps`,
    :func:`comp_steps_bc`), the fastest depth timed at 1024² on the H100
    (``tests/comp_sweep_bench.py``, PERF.md): 3 without shear thinning,
    whose deeper window recomputes more halo than the saved traffic
    pays for; 1 with it, the window of a 32 x 32 tile two steps deep
    leaving one block per SM.  Any depth gives the same result bit for
    bit."""
    return 1 if cfg.thinning is not None else 3


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _one_pass(cfg, q0, q1, q2, st, dt, d, return_upd=False):
    """One one-sided pass (``_one_pass_fused``), on the periodic interior
    or on a ghost-inclusive layout (where the rolls' wrap only reaches
    ghost cells, which the caller refills).  Shear thinning needs the
    ghost-inclusive layout: ``torch.gradient`` is one-sided at its ghost
    rows and columns.  ``return_upd`` returns the update ``u``
    (``q_new = q - u``)."""
    p = eos_pressure(q0, cfg.prop)
    eta = effective_viscosity(cfg, q0, p, st[2])
    if not torch.is_tensor(eta):
        # a constant viscosity held in the state's precision, as the
        # kernels hold it, so that 4/3 eta and 2/3 eta round as theirs do
        # (a Python float rounds them in double, an ulp off the kernels'
        # float32 in rare cells)
        eta = q0.new_tensor(eta)
    tb_xx, tb_yy, tb_xy, S0, S1, S2 = fused_pass_top_pre(
        q0, q1, q2, st, cfg.U, cfg.V, eta, cfg.bulk)

    rdx = 1. / cfg.dx
    rdy = 1. / cfg.dy

    def ddx(F):
        return -d * (torch.roll(F, d, dims=0) - F) * rdx

    def ddy(F):
        return -d * (torch.roll(F, d, dims=1) - F) * rdy

    u0 = dt * (ddx(q1) + ddy(q2) - S0)
    u1 = dt * (ddx(p + tb_xx) + ddy(tb_xy) - S1)
    u2 = dt * (ddx(tb_xy) + ddy(p + tb_yy) - S2)
    if return_upd:
        return u0, u1, u2
    return q0 - u0, q1 - u1, q2 - u2


def _predict_and_update(cfg, q, statics, dt, refill=None):
    """Pass d0 (predictor state, ghosts refilled by ``refill``) and the
    pass-d1 update ``u``."""
    d0, d1 = mc_directions(cfg.MC_order)
    st = tuple(statics)
    pred = _one_pass(cfg, q[0], q[1], q[2], st, dt, d0)
    if refill is not None:
        pred = tuple(refill(torch.stack(pred)))
    u = _one_pass(cfg, *pred, st, dt, d1, return_upd=True)
    return pred, u


def _combine(pred, q, u, emit_delta):
    """The step's new state ``((q* - u) + q) / 2`` or, with
    ``emit_delta``, its increment ``((q* - q) - u) / 2``."""
    if emit_delta:
        return torch.stack([((a - b) - du) / 2.
                            for a, b, du in zip(pred, q, u)])
    return torch.stack([((a - du) + b) / 2. for a, b, du in zip(pred, q, u)])


def _kahan(q, lo, delta):
    """One two-sum of the increment into the ``(q, q_lo)`` carry, in the
    order of ``_advance_comp``."""
    y = delta + lo
    t = q + y
    return t, y - (t - q)


def fused_step_ref(q_int, statics, dt, cfg, emit_delta=False):
    """Plain torch twin of :func:`fused_step`."""
    pred, u = _predict_and_update(cfg, q_int, statics, float(dt))
    return _combine(pred, q_int, u, emit_delta)


def comp_steps_ref(q_int, q_lo, statics, dt, cfg, n):
    """Plain torch twin of :func:`comp_steps`: ``n`` Kahan-compensated
    steps in the order of ``_advance_comp``.  Returns ``(q, q_lo)``."""
    dt = float(dt)
    for _ in range(n):
        pred, u = _predict_and_update(cfg, q_int, statics, dt)
        q_int, q_lo = _kahan(q_int, q_lo, _combine(pred, q_int, u, True))
    return q_int, q_lo


def plain_steps_ref(q_int, statics, dt, cfg, k):
    """Plain torch twin of :func:`plain_steps`: ``k`` steps of
    :func:`fused_step_ref`."""
    for _ in range(k):
        q_int = fused_step_ref(q_int, statics, dt, cfg)
    return q_int


def plain_run_ref(q_int, statics, dt, cfg, n):
    """Plain torch twin of :func:`plain_run`: ``n`` steps of
    :func:`fused_step_ref`."""
    return plain_steps_ref(q_int, statics, dt, cfg, n)


def with_ghosts(q_int, cfg):
    """Interior (3, nx, ny) -> ghost-inclusive, ghosts from the edge
    formulas (``apply_bcs``: x edges, then y edges)."""
    q = q_int.new_zeros((3, q_int.shape[1] + 2, q_int.shape[2] + 2))
    q[:, 1:-1, 1:-1] = q_int
    return apply_bcs(q, cfg)


def _interior(arrs):
    return [a[1:-1, 1:-1] for a in arrs]


def step_ghosted_ref(q_g, statics_g, dt, cfg, refill, emit_delta=False):
    """One step on the ghost-inclusive state ``q_g``: pass d0, ``refill``
    of the ghosts, pass d1.  Returns the interior new state or
    increment."""
    pred, u = _predict_and_update(cfg, q_g, statics_g, float(dt), refill)
    return _combine(_interior(pred), _interior(q_g), _interior(u),
                    emit_delta)


def fused_step_bc_ref(q_int, statics_g, dt, cfg, emit_delta=False):
    """Plain torch twin of :func:`fused_step_bc`: the ghosts of
    ``q_int`` from the edge formulas, refilled by them between the
    passes (corners take the y fill)."""
    return step_ghosted_ref(with_ghosts(q_int, cfg), statics_g, dt, cfg,
                            lambda q: apply_bcs(q, cfg), emit_delta)


def comp_steps_bc_ref(q_int, q_lo, statics_g, dt, cfg, n):
    """Plain torch twin of :func:`comp_steps_bc`: ``n`` compensated steps
    in the order of ``_kernel_fused_bc_hbm`` (``nch = 6``).  The carry is
    interior; the ghosts are rebuilt from the compensated interior every
    step.  Returns ``(q, q_lo)``."""
    for _ in range(n):
        delta = fused_step_bc_ref(q_int, statics_g, dt, cfg, emit_delta=True)
        q_int, q_lo = _kahan(q_int, q_lo, delta)
    return q_int, q_lo


def plain_steps_bc_ref(q_int, statics_g, dt, cfg, k):
    """Plain torch twin of :func:`plain_steps_bc`: ``k`` steps of
    :func:`fused_step_bc_ref` (the ghosts rebuilt from the interior by
    the edge formulas after every step, as the kernel refills them after
    every average)."""
    for _ in range(k):
        q_int = fused_step_bc_ref(q_int, statics_g, dt, cfg)
    return q_int


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_EOS_CODES = {"DH": 0, "PL": 1, "vdW": 2, "MT": 3, "cubic": 4, "BWR": 5,
              "Bayada": 6}
_PIEZO_CODES = {"Barus": 1, "Roelands": 2, "Dukler": 3, "McAdams": 4}
_N_EOS_PRM = 16
_N_PIEZO_PRM = 8


def _with_defaults(func, given):
    """Keyword arguments of ``func`` from ``given``, else its defaults."""
    out = {}
    for name, par in inspect.signature(func).parameters.items():
        if name in given:
            out[name] = given[name]
        elif par.default is not inspect.Parameter.empty:
            out[name] = par.default
    return out


def _eos_params(prop):
    func, argnames = _PRESSURE[prop["EOS"]]
    k = _with_defaults(func, {a: prop[a] for a in argnames if a in prop})
    name = prop["EOS"]
    if name == "DH":
        return [k["rho0"], k["P0"], k["C1"], k["C2"],
                0.99 * k["C2"] * k["rho0"]]
    if name == "PL":
        return [k["rho0"], k["P0"], 1. / (1. - 0.5 * k["alpha"])]
    if name == "vdW":
        from scipy.constants import gas_constant
        return [k["M"], gas_constant * k["T"], k["a"] / 10., k["b"] / 1000.]
    if name == "MT":
        return [k["rho0"], k["P0"], k["K"] / k["n"], k["n"]]
    if name == "cubic":
        return [k["a"], k["b"], k["c"], k["d"]]
    if name == "BWR":
        poly, expo = _bwr_terms(k["T"], k["gamma"])
        return [*poly, *expo, k["gamma"]]
    # Bayada-Chupin: the density-independent factors of eos.bayada_chupin
    rho_l, rho_v, c_l, c_v = k["rho_l"], k["rho_v"], k["c_l"], k["c_v"]
    N = rho_v * c_v ** 2 * rho_l * c_l ** 2 * (rho_v - rho_l) \
        / (rho_v ** 2 * c_v ** 2 - rho_l ** 2 * c_l ** 2)
    Pcav = rho_v * c_v ** 2 - N * math.log(rho_v ** 2 * c_v ** 2
                                           / (rho_l ** 2 * c_l ** 2))
    return [rho_l, rho_v - rho_l, Pcav, N, c_l ** 2, c_v ** 2,
            rho_v * c_v ** 2, rho_l * c_l ** 2]


def _piezo_params(cfg):
    piezo = dict(cfg.piezo or {})
    code = _PIEZO_CODES.get(piezo.get("name"), 0)
    if code == 0:
        return 0, []
    k = _with_defaults(_PIEZO[piezo["name"]],
                       {a: v for a, v in piezo.items() if a != "name"})
    if code == 1:
        return code, [k["aB"]]
    if code == 2:
        return code, [math.log(cfg.shear / k["mu_inf"]), k["p_ref"], k["z"]]
    return code, [k["eta_v"], k["rho_l"], k["rho_v"] - k["rho_l"],
                  k["rho_v"]]


@functools.lru_cache(maxsize=64)
def _kernel_params(cfg):
    """Host parameter blocks of the kernels for ``cfg``.

    ``iprm`` (int32): EOS code, piezoviscosity code, 1 if the piezo model
    takes density.  ``fprm`` (float32): 1/dx, 1/dy, U, V, shear, bulk, 16
    EOS parameters, 8 piezoviscosity parameters; the layouts per model are
    commented beside each case in ``csrc/stencil.cu``.  Derived constants
    are formed in float64 on the host and rounded once, as the plain twin
    rounds its Python scalars.
    """
    prop = cfg.prop
    piezo_code, zp = _piezo_params(cfg)
    ep = _eos_params(prop)
    iprm = np.array([_EOS_CODES[prop["EOS"]], piezo_code,
                     int(prop["EOS"] == "Bayada")], dtype=np.int32)
    fprm = np.zeros(6 + _N_EOS_PRM + _N_PIEZO_PRM, dtype=np.float32)
    fprm[:6] = [1. / cfg.dx, 1. / cfg.dy, cfg.U, cfg.V, cfg.shear, cfg.bulk]
    fprm[6:6 + len(ep)] = ep
    fprm[6 + _N_EOS_PRM:6 + _N_EOS_PRM + len(zp)] = zp
    return iprm, fprm


_CODES = {"P": 0, "D": 1, "N": 2, "G": 3}
_THIN_CODES = {"Eyring": 1, "Carreau": 2}


@functools.lru_cache(maxsize=64)
def _bc_params(cfg):
    """Host parameter blocks of the boundary kernels (``csrc/stencil_bc.cu``
    ``make_bc``).

    ``bprm`` (int32): per edge (xE, xW, yS, yN) and component the ghost
    code P, D, N, or G for the periodic component of a mixed edge (a
    given ghost line); then the thinning model (0 none, 1 Eyring, 2
    Carreau).  ``bfprm`` (float32): ``2 * val`` per edge (the Dirichlet
    values as ``SolverConfig`` pre-swapped them), ``V - U``, dx, dy, and
    the thinning parameters: tauE; or mu_inf, lam, a, (N - 1)/a.
    """
    bprm = np.zeros(13, dtype=np.int32)
    bfprm = np.zeros(11, dtype=np.float32)
    for e in range(4):
        bc = cfg.bc_edge(e)
        for c in range(3):
            kind = ("G" if _edge_mixed(cfg, e) else "P") if bc["P"][c] else \
                ("D" if bc["D"][c] else "N")
            bprm[3 * e + c] = _CODES[kind]
        bfprm[e] = 2. * bc["val"]
    thin = dict(cfg.thinning or {})
    model = _THIN_CODES.get(thin.get("name"), 0)
    bprm[12] = model
    bfprm[4:7] = [cfg.V - cfg.U, cfg.dx, cfg.dy]
    if model:
        k = _with_defaults(_THINNING[thin["name"]],
                           {a: v for a, v in thin.items() if a != "name"})
        bfprm[7:11 if model == 2 else 8] = (
            [k["tauE"]] if model == 1 else
            [k["mu_inf"], k["lam"], k["a"], (k["N"] - 1.) / k["a"]])
    return bprm, bfprm


def _check_tensors(q, *pairs):
    """Raise unless each (tensor, shape) pair is float32, contiguous, of
    that shape and on ``q``'s device."""
    for t, shape in pairs:
        if t.device != q.device:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"and {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def _check_cuda(q, statics, *more, ghosted=False):
    """Check the kernel inputs; ``ghosted``: the statics are
    ghost-inclusive.  Returns (nx, ny)."""
    _, nx, ny = q.shape
    g = 2 if ghosted else 0
    _check_tensors(q, (q, (3, nx, ny)), (statics, (N_STATIC, nx + g, ny + g)),
                   *((m, (3, nx, ny)) for m in more))
    return nx, ny


def _on_cpu(q):
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return False


def fused_step(q_int, statics, dt, cfg):
    """One fused periodic MacCormack step on the interior state.

    ``q_int``: (3, nx, ny); ``statics``: (8, nx, ny) from
    :func:`interior_statics`.  Returns the new state.  CUDA tensors
    (float32) launch the kernel; CPU tensors run :func:`fused_step_ref`.
    """
    if _on_cpu(q_int):
        return fused_step_ref(q_int, statics, dt, cfg)
    nx, ny = _check_cuda(q_int, statics)
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty_like(q_int)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_fused_step(q_int.data_ptr(), statics.data_ptr(),
                               out.data_ptr(), nx, ny, d0, iprm.ctypes.data,
                               fprm.ctypes.data, float(dt), stream)
    _build.check(lib, rc, "gf_fused_step")
    LAUNCHES["fused_step"] += 1
    return out


def _comp_sweeps(entry, key, q_int, q_lo, statics, dt, cfg, n, k, *bc):
    """Launch ``n >= 1`` compensated steps through the C sweep entry
    ``entry`` (sweeps of ``k`` and one of ``n mod k``) on two fresh
    buffer pairs; ``bc``: the boundary parameter blocks.  The C entry
    refuses a depth outside ``1.._k_steps(cfg)``, and the refusal raises
    here.  Returns ``(q, q_lo)``."""
    _, nx, ny = q_int.shape
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    bufs = torch.empty((2 if n > k else 1, 6, nx, ny), dtype=q_int.dtype,
                       device=q_int.device)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            q_int.data_ptr(), q_lo.data_ptr(), statics.data_ptr(),
            bufs[0].data_ptr(), bufs[-1].data_ptr(), nx, ny, n, k, d0,
            iprm.ctypes.data, fprm.ctypes.data,
            *(b.ctypes.data for b in bc), float(dt), stream)
    _build.check(lib, rc, entry)
    launches = -(-n // k)
    LAUNCHES[key] += launches
    out = bufs[(launches - 1) % 2]
    return out[:3], out[3:]


def comp_steps(q_int, q_lo, statics, dt, cfg, n):
    """``n`` Kahan-compensated periodic steps on the ``(q, q_lo)`` carry.

    One C call: ``n // k`` sweeps of ``k = _comp_k_steps(cfg)`` steps and
    one of ``n mod k``, each a launch that advances every tile that many
    steps on chip, reading one buffer pair and writing the other.  The
    result equals ``n`` launches of :func:`comp_step_once` bit for bit.
    The inputs are not modified.  Returns ``(q, q_lo)``.  CUDA tensors
    (float32) launch the kernel; CPU tensors run :func:`comp_steps_ref`.
    """
    if _on_cpu(q_int):
        return comp_steps_ref(q_int, q_lo, statics, dt, cfg, n)
    _periodic_gate(cfg)
    _check_cuda(q_int, statics, q_lo)
    if n == 0:
        return q_int, q_lo
    return _comp_sweeps("gf_comp_sweeps", "comp_sweep", q_int, q_lo,
                        statics, dt, cfg, n, _comp_k_steps(cfg))


def comp_step_once(q_int, q_lo, statics, dt, cfg):
    """One Kahan-compensated periodic step on the ``(q, q_lo)`` carry, one
    launch of the one-step kernel: the witness that :func:`comp_steps`
    rounds like ``n`` launches of it.  Returns ``(q, q_lo)``.  CUDA
    tensors (float32) launch the kernel; CPU tensors run
    :func:`comp_steps_ref`."""
    if _on_cpu(q_int):
        return comp_steps_ref(q_int, q_lo, statics, dt, cfg, 1)
    nx, ny = _check_cuda(q_int, statics, q_lo)
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty((6, nx, ny), dtype=q_int.dtype, device=q_int.device)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_comp_step(q_int.data_ptr(), q_lo.data_ptr(),
                              statics.data_ptr(), out[:3].data_ptr(),
                              out[3:].data_ptr(), nx, ny, d0,
                              iprm.ctypes.data, fprm.ctypes.data, float(dt),
                              stream)
    _build.check(lib, rc, "gf_comp_step")
    LAUNCHES["comp_step"] += 1
    return out[:3], out[3:]


def _periodic_gate(cfg):
    if not _periodic_kernel_ok(cfg):
        raise ValueError("the periodic kernels require fully periodic "
                         "edges without shear thinning")


def _check_k(k, kmax):
    if not 1 <= k <= kmax:
        raise ValueError(f"steps per launch must lie in [1, {kmax}], "
                         f"got {k}")


def plain_steps(q_int, statics, dt, cfg, k):
    """``k`` (1 to :data:`K_MULTI`) plain periodic steps in one launch.

    Each tile is advanced ``k`` steps on chip (temporal blocking), so the
    state and statics cross device memory once per ``k`` steps; the result
    equals ``k`` launches of :func:`fused_step`.  ``q_int``: (3, nx, ny),
    ``statics``: (8, nx, ny).  Returns the new state.  CUDA tensors
    (float32) launch the kernel; CPU tensors run :func:`plain_steps_ref`.
    """
    if _on_cpu(q_int):
        return plain_steps_ref(q_int, statics, dt, cfg, k)
    _periodic_gate(cfg)
    _check_k(k, K_MULTI)
    nx, ny = _check_cuda(q_int, statics)
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty_like(q_int)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_plain_steps(q_int.data_ptr(), statics.data_ptr(),
                                out.data_ptr(), nx, ny, k, d0,
                                iprm.ctypes.data, fprm.ctypes.data,
                                float(dt), stream)
    _build.check(lib, rc, "gf_plain_steps")
    LAUNCHES["plain_steps" if k == _plain_k_steps(cfg)
             else "plain_steps_rem"] += 1
    return out


def _plain_sweeps(q_int, statics, dt, cfg, n, k):
    """Launch ``n >= 1`` plain steps through the C sweep entry
    (``gf_plain_sweeps``, or ``gf_plain_sweeps_bc`` where the boundary
    kernel covers ``cfg``): ``n // k`` sweeps of ``k`` and one of ``n mod
    k``, on two fresh buffers.  The C entry refuses a depth outside
    ``1.._k_steps(cfg)``, and the refusal raises here.  Returns the new
    state."""
    _, nx, ny = q_int.shape
    bc = () if _periodic_kernel_ok(cfg) else _bc_params(cfg)
    entry = "gf_plain_sweeps_bc" if bc else "gf_plain_sweeps"
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    bufs = torch.empty((2 if n > k else 1, 3, nx, ny), dtype=q_int.dtype,
                       device=q_int.device)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            q_int.data_ptr(), statics.data_ptr(), bufs[0].data_ptr(),
            bufs[-1].data_ptr(), nx, ny, n, k, d0, iprm.ctypes.data,
            fprm.ctypes.data, *(b.ctypes.data for b in bc), float(dt),
            stream)
    _build.check(lib, rc, entry)
    full, rem = divmod(n, k)
    for depth, count in ((k, full), (rem, int(rem > 0))):
        LAUNCHES["plain_steps_bc" if bc else "plain_steps"
                 if depth == _plain_k_steps(cfg) else "plain_steps_rem"] \
            += count
    return bufs[(full + (rem > 0) - 1) % 2]


def plain_sweeps(q_int, statics, dt, cfg, n):
    """``n`` plain periodic steps in one C call.

    ``n // k`` sweeps of ``k = _plain_k_steps(cfg)`` steps and one of
    ``n mod k``, each a launch that advances every tile that many steps on
    chip, reading one buffer and writing the other.  The result equals
    ``n`` launches of :func:`fused_step` bit for bit.  The input is not
    modified.  ``q_int``: (3, nx, ny), ``statics``: (8, nx, ny).  CUDA
    tensors (float32) launch the kernel; CPU tensors run
    :func:`plain_steps_ref`.
    """
    if _on_cpu(q_int):
        return plain_steps_ref(q_int, statics, dt, cfg, n)
    _periodic_gate(cfg)
    _check_cuda(q_int, statics)
    if n == 0:
        return q_int
    return _plain_sweeps(q_int, statics, dt, cfg, n, _plain_k_steps(cfg))


def plain_run(q_int, statics, dt, cfg, n, blocks=0):
    """A whole plain periodic run of ``n`` steps in one cooperative launch.

    Every step advances every tile by :func:`fused_step`'s body, the
    state ping-ponging between two device buffers, a grid-wide barrier
    between the steps; the grid is the co-resident maximum (``blocks`` >
    0 forces it, to test that a refused launch raises).  The inputs are
    not modified.  Returns the new state.  CUDA tensors (float32) launch
    the kernel; CPU tensors run :func:`plain_run_ref`.
    """
    if _on_cpu(q_int):
        return plain_run_ref(q_int, statics, dt, cfg, n)
    _periodic_gate(cfg)
    nx, ny = _check_cuda(q_int, statics)
    if n == 0:
        return q_int
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    bufs = torch.empty((2, 3, nx, ny), dtype=q_int.dtype,
                       device=q_int.device)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_plain_run(q_int.data_ptr(), statics.data_ptr(),
                              bufs[0].data_ptr(), bufs[1].data_ptr(), nx, ny,
                              n, d0, iprm.ctypes.data, fprm.ctypes.data,
                              float(dt), int(blocks), stream)
    _build.check(lib, rc, "gf_plain_run")
    LAUNCHES["plain_run"] += 1
    return bufs[(n - 1) % 2]


def _bc_gate(cfg):
    if not pallas_supported(cfg):
        raise ValueError("the boundary kernel does not cover this "
                         "configuration (see pallas_supported)")


def fused_step_bc(q_int, statics_g, dt, cfg):
    """One fused MacCormack step on D/N, thinning or periodic edges.

    ``q_int``: (3, nx, ny) interior state; ``statics_g``: (8, nx+2, ny+2)
    from :func:`ghost_statics`.  The ghosts come from the edge formulas,
    and are refilled from the predictor between the passes.  Returns the
    new interior state.  CUDA tensors (float32) launch the kernel; CPU
    tensors run :func:`fused_step_bc_ref`.
    """
    if _on_cpu(q_int):
        return fused_step_bc_ref(q_int, statics_g, dt, cfg)
    _bc_gate(cfg)
    nx, ny = _check_cuda(q_int, statics_g, ghosted=True)
    iprm, fprm = _kernel_params(cfg)
    bprm, bfprm = _bc_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty_like(q_int)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_fused_step_bc(q_int.data_ptr(), statics_g.data_ptr(),
                                  out.data_ptr(), nx, ny, d0,
                                  iprm.ctypes.data, fprm.ctypes.data,
                                  bprm.ctypes.data, bfprm.ctypes.data,
                                  float(dt), stream)
    _build.check(lib, rc, "gf_fused_step_bc")
    LAUNCHES["fused_step_bc"] += 1
    return out


def comp_steps_bc(q_int, q_lo, statics_g, dt, cfg, n):
    """``n`` Kahan-compensated boundary steps on the interior ``(q, q_lo)``
    carry.

    One C call: ``n // k`` sweeps of ``k = _comp_k_steps(cfg)`` steps and
    one of ``n mod k``, each tile advanced on chip with its ghosts
    refilled from ``q`` after every pass and average.  The result equals
    ``n`` launches of :func:`comp_step_bc_once` bit for bit.  The inputs
    are not modified.  Returns ``(q, q_lo)``.  CUDA tensors (float32)
    launch the kernel; CPU tensors run :func:`comp_steps_bc_ref`.
    """
    if _on_cpu(q_int):
        return comp_steps_bc_ref(q_int, q_lo, statics_g, dt, cfg, n)
    _bc_gate(cfg)
    _check_cuda(q_int, statics_g, q_lo, ghosted=True)
    if n == 0:
        return q_int, q_lo
    return _comp_sweeps("gf_comp_sweeps_bc", "comp_sweep_bc", q_int, q_lo,
                        statics_g, dt, cfg, n, _comp_k_steps(cfg),
                        *_bc_params(cfg))


def comp_step_bc_once(q_int, q_lo, statics_g, dt, cfg):
    """One Kahan-compensated boundary step on the interior ``(q, q_lo)``
    carry (ghosts rebuilt in-kernel from the interior), one launch of the
    one-step kernel: the witness of :func:`comp_steps_bc`.  Returns
    ``(q, q_lo)``.  CUDA tensors (float32) launch the kernel; CPU tensors
    run :func:`comp_steps_bc_ref`."""
    if _on_cpu(q_int):
        return comp_steps_bc_ref(q_int, q_lo, statics_g, dt, cfg, 1)
    _bc_gate(cfg)
    nx, ny = _check_cuda(q_int, statics_g, q_lo, ghosted=True)
    iprm, fprm = _kernel_params(cfg)
    bprm, bfprm = _bc_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty((6, nx, ny), dtype=q_int.dtype, device=q_int.device)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_comp_step_bc(q_int.data_ptr(), q_lo.data_ptr(),
                                 statics_g.data_ptr(), out[:3].data_ptr(),
                                 out[3:].data_ptr(), nx, ny, d0,
                                 iprm.ctypes.data, fprm.ctypes.data,
                                 bprm.ctypes.data, bfprm.ctypes.data,
                                 float(dt), stream)
    _build.check(lib, rc, "gf_comp_step_bc")
    LAUNCHES["comp_step_bc"] += 1
    return out[:3], out[3:]


def plain_steps_bc(q_int, statics_g, dt, cfg, k):
    """``k`` (1 to :func:`_k_steps`) plain steps on D/N, thinning or
    periodic edges in one launch.

    Each tile is advanced ``k`` steps on chip, its ghost rows and columns
    refilled by the edge formulas after every pass and every average; the
    result equals ``k`` launches of :func:`fused_step_bc`.  ``q_int``:
    (3, nx, ny); ``statics_g``: (8, nx+2, ny+2).  Returns the new
    interior state.  CUDA tensors (float32) launch the kernel; CPU
    tensors run :func:`plain_steps_bc_ref`.
    """
    if _on_cpu(q_int):
        return plain_steps_bc_ref(q_int, statics_g, dt, cfg, k)
    _bc_gate(cfg)
    _check_k(k, _k_steps(cfg))
    nx, ny = _check_cuda(q_int, statics_g, ghosted=True)
    iprm, fprm = _kernel_params(cfg)
    bprm, bfprm = _bc_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty_like(q_int)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_plain_steps_bc(q_int.data_ptr(), statics_g.data_ptr(),
                                   out.data_ptr(), nx, ny, k, d0,
                                   iprm.ctypes.data, fprm.ctypes.data,
                                   bprm.ctypes.data, bfprm.ctypes.data,
                                   float(dt), stream)
    _build.check(lib, rc, "gf_plain_steps_bc")
    LAUNCHES["plain_steps_bc"] += 1
    return out


def plain_sweeps_bc(q_int, statics_g, dt, cfg, n):
    """``n`` plain steps on D/N, thinning or periodic edges in one C call.

    ``n // k`` sweeps of ``k = _plain_k_steps(cfg)`` steps and one of
    ``n mod k``, each tile advanced on chip with its ghosts refilled after
    every pass and average.  The result equals ``n`` launches of
    :func:`fused_step_bc` bit for bit.  The input is not modified.
    ``q_int``: (3, nx, ny); ``statics_g``: (8, nx+2, ny+2).  CUDA tensors
    (float32) launch the kernel; CPU tensors run
    :func:`plain_steps_bc_ref`.
    """
    if _on_cpu(q_int):
        return plain_steps_bc_ref(q_int, statics_g, dt, cfg, n)
    _bc_gate(cfg)
    _check_cuda(q_int, statics_g, ghosted=True)
    if n == 0:
        return q_int
    return _plain_sweeps(q_int, statics_g, dt, cfg, n, _plain_k_steps(cfg))


# ---------------------------------------------------------------------------
# Drivers on ghost-inclusive arrays
# ---------------------------------------------------------------------------

def interior_statics(topo, extra, dtype, device):
    """The 8 static channels on the interior cells, computed once per run
    in ``dtype`` (cast first, then precomputed, as the JAX package does)."""
    return ghost_statics(topo, extra, dtype, device)[:, 1:-1, 1:-1] \
        .contiguous()


def ghost_statics(topo, extra, dtype, device):
    """The 8 static channels on the ghost-inclusive grid (the boundary
    kernels read them at the ghost cells too), in ``dtype``."""
    topo = torch.as_tensor(topo, device=device).to(dtype)
    extra = torch.as_tensor(extra, device=device).to(dtype)
    return precompute_statics(topo[:3], extra).contiguous()


def _check_supported(cfg, q, nx, ny):
    if not pallas_supported(cfg):
        raise ValueError("the fused kernels do not cover this configuration "
                         "(see pallas_supported)")
    if tuple(q.shape) != (3, nx + 2, ny + 2):
        raise ValueError(f"expected q of shape {(3, nx + 2, ny + 2)}, "
                         f"got {tuple(q.shape)}")


def _kernels(cfg):
    """(statics, step, compensated steps) of the kernel pair that covers
    ``cfg``: K1/K2 on the periodic interior, else K3."""
    if _periodic_kernel_ok(cfg):
        return interior_statics, fused_step, comp_steps
    return ghost_statics, fused_step_bc, comp_steps_bc


def _plain_run_fits(nx, ny, device):
    """Whether :func:`plain_run` takes the run: the ping-pong pair and the
    statics, ``(2 * 3 + 8) * nx * ny`` floats, fit the device's L2 cache
    (the counterpart of the TPU kernel's VMEM gate).  A CPU device is
    taken for an H100 (:data:`H100_L2_BYTES`)."""
    device = torch.device(device)
    l2 = (torch.cuda.get_device_properties(device).L2_cache_size
          if device.type == "cuda" else H100_L2_BYTES)
    return (2 * 3 + N_STATIC) * nx * ny * 4 <= l2


def _plain_route(cfg, nx, ny, n_steps, device):
    """The launches of a plain (uncompensated) run of ``n_steps``, in the
    JAX package's escalation: ``(entry, k, n_sweeps, n_rem)``, ``entry``
    the :data:`LAUNCHES` key of the full sweeps.

    Periodic edges without thinning: the whole run in one
    :func:`plain_run` where it fits the L2 cache and ``n_steps > 1``
    (``("plain_run", n_steps, 1, 0)``), else one C call of
    :func:`plain_sweeps`: ``n_sweeps`` sweeps of ``k = _plain_k_steps(cfg)``
    steps and, where ``n_rem`` is not 0, one sweep of ``n_rem``.  Other
    edges: the same through :func:`plain_sweeps_bc`.
    """
    if _periodic_kernel_ok(cfg):
        if n_steps > 1 and _plain_run_fits(nx, ny, device):
            return "plain_run", n_steps, 1, 0
        entry = "plain_steps"
    else:
        entry = "plain_steps_bc"
    k = _plain_k_steps(cfg)
    return (entry, k) + divmod(n_steps, k)


def _plain_loop(cfg, q_int, st, dt, n_steps):
    """The plain run of ``n_steps`` on the interior state, by
    :func:`_plain_route`: one launch or one C call."""
    nx, ny = q_int.shape[1:]
    entry, k, _, _ = _plain_route(cfg, nx, ny, n_steps, q_int.device)
    if entry == "plain_run":
        return plain_run(q_int, st, dt, cfg, k)
    sweeps = plain_sweeps if entry == "plain_steps" else plain_sweeps_bc
    return sweeps(q_int, st, dt, cfg, n_steps)


def make_pallas_step(cfg, nx, ny, dtype=torch.float32):
    """``step(q, topo, extra, dt, step_idx) -> q``: one fused step on
    ghost-inclusive arrays (``make_det_step`` minus the bookkeeping).
    Mixed-edge configurations run one step of
    :func:`ops.mixed_bc.make_mixed_loop`."""
    from .mixed_bc import make_mixed_loop, mixed_supported
    if mixed_supported(cfg, ny, nx):
        mloop = make_mixed_loop(cfg, nx, ny, dtype=dtype)
        return lambda q, topo, extra, dt, step_idx: mloop(q, topo, extra,
                                                           dt, 1)
    statics, step_fn, _ = _kernels(cfg)

    def step(q, topo, extra, dt, step_idx):
        del step_idx
        q = torch.as_tensor(q).to(dtype)
        _check_supported(cfg, q, nx, ny)
        st = statics(topo, extra, dtype, q.device)
        q_int = q[:, 1:-1, 1:-1].contiguous()
        return with_ghosts(step_fn(q_int, st, dt, cfg), cfg)

    return step


def make_pallas_loop(cfg, nx, ny, dtype=torch.float32, compensated=False,
                     with_lo=False):
    """``loop(q, topo, extra, dt, n_steps) -> q`` on ghost-inclusive arrays.

    Routes as the JAX package does: mixed per-component edges to
    :func:`ops.mixed_bc.make_mixed_loop`, fully periodic edges without
    thinning to K1/K2, everything else to K3.  The statics are computed
    once; between steps q stays in the interior layout.
    ``compensated=False`` takes the plain whole-run kernels of
    :func:`_plain_route`: on periodic edges the whole run in one launch
    where it fits the L2 cache, else one C call of :func:`plain_sweeps`
    (sweeps of :func:`_plain_k_steps` temporally blocked steps and one of
    the remainder); on other edges the same through
    :func:`plain_sweeps_bc`.
    ``compensated=True`` accumulates the increments with a Kahan carry
    ``(q, q_lo)``, which float32 runs need near steady state, where
    per-step increments fall below one ulp of the density: the whole run
    goes through the compensated sweeps (:func:`comp_steps` or
    :func:`comp_steps_bc`, one C call: sweeps of :func:`_comp_k_steps`
    steps and one of the remainder).  ``with_lo=True`` (requires
    ``compensated``) exposes the carry: ``loop(q, topo, extra, dt,
    n_steps, q_lo) -> (q, q_lo)``.
    """
    if with_lo and not compensated:
        raise ValueError("with_lo requires compensated=True")
    from .mixed_bc import make_mixed_loop, mixed_supported
    if mixed_supported(cfg, ny, nx):
        if with_lo:
            raise ValueError("mixed-edge loop does not expose the Kahan "
                             "carry (no chunked EHL driver on mixed edges)")
        return make_mixed_loop(cfg, nx, ny, dtype=dtype,
                               compensated=compensated)
    statics, _, steps_fn = _kernels(cfg)

    def loop(q, topo, extra, dt, n_steps, q_lo=None):
        q = torch.as_tensor(q).to(dtype)
        _check_supported(cfg, q, nx, ny)
        st = statics(topo, extra, dtype, q.device)
        q_int = q[:, 1:-1, 1:-1].contiguous()
        dt = float(dt)

        if not compensated:
            return with_ghosts(_plain_loop(cfg, q_int, st, dt, n_steps), cfg)

        lo = (torch.zeros_like(q_int) if q_lo is None
              else torch.as_tensor(q_lo, device=q.device).to(dtype)
              .contiguous())
        q_int, lo = steps_fn(q_int, lo, st, dt, cfg, n_steps)
        if with_lo:
            return with_ghosts(q_int, cfg), lo
        return with_ghosts(q_int, cfg)

    return loop


# ---------------------------------------------------------------------------
# K8: the EHL step with the statics derived from the deformed gap
# ---------------------------------------------------------------------------

def ehl_patches(h_full, cfg):
    """Boundary gradient patches of a ghost-inclusive gap height ``(nx+2,
    ny+2)``: ``px`` (2, ny), the central differences of interior rows 0
    and nx-1, and ``py`` (2, nx), those of interior columns 0 and ny-1,
    whose stencils reach the ghost ring (the geometry's midpoint heights,
    not a wrap of the interior)."""
    rdx2, rdy2 = 0.5 / cfg.dx, 0.5 / cfg.dy
    px = torch.stack([(h_full[2, 1:-1] - h_full[0, 1:-1]) * rdx2,
                      (h_full[-1, 1:-1] - h_full[-3, 1:-1]) * rdx2])
    py = torch.stack([(h_full[1:-1, 2] - h_full[1:-1, 0]) * rdy2,
                      (h_full[1:-1, -1] - h_full[1:-1, -3]) * rdy2])
    return px.contiguous(), py.contiguous()


def ehl_statics_ref(h_int, ls_int, px, py, cfg):
    """The 8 static channels the EHL kernel forms in-kernel, in its order:
    wrapped central differences of ``h_int`` times 0.5/dx (0.5/dy), rows
    0 and nx-1 (columns 0 and ny-1) from ``px`` (``py``), and the factored
    channels of ``precompute_statics``."""
    rdx2, rdy2 = 0.5 / cfg.dx, 0.5 / cfg.dy
    H, Ls = h_int, ls_int
    Hx = (torch.roll(H, -1, dims=0) - torch.roll(H, 1, dims=0)) * rdx2
    Hx[0] = px[0]
    Hx[-1] = px[1]
    Hy = (torch.roll(H, -1, dims=1) - torch.roll(H, 1, dims=1)) * rdy2
    Hy[:, 0] = py[0]
    Hy[:, -1] = py[1]
    ic = true_div(1., 4. * Ls + H)
    return torch.stack([Hx, Hy, H, 2. * Ls, true_div(1., H), ic,
                        2. * (3. * Ls + H) * ic * ic, 6. * Ls])


def ehl_gap(h_und, u, shift_ref=False):
    """The deformed ghost-inclusive gap ``h_und + (u - u[0, 0])`` with
    ``shift_ref`` (the half-space's reference shift), else ``h_und + u``:
    the torch ops the EHL kernel repeats per cell."""
    return h_und + (u - u[0, 0] if shift_ref else u)


def _ehl_statics_of(h_und, u, ls_int, cfg, shift_ref):
    """:func:`ehl_statics_ref` of the gap :func:`ehl_gap` and its
    :func:`ehl_patches`, the statics the EHL kernel forms."""
    h_full = ehl_gap(h_und, u, shift_ref)
    px, py = ehl_patches(h_full, cfg)
    return ehl_statics_ref(h_full[1:-1, 1:-1], ls_int, px, py, cfg)


def ehl_step_ref(q_int, h_und, u, ls_int, dt, cfg, emit_delta=False,
                 shift_ref=False):
    """Plain torch twin of :func:`ehl_step`."""
    return fused_step_ref(q_int, _ehl_statics_of(h_und, u, ls_int, cfg,
                                                 shift_ref),
                          dt, cfg, emit_delta)


def ehl_comp_step_ref(q_int, q_lo, h_und, u, ls_int, dt, cfg,
                      shift_ref=False):
    """Plain torch twin of :func:`ehl_comp_step`: the emit_delta step and
    the two-sum of ``_advance_comp``.  Returns ``(q, q_lo)``."""
    return _kahan(q_int, q_lo, ehl_step_ref(q_int, h_und, u, ls_int, dt, cfg,
                                            emit_delta=True,
                                            shift_ref=shift_ref))


def _check_ehl(cfg, q, h_und, u, ls_int, *more):
    if not _periodic_kernel_ok(cfg):
        raise ValueError("the EHL kernel requires a fully periodic "
                         "configuration without shear thinning")
    _, nx, ny = q.shape
    _check_tensors(q, (q, (3, nx, ny)), (h_und, (nx + 2, ny + 2)),
                   (u, (nx + 2, ny + 2)), (ls_int, (nx, ny)),
                   *((m, (3, nx, ny)) for m in more))
    return nx, ny


def ehl_step(q_int, h_und, u, ls_int, dt, cfg, emit_delta=False,
             shift_ref=False):
    """One fused periodic step with the statics formed in-kernel.

    ``q_int``: (3, nx, ny); ``h_und``, ``u``: the ghost-inclusive
    undeformed gap and deformation (nx+2, ny+2), whose gap
    :func:`ehl_gap` (``shift_ref``: relative to ``u[0, 0]``) the kernel
    forms per cell, its slopes the central differences over the
    ghost-inclusive neighbours; ``ls_int``: the interior slip length (nx,
    ny).  Returns the new state, or with ``emit_delta`` the increment.
    CUDA tensors (float32) launch the kernel; CPU tensors run
    :func:`ehl_step_ref`.
    """
    if _on_cpu(q_int):
        return ehl_step_ref(q_int, h_und, u, ls_int, dt, cfg, emit_delta,
                            shift_ref)
    nx, ny = _check_ehl(cfg, q_int, h_und, u, ls_int)
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty_like(q_int)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_ehl_step(q_int.data_ptr(), h_und.data_ptr(),
                             u.data_ptr(), ls_int.data_ptr(), out.data_ptr(),
                             nx, ny, int(bool(shift_ref)), d0,
                             int(emit_delta), iprm.ctypes.data,
                             fprm.ctypes.data, 0.5 / cfg.dx, 0.5 / cfg.dy,
                             float(dt), stream)
    _build.check(lib, rc, "gf_ehl_step")
    LAUNCHES["ehl_step"] += 1
    return out


def ehl_comp_step(q_int, q_lo, h_und, u, ls_int, dt, cfg, shift_ref=False):
    """One Kahan-compensated EHL step on the interior ``(q, q_lo)`` carry,
    the two-sum in registers; the other inputs as for :func:`ehl_step`.
    The inputs are not modified.  Returns ``(q, q_lo)`` (on CUDA, the two
    halves of one (6, nx, ny) buffer).  CUDA tensors (float32) launch the
    kernel; CPU tensors run :func:`ehl_comp_step_ref`.
    """
    if _on_cpu(q_int):
        return ehl_comp_step_ref(q_int, q_lo, h_und, u, ls_int, dt, cfg,
                                 shift_ref)
    nx, ny = _check_ehl(cfg, q_int, h_und, u, ls_int, q_lo)
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty((6, nx, ny), dtype=q_int.dtype, device=q_int.device)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_ehl_comp_step(q_int.data_ptr(), q_lo.data_ptr(),
                                  h_und.data_ptr(), u.data_ptr(),
                                  ls_int.data_ptr(), out[:3].data_ptr(),
                                  out[3:].data_ptr(), nx, ny,
                                  int(bool(shift_ref)), d0, iprm.ctypes.data,
                                  fprm.ctypes.data, 0.5 / cfg.dx,
                                  0.5 / cfg.dy, float(dt), stream)
    _build.check(lib, rc, "gf_ehl_comp_step")
    LAUNCHES["ehl_comp_step"] += 1
    return out[:3], out[3:]


def make_pallas_ehl_step(cfg, nx, ny, dtype=torch.float32, emit_delta=False):
    """``step(q, u, h_und, extra, dt) -> q_new`` on ghost-inclusive arrays
    around :func:`ehl_step`: the gap ``h_und + u`` is formed inside the
    kernel.  Returns the ghost-inclusive new state (ghosts by periodic
    wrap) or, with ``emit_delta``, the interior increment."""
    _periodic_gate(cfg)

    def step(q, u, h_und, extra, dt):
        q = torch.as_tensor(q).to(dtype)
        _check_supported(cfg, q, nx, ny)
        h_und = torch.as_tensor(h_und, device=q.device).to(dtype).contiguous()
        u = torch.as_tensor(u, device=q.device).to(dtype).contiguous()
        ls = torch.as_tensor(extra, device=q.device).to(dtype)[0, 1:-1, 1:-1]
        out = ehl_step(q[:, 1:-1, 1:-1].contiguous(), h_und, u,
                       ls.contiguous(), dt, cfg, emit_delta)
        return out if emit_delta else with_ghosts(out, cfg)

    return step


def make_pallas_ehl_loop_step(cfg, nx, ny, dtype=torch.float32):
    """``step(q6, h_und, u, ls_int, dt, shift_ref=False) -> q6`` around
    :func:`ehl_comp_step`, with ``q6`` the interior (6, nx, ny) ``(q,
    q_lo)`` state."""
    _periodic_gate(cfg)

    def step(q6, h_und, u, ls_int, dt, shift_ref=False):
        q6 = torch.as_tensor(q6).to(dtype)
        if tuple(q6.shape) != (6, nx, ny):
            raise ValueError(f"expected q6 of shape {(6, nx, ny)}, got "
                             f"{tuple(q6.shape)}")
        return torch.cat(ehl_comp_step(q6[:3], q6[3:], h_und, u, ls_int, dt,
                                       cfg, shift_ref))

    return step


# ---------------------------------------------------------------------------
# K9: one step of one shard of a sharded run
# ---------------------------------------------------------------------------

def shard_supported(cfg):
    """K9's coverage, the JAX package's sharded D/N scope
    (``parallel/pallas_halo.py:333-339``): a static pass order, edges that
    are each fully periodic or have no periodic component, no shear
    thinning."""
    return cfg.MC_order != 0 and _edges_uniform(cfg) and cfg.thinning is None


def _edge_fill(bc, c, adj):
    """The ghost value of component ``c`` on an edge with masks ``bc``
    from the adjacent interior value (``core.step.apply_bcs``)."""
    return 2. * bc["val"] - adj if bc["D"][c] else adj


def _refill_shard(cfg, q, flags):
    """The D/N ghost refill of a shard's pass-d0 state ``q`` (3, bx+4,
    by+4), the ring at halo depth 1 on each domain edge the shard holds
    (``flags`` = (xe, xw, yn, ys)): x edges first, then y edges over the
    x-refilled rows, as ``_refill_ghosts_shard`` and ``apply_bcs`` fill."""
    xe, xw, yn, ys = (bool(f) for f in flags)
    q = q.clone()
    for e, on, dst, src in ((0, xe, 1, 2), (1, xw, -2, -3)):
        if on:
            bc = cfg.bc_edge(e)
            for c in range(3):
                q[c, dst] = _edge_fill(bc, c, q[c, src])
    for e, on, dst, src in ((2, ys, 1, 2), (3, yn, -2, -3)):
        if on:
            bc = cfg.bc_edge(e)
            for c in range(3):
                q[c, :, dst] = _edge_fill(bc, c, q[c, :, src])
    return q


def shard_step_ref(q_blk, statics_blk, dt, cfg, flags):
    """Plain torch twin of :func:`shard_step`, in any dtype: pass d0 on
    the whole block (the rolls' wrap reaches only the halo's outer cells,
    which no interior output reads), the refill of :func:`_refill_shard`,
    pass d1, and the average with the input on the interior."""
    pred, u = _predict_and_update(cfg, q_blk, statics_blk, float(dt),
                                  lambda q: _refill_shard(cfg, q, flags))

    def inner(arrs):
        return [a[2:-2, 2:-2] for a in arrs]

    return _combine(inner(pred), inner(q_blk), inner(u), False)


def shard_step(q_blk, statics_blk, dt, cfg, flags):
    """One MacCormack step of one shard of a sharded run.

    ``q_blk``: (3, bx+4, by+4), the shard with a 2-deep halo from its mesh
    neighbours and, on a domain edge the shard holds, the edge's ghost
    value duplicated to the halo's depth; ``statics_blk``: (8, bx+4,
    by+4), from :func:`precompute_statics` of the shard's 2-deep
    topography block (``parallel.pallas_halo.pad_blocks2_bc``); ``flags``
    (xe, xw, yn, ys): the shard holds the x-low, x-high, y-high, y-low
    domain edge and that edge is not periodic.  Returns the new interior
    (3, bx, by).  All flags zero on periodic edges give K1's step.  CUDA
    tensors (float32) launch the kernel; CPU tensors run
    :func:`shard_step_ref`.
    """
    if _on_cpu(q_blk):
        return shard_step_ref(q_blk, statics_blk, dt, cfg, flags)
    if not shard_supported(cfg):
        raise ValueError("the shard kernel does not cover this "
                         "configuration (see shard_supported)")
    _, hx, hy = q_blk.shape
    bx, by = hx - 4, hy - 4
    if bx < 1 or by < 1:
        raise ValueError(f"a shard block needs a 2-deep halo, got shape "
                         f"{tuple(q_blk.shape)}")
    _check_tensors(q_blk, (q_blk, (3, hx, hy)),
                   (statics_blk, (N_STATIC, hx, hy)))
    iprm, fprm = _kernel_params(cfg)
    bprm, bfprm = _bc_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    xe, xw, yn, ys = (int(bool(f)) for f in flags)
    out = torch.empty((3, bx, by), dtype=q_blk.dtype, device=q_blk.device)
    lib = _build.load()
    with torch.cuda.device(q_blk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_shard_step(q_blk.data_ptr(), statics_blk.data_ptr(),
                               out.data_ptr(), bx, by, d0, iprm.ctypes.data,
                               fprm.ctypes.data, bprm.ctypes.data,
                               bfprm.ctypes.data, xe, xw, yn, ys, float(dt),
                               stream)
    _build.check(lib, rc, "gf_shard_step")
    LAUNCHES["shard_step"] += 1
    return out


def _edge_pad(cfg, q, flags, depth):
    """``q`` (3, X, Y) extended by ``depth`` ghost rows and columns on
    each domain edge the shard holds (``flags``): the edge formula of the
    adjacent line (``core.step.apply_bcs``), repeated to the depth, x
    edges first and then y edges over the x-extended rows, as
    ``parallel.halo.halo_blocks`` fills a shard's halo on a domain edge."""
    xe, xw, yn, ys = (bool(f) for f in flags)

    def fill(e, line):
        bc = cfg.bc_edge(e)
        return torch.stack([_edge_fill(bc, c, line[c]) for c in range(3)])

    if xe:
        g = fill(0, q[:, 0])[:, None]
        q = torch.cat([g.expand(-1, depth, -1), q], 1)
    if xw:
        g = fill(1, q[:, -1])[:, None]
        q = torch.cat([q, g.expand(-1, depth, -1)], 1)
    if ys:
        g = fill(2, q[:, :, 0])[:, :, None]
        q = torch.cat([g.expand(-1, -1, depth), q], 2)
    if yn:
        g = fill(3, q[:, :, -1])[:, :, None]
        q = torch.cat([q, g.expand(-1, -1, depth)], 2)
    return q


def _sweep_geometry(q_blk, statics_blk, k):
    """(bx, by, hs) of a shard sweep's inputs: the state block with a
    ``HALO_SHARD * k``-deep halo, the statics block with an ``hs``-deep
    one (hs >= the state's, the same on both axes)."""
    _check_k(k, K_MULTI)
    hq = HALO_SHARD * k
    _, hx, hy = q_blk.shape
    bx, by = hx - 2 * hq, hy - 2 * hq
    if bx < 1 or by < 1:
        raise ValueError(f"a {k}-step shard sweep needs a {hq}-deep halo, "
                         f"got a block of shape {tuple(q_blk.shape)}")
    hs = (statics_blk.shape[1] - bx) // 2
    if (statics_blk.shape[0] != N_STATIC or hs < hq
            or tuple(statics_blk.shape[1:]) != (bx + 2 * hs, by + 2 * hs)):
        raise ValueError(f"statics block {tuple(statics_blk.shape)} for a "
                         f"{bx} x {by} shard with a {hq}-deep halo")
    return bx, by, hs


def _shard_steps(step, q_blk, statics_blk, dt, cfg, flags, k):
    """``k`` applications of ``step`` (a one-step shard kernel or twin)
    on the shrinking halo of a ``2k``-deep block: each step advances the
    block less two cells a side on the sides the shard shares with
    neighbours, and the interior on the domain edges it holds, whose
    2-deep ghost halo is rebuilt from the new state (:func:`_edge_pad`)
    before the next step.  Returns the new interior (3, bx, by)."""
    bx, by, hs = _sweep_geometry(q_blk, statics_blk, k)
    xe, xw, yn, ys = (bool(f) for f in flags)
    q, e = q_blk, HALO_SHARD * k     # e: the held edges' halo depth in q
    for j in range(k):
        h = HALO_SHARD * (k - j)     # the shared sides' halo depth in q
        lo_x, hi_x = (2 if xe else h), (2 if xw else h)
        lo_y, hi_y = (2 if ys else h), (2 if yn else h)
        ox, oy = (e if xe else h) - lo_x, (e if ys else h) - lo_y
        q_in = q[:, ox:ox + lo_x + bx + hi_x, oy:oy + lo_y + by + hi_y]
        st = statics_blk[:, hs - lo_x:hs + bx + hi_x, hs - lo_y:hs + by + hi_y]
        q = step(q_in.contiguous(), st.contiguous(), dt, cfg, flags)
        if j < k - 1:
            q, e = _edge_pad(cfg, q, flags, HALO_SHARD), HALO_SHARD
    return q


def shard_sweep_ref(q_blk, statics_blk, dt, cfg, flags, k):
    """Plain torch twin of :func:`shard_sweep`, in any dtype: ``k``
    applications of :func:`shard_step_ref` on the shrinking halo
    (:func:`_shard_steps`)."""
    return _shard_steps(shard_step_ref, q_blk, statics_blk, dt, cfg, flags,
                        k)


def shard_steps_once(q_blk, statics_blk, dt, cfg, flags, k):
    """The witness of :func:`shard_sweep`: ``k`` launches of the one-step
    kernel :func:`shard_step` on the shrinking halo, the held edges'
    ghosts rebuilt in torch between them (:func:`_shard_steps`)."""
    return _shard_steps(shard_step, q_blk, statics_blk, dt, cfg, flags, k)


def shard_sweep(q_blk, statics_blk, dt, cfg, flags, k):
    """``k`` (1 to :data:`K_MULTI`) MacCormack steps of one shard of a
    sharded run in one launch, on the register sweep body.

    ``q_blk``: (3, bx+4k, by+4k), the shard with a ``2k``-deep halo
    (``parallel.halo.halo_blocks``: from the mesh neighbours, or on a
    domain edge the shard holds, the edge's ghost value repeated to the
    depth); ``statics_blk``: (8, bx+2hs, by+2hs) with hs >= 2k, from
    :func:`precompute_statics` of the shard's topography block
    (``parallel.pallas_halo.pad_blocks2_bc`` at that depth); ``flags``
    (xe, xw, yn, ys) as for :func:`shard_step`.  The ghosts of the held
    edges are refilled in the sweep, after every pass and average, so
    those sides consume no halo; the shared sides consume a cell a step
    of it.  Returns the new interior (3, bx, by), equal to
    :func:`shard_steps_once` bit for bit.  CUDA tensors (float32) launch
    the kernel; CPU tensors run :func:`shard_sweep_ref`.
    """
    if _on_cpu(q_blk):
        return shard_sweep_ref(q_blk, statics_blk, dt, cfg, flags, k)
    if not shard_supported(cfg):
        raise ValueError("the shard kernel does not cover this "
                         "configuration (see shard_supported)")
    bx, by, hs = _sweep_geometry(q_blk, statics_blk, k)
    _check_tensors(q_blk, (q_blk, q_blk.shape),
                   (statics_blk, statics_blk.shape))
    iprm, fprm = _kernel_params(cfg)
    bprm, bfprm = _bc_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    xe, xw, yn, ys = (int(bool(f)) for f in flags)
    out = torch.empty((3, bx, by), dtype=q_blk.dtype, device=q_blk.device)
    lib = _build.load()
    with torch.cuda.device(q_blk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_shard_sweep(q_blk.data_ptr(), statics_blk.data_ptr(),
                                out.data_ptr(), bx, by, k, HALO_SHARD * k,
                                hs, d0, iprm.ctypes.data, fprm.ctypes.data,
                                bprm.ctypes.data, bfprm.ctypes.data, xe, xw,
                                yn, ys, float(dt), stream)
    _build.check(lib, rc, "gf_shard_sweep")
    LAUNCHES["shard_sweep"] += 1
    return out
