"""Fused periodic MacCormack step: CUDA kernels, their plain twins, drivers.

Counterpart of the periodic path of :mod:`gapflow_tpu.ops.stencil`.  Two
kernels, in ``csrc/stencil.cu``:

- :func:`fused_step` (replaces ``_kernel_fused``): one step on the
  interior ``(3, nx, ny)`` state, returning the new state or, with
  ``emit_delta``, the increment ``((q* - q) - u) / 2``;
- :func:`comp_steps` (replaces ``_kernel_fused_hbm_loop`` with
  ``_advance_comp``): ``n`` Kahan-compensated steps on the ``(q, q_lo)``
  carry, one launch per step, ping-ponging two buffer pairs.

Beside each kernel is its plain torch twin (:func:`fused_step_ref`,
:func:`comp_steps_ref`), which mirrors ``_one_pass_fused`` with
``torch.roll`` on the periodic interior.  A wrapper takes the twin only for
a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Every launch adds one to its entry in :data:`LAUNCHES`.

Coverage (:func:`pallas_supported`): fully periodic edges, a static pass
order (``MC_order != 0``) and no shear thinning, with every EOS and
piezoviscosity model.  D/N edges, mixed edges and thinning run the plain
torch step until their kernels are ported.
"""

import functools
import inspect
import math

import numpy as np
import torch

from . import _build
from ..core.step import mc_directions
from ..models.closures_opt import (N_STATIC, fused_pass_top_pre,
                                   precompute_statics)
from ..models.eos import _PRESSURE, _bwr_terms, eos_pressure
from ..models.viscosity import _PIEZO, piezoviscosity

#: Steps per sweep of the compensated loop: full sweeps go through
#: :func:`comp_steps`, the remainder through :func:`fused_step` with
#: ``emit_delta`` (the loop structure of the JAX package, whose sweep
#: kernel advances K_MULTI steps per launch).
K_MULTI = 4

#: Kernel launches per wrapper since the last reset (the plain twins
#: count nothing).
LAUNCHES = {"fused_step": 0, "comp_step": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fully_periodic(cfg):
    return all(all(dict(cfg.bc[i])["P"]) for i in range(4))


def pallas_supported(cfg):
    """Whether the fused kernels cover ``cfg``: fully periodic edges, a
    static pass order and no shear thinning.  Unlike the TPU kernels the
    grid width needs no alignment."""
    return (cfg.MC_order != 0 and cfg.thinning is None
            and _fully_periodic(cfg))


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _eta_fused(cfg, rho, p):
    """Per-cell shear viscosity (piezoviscous or constant); the cavitation
    mixture models take density with the Bayada EOS."""
    if cfg.piezo is None:
        return cfg.shear
    arg = rho if cfg.prop["EOS"] == "Bayada" else p
    return piezoviscosity(arg, cfg.shear, dict(cfg.piezo))


def _one_pass(cfg, q0, q1, q2, st, dt, d, return_upd=False):
    """One one-sided pass on the periodic interior (``_one_pass_fused``).
    ``return_upd`` returns the update ``u`` (``q_new = q - u``)."""
    p = eos_pressure(q0, cfg.prop)
    eta = _eta_fused(cfg, q0, p)
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


def _predict_and_update(cfg, q, statics, dt):
    """Pass d0 (predictor state) and the pass-d1 update ``u``."""
    d0, d1 = mc_directions(cfg.MC_order)
    st = tuple(statics)
    pred = _one_pass(cfg, q[0], q[1], q[2], st, dt, d0)
    u = _one_pass(cfg, *pred, st, dt, d1, return_upd=True)
    return pred, u


def fused_step_ref(q_int, statics, dt, cfg, emit_delta=False):
    """Plain torch twin of :func:`fused_step`."""
    dt = float(dt)
    pred, u = _predict_and_update(cfg, q_int, statics, dt)
    if emit_delta:
        return torch.stack([((a - q) - du) / 2.
                            for a, q, du in zip(pred, q_int, u)])
    return torch.stack([((a - du) + q) / 2.
                        for a, q, du in zip(pred, q_int, u)])


def comp_steps_ref(q_int, q_lo, statics, dt, cfg, n):
    """Plain torch twin of :func:`comp_steps`: ``n`` Kahan-compensated
    steps in the order of ``_advance_comp``.  Returns ``(q, q_lo)``."""
    dt = float(dt)
    for _ in range(n):
        pred, u = _predict_and_update(cfg, q_int, statics, dt)
        delta = torch.stack([((a - q) - du) / 2.
                             for a, q, du in zip(pred, q_int, u)])
        y = delta + q_lo
        t = q_int + y
        q_int, q_lo = t, y - (t - q_int)
    return q_int, q_lo


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


def _check_cuda(q, statics, *more):
    nch, nx, ny = q.shape
    for t, shape in ((q, (3, nx, ny)), (statics, (N_STATIC, nx, ny)),
                     *((m, (3, nx, ny)) for m in more)):
        if t.device != q.device:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"and {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return nx, ny


def _on_cpu(q):
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return False


def fused_step(q_int, statics, dt, cfg, emit_delta=False):
    """One fused periodic MacCormack step on the interior state.

    ``q_int``: (3, nx, ny); ``statics``: (8, nx, ny) from
    :func:`interior_statics`.  Returns the new state, or with
    ``emit_delta`` the increment ``((q* - q) - u) / 2`` whose Kahan
    accumulation keeps sub-ulp updates.  CUDA tensors (float32) launch
    the kernel; CPU tensors run :func:`fused_step_ref`.
    """
    if _on_cpu(q_int):
        return fused_step_ref(q_int, statics, dt, cfg, emit_delta)
    nx, ny = _check_cuda(q_int, statics)
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    out = torch.empty_like(q_int)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_fused_step(q_int.data_ptr(), statics.data_ptr(),
                               out.data_ptr(), nx, ny, d0, int(emit_delta),
                               iprm.ctypes.data, fprm.ctypes.data,
                               float(dt), stream)
    _build.check(lib, rc, "gf_fused_step")
    LAUNCHES["fused_step"] += 1
    return out


def comp_steps(q_int, q_lo, statics, dt, cfg, n):
    """``n`` Kahan-compensated steps on the ``(q, q_lo)`` carry.

    One kernel launch per step, reading one buffer pair and writing the
    other.  The inputs are not modified.  Returns ``(q, q_lo)``.  CUDA
    tensors (float32) launch the kernel; CPU tensors run
    :func:`comp_steps_ref`.
    """
    if _on_cpu(q_int):
        return comp_steps_ref(q_int, q_lo, statics, dt, cfg, n)
    nx, ny = _check_cuda(q_int, statics, q_lo)
    if n == 0:
        return q_int, q_lo
    iprm, fprm = _kernel_params(cfg)
    d0, _ = mc_directions(cfg.MC_order)
    bufs = [torch.empty((6, nx, ny), dtype=q_int.dtype, device=q_int.device)
            for _ in range(min(n, 2))]
    src = (q_int, q_lo)
    lib = _build.load()
    dt = float(dt)
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(n):
            dst = bufs[i % 2]
            rc = lib.gf_comp_step(src[0].data_ptr(), src[1].data_ptr(),
                                  statics.data_ptr(), dst[:3].data_ptr(),
                                  dst[3:].data_ptr(), nx, ny, d0,
                                  iprm.ctypes.data, fprm.ctypes.data, dt,
                                  stream)
            _build.check(lib, rc, "gf_comp_step")
            LAUNCHES["comp_step"] += 1
            src = (dst[:3], dst[3:])
    return src


# ---------------------------------------------------------------------------
# Drivers on ghost-inclusive arrays
# ---------------------------------------------------------------------------

def interior_statics(topo, extra, dtype, device):
    """The 8 static channels on the interior cells, computed once per run
    in ``dtype`` (cast first, then precomputed, as the JAX package does)."""
    topo = torch.as_tensor(topo, device=device).to(dtype)
    extra = torch.as_tensor(extra, device=device).to(dtype)
    return precompute_statics(topo[:3, 1:-1, 1:-1],
                              extra[:, 1:-1, 1:-1]).contiguous()


def _reassemble(q_like, q_int):
    """Interior (3, nx, ny) -> ghost-inclusive with periodic ghost fill."""
    out = torch.zeros_like(q_like)
    out[:, 1:-1, 1:-1] = q_int
    out[:, 0, :] = out[:, -2, :]
    out[:, -1, :] = out[:, 1, :]
    out[:, :, 0] = out[:, :, -2]
    out[:, :, -1] = out[:, :, 1]
    return out


def _check_supported(cfg, q, nx, ny):
    if not pallas_supported(cfg):
        raise ValueError("the fused kernels do not cover this configuration "
                         "(see pallas_supported)")
    if tuple(q.shape) != (3, nx + 2, ny + 2):
        raise ValueError(f"expected q of shape {(3, nx + 2, ny + 2)}, "
                         f"got {tuple(q.shape)}")


def make_pallas_step(cfg, nx, ny, dtype=torch.float32):
    """``step(q, topo, extra, dt, step_idx) -> q``: one fused step on
    ghost-inclusive arrays (``make_det_step`` minus the bookkeeping)."""
    def step(q, topo, extra, dt, step_idx):
        del step_idx
        q = torch.as_tensor(q).to(dtype)
        _check_supported(cfg, q, nx, ny)
        st = interior_statics(topo, extra, dtype, q.device)
        q_int = q[:, 1:-1, 1:-1].contiguous()
        return _reassemble(q, fused_step(q_int, st, dt, cfg))

    return step


def make_pallas_loop(cfg, nx, ny, dtype=torch.float32, compensated=False,
                     with_lo=False):
    """``loop(q, topo, extra, dt, n_steps) -> q`` on ghost-inclusive arrays.

    The statics are computed once; between steps q stays in the interior
    layout.  ``compensated=False`` runs :func:`fused_step` ``n_steps``
    times.  ``compensated=True`` accumulates the increments with a Kahan
    carry ``(q, q_lo)``, which float32 runs need near steady state, where
    per-step increments fall below one ulp of the density: full sweeps of
    :data:`K_MULTI` steps go through :func:`comp_steps`, the remainder
    through :func:`fused_step` with ``emit_delta`` and the same two-sum in
    torch.  ``with_lo=True`` (requires ``compensated``) exposes the carry:
    ``loop(q, topo, extra, dt, n_steps, q_lo) -> (q, q_lo)``.
    """
    if with_lo and not compensated:
        raise ValueError("with_lo requires compensated=True")

    def loop(q, topo, extra, dt, n_steps, q_lo=None):
        q = torch.as_tensor(q).to(dtype)
        _check_supported(cfg, q, nx, ny)
        st = interior_statics(topo, extra, dtype, q.device)
        q_int = q[:, 1:-1, 1:-1].contiguous()
        dt = float(dt)

        if not compensated:
            for _ in range(n_steps):
                q_int = fused_step(q_int, st, dt, cfg)
            return _reassemble(q, q_int)

        lo = (torch.zeros_like(q_int) if q_lo is None
              else torch.as_tensor(q_lo, device=q.device).to(dtype)
              .contiguous())
        n_sweeps, n_rem = divmod(n_steps, K_MULTI)
        q_int, lo = comp_steps(q_int, lo, st, dt, cfg, n_sweeps * K_MULTI)
        for _ in range(n_rem):
            delta = fused_step(q_int, st, dt, cfg, emit_delta=True)
            y = delta + lo
            t = q_int + y
            q_int, lo = t, y - (t - q_int)
        if with_lo:
            return _reassemble(q, q_int), lo
        return _reassemble(q, q_int)

    return loop
