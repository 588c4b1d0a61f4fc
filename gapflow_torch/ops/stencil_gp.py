"""GP-closed MacCormack steps: CUDA kernels, their plain twins, operands.

Counterpart of :mod:`gapflow_tpu.ops.stencil_gp`.  The multiscale mode
closes the balance equations with Gaussian-process surrogates: the GP
pressure replaces the EOS, and the GP wall shear stresses replace the
analytic ones in the momentum sources, as the additive correction
``S += ((up - su_det) - (lo - sl_det)) / h`` of the factored pass.  Three
wrappers over the kernels of ``csrc/stencil_gp.cu``, where a step is
four launches in stream order: the used surrogates' means at every cell
(``gp_fields_kernel``), pass d0 and the predictor, the means at the
predictor, pass d1 and the average (``gp_pass_kernel``); without
surrogates only the two passes:

- :func:`gp_step` (replaces ``_kernel_fused_gp``): one step on the
  periodic interior state, returning the new state and the pass-2
  pressure;
- :func:`gp_step_bc` (replaces ``_kernel_fused_gp_bc``): one step on
  uniform Dirichlet/Neumann edges, ghosts refilled between the passes,
  returning the new state (and, where asked, the ghost-inclusive pass-2
  pressure);
- :func:`gp_steps` (replaces ``_kernel_gp_vmem`` and
  ``_kernel_gp_hbm_loop``): ``n`` frozen-GP periodic steps from a loop in
  C, ping-ponging two buffers.

:func:`gp_fields` launches the means alone, on every cell of a state.

Each GP mean is the Matern-3/2 sum of ``_gp_mean`` (the JAX package's
readable formulation): per cell the scaled features ``x``, per training
point ``arg = sqrt(max(x.x + x.Wm2[j] + w2[j], 3e-14))`` and
``acc += (e + arg e) alpha[j]`` with ``e = exp(-arg)``.  The Matern
sqrt(3), the sqrt's epsilon, the amplitude and the target scale are
folded into the operands once per surrogate state (:func:`prep_gp_ops`);
padded training rows have alpha = 0 and add nothing.

Beside each kernel is its plain torch twin (``*_ref``) with the same
arithmetic in the same order (a Python loop over the training points).
A wrapper takes the twin only for a tensor on the CPU; for a CUDA tensor
it launches the kernels or raises.  Every wrapper call adds one to its
entry in :data:`LAUNCHES` (``gp_steps`` one per step);
:func:`kernel_launches` gives the device launches of one step.
"""

import math

import numpy as np
import torch

from . import _build
from .stencil import (_bc_params, _check_tensors, _fully_periodic,
                      _kernel_params, _on_cpu, pallas_supported, with_ghosts)
from ..core.step import apply_bcs, effective_viscosity, mc_directions
from ..models.closures_opt import N_STATIC, fused_pass_top_pre
from ..models.eos import eos_pressure

_SQRT3 = math.sqrt(3.)
KEYS = ("z", "x", "y")
#: Features a kernel can build per cell (rho, jx, jy, h, hx, hy, Ls).
N_FEAT = 7

#: Kernel launches per wrapper since the last reset (the twins count
#: nothing); ``gp_steps`` counts one per step it launches.
LAUNCHES = {"gp_step": 0, "gp_step_bc": 0, "gp_steps": 0, "gp_fields": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _dims_ok(active_dims, use_gp):
    return all(not used or (dims is not None
                            and all(0 <= d < N_FEAT for d in dims))
               for dims, used in zip(active_dims, use_gp))


def gp_kernel_supported(cfg, active_dims, use_gp):
    """Coverage of :func:`gp_step` / :func:`gp_steps`: a static pass
    order, fully periodic edges, no shear thinning, and every used
    surrogate's features among the 7 built-ins.  Unlike the TPU kernel
    the grid needs no alignment; the dtype (float32) and device (CUDA)
    are checked by the caller."""
    return (pallas_supported(cfg) and _fully_periodic(cfg)
            and cfg.thinning is None and _dims_ok(active_dims, use_gp))


def gp_bc_kernel_supported(cfg, active_dims, use_gp):
    """Coverage of :func:`gp_step_bc`: a static pass order, uniform edges
    (each fully periodic or without a periodic component) that are not
    all periodic, no shear thinning, features among the 7 built-ins."""
    return (pallas_supported(cfg) and not _fully_periodic(cfg)
            and cfg.thinning is None and _dims_ok(active_dims, use_gp))


# ---------------------------------------------------------------------------
# Operands
# ---------------------------------------------------------------------------

class GPOps:
    """Per-surrogate kernel operands (the ``_prep_gp_ops`` layout, one
    entry per used surrogate key): ``dims``, ``coef`` (d,), ``Wm2``
    (cap, d), ``w2`` (cap,), ``alpha`` (cap, n_out), in one dtype on one
    device.  :meth:`device_args` packs them for the CUDA entry points.
    With no surrogate (a deterministic step through the GP kernel, as the
    pass-2 EHL route takes it) the kernel evaluates the EOS pressure and
    the analytic wall stresses."""

    def __init__(self, models, device):
        self.models = models          # key -> (dims, coef, Wm2, w2, alpha)
        self.device = torch.device(device)
        self._packed = None
        self._floats = None

    def floats(self):
        """The operands as Python floats (the twins multiply by them; a
        float of the operands' dtype multiplies exactly as the tensor
        element does)."""
        if self._floats is None:
            self._floats = {k: (dims, *(t.tolist() for t in arrs))
                            for k, (dims, *arrs) in self.models.items()}
        return self._floats

    def planes(self):
        """Field planes of the used surrogates' outputs (z 1, x 2, y 2)."""
        return sum(self.models[k][4].shape[1] for k in KEYS
                   if k in self.models)

    def device_args(self):
        """(meta int32, coef float32, data) for the CUDA entry points:
        per key z, x, y, ``meta`` holds used, d, cap, n_out, the offset
        of its rows in ``data`` and 7 feature indices; ``coef`` 7
        coefficients; ``data`` (float32, on the device) each surrogate's
        (cap, s) rows [Wm2 row, w2, alpha row, zeros], s = d + 1 + n_out
        rounded up to a multiple of 4 (16-byte rows)."""
        if self._packed is None:
            meta = np.zeros((3, 12), dtype=np.int32)
            coef = np.zeros((3, N_FEAT), dtype=np.float32)
            rows, off = [], 0
            for m, key in enumerate(KEYS):
                if key not in self.models:
                    continue
                dims, c, Wm2, w2, alpha = self.models[key]
                cap, d = Wm2.shape
                n_out = alpha.shape[1]
                if not (1 <= d <= N_FEAT and n_out in (1, 2) and
                        all(0 <= i < N_FEAT for i in dims)):
                    raise ValueError(f"the GP kernels take 1-{N_FEAT} of "
                                     f"the built-in features and 1-2 "
                                     f"outputs, got dims {dims}, {n_out} "
                                     f"outputs ({key})")
                pad = -(d + 1 + n_out) % 4
                r = torch.cat([Wm2, w2[:, None], alpha,
                               Wm2.new_zeros((cap, pad))], dim=1)
                meta[m, :5] = [1, d, cap, n_out, off]
                meta[m, 5:5 + d] = dims
                coef[m, :d] = c.cpu().numpy()
                rows.append(r.reshape(-1))
                off += r.numel()
            data = (torch.cat(rows) if rows else
                    torch.zeros(4, device=self.device)).to(torch.float32) \
                .contiguous()
            self._packed = (meta, coef, data)
        return self._packed


def prep_gp_ops(gp_state, active_dims, use_gp):
    """The kernel operands of a padded GP state (layout of
    ``core.gp_step``: ``Xscale``, per used key ``params_k``, ``Xfit_k``,
    ``alpha_k``, ``Yscale_k``), in the state's dtype and on its device.

    As the JAX package's ``_prep_gp_ops``: ``Ws = sqrt(3) Xfit / ls``,
    ``Wm2 = -2 Ws``, ``w2 = |Ws|^2 + 3e-14``, ``coef = sqrt(3) / ls /
    Xscale[dims]`` and alpha scaled by amp * Yscale."""
    models = {}
    for key, dims, used in zip(KEYS, active_dims, use_gp):
        if not used:
            continue
        params = gp_state[f"params_{key}"]
        Xfit = gp_state[f"Xfit_{key}"]
        alpha = gp_state[f"alpha_{key}"]
        inv_ls = torch.exp(-params["log_scale"])
        amp = torch.exp(params["log_amp"])
        Ws = _SQRT3 * Xfit * inv_ls[None, :]
        Wm2 = -2. * Ws
        w2 = torch.sum(Ws * Ws, dim=1) + 3e-14
        idx = torch.as_tensor(list(dims), device=Xfit.device)
        coef = _SQRT3 * inv_ls / gp_state["Xscale"][idx]
        a = alpha if alpha.ndim == 2 else alpha[:, None]
        a = a * (amp * gp_state[f"Yscale_{key}"])
        models[key] = (tuple(dims), coef, Wm2, w2, a)
    return GPOps(models, gp_state["Xscale"].device)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _features7(q0, q1, q2, st):
    """The 7 built-in feature columns (rho, jx, jy, h, hx, hy, Ls)."""
    return (q0, q1, q2, st[2], st[0], st[1], 0.5 * st[3])


def _gp_mean(feats, model):
    """Matern-3/2 GP mean(s) of one surrogate over the cells, in the
    kernel's order (training points in sequence)."""
    dims, coef, Wm2, w2, alpha = model
    xs = [feats[d] * coef[i] for i, d in enumerate(dims)]
    x2 = 0.
    for x in xs:
        x2 = x2 + x * x
    acc = [torch.zeros_like(feats[0]) for _ in alpha[0]]
    for j in range(len(Wm2)):
        dot = 0.
        for x, w in zip(xs, Wm2[j]):
            dot = dot + x * w
        arg = torch.sqrt(torch.clamp(x2 + dot + w2[j], min=3e-14))
        e = torch.exp(-arg)
        kj = e + arg * e
        for m, a in enumerate(alpha[j]):
            acc[m] = acc[m] + kj * a
    return acc


def gp_fields_ref(q, statics, ops):
    """Plain torch twin of :func:`gp_fields`: ``{key: (n_out, a, b)}``
    means of each used surrogate at every cell of ``q`` (3, a, b) with
    ``statics`` (8, a, b)."""
    models = ops.floats()
    feats = _features7(q[0], q[1], q[2], statics)
    return {k: torch.stack(_gp_mean(feats, models[k])) for k in KEYS
            if k in models}


def _one_pass_gp(cfg, ops, q0, q1, q2, st, dt, d):
    """One MacCormack pass with GP closures (``_one_pass_gp``), on the
    periodic interior or on a ghost-inclusive layout (the rolls' wrap then
    reaches only ghost cells, which the caller refills).  Returns the
    update ``u`` (``q_new = q - u``) and the pressure."""
    models = ops.floats()
    feats = _features7(q0, q1, q2, st)
    if "z" in models:
        (p,) = _gp_mean(feats, models["z"])
    else:
        p = eos_pressure(q0, cfg.prop)
    eta = effective_viscosity(cfg, q0, p, st[2])
    tb_xx, tb_yy, tb_xy, S0, S1, S2 = fused_pass_top_pre(
        q0, q1, q2, st, cfg.U, cfg.V, eta, cfg.bulk)

    if "x" in models or "y" in models:
        # the analytic wall stresses of the factored pass, replaced by the
        # GP's (lower, upper) through the sources
        Hx, Hy, H, Ls2, inv_h, ic, _k2s, Ls6 = st
        ir = 1. / q0
        g = ic * ir
        e2g = 2. * eta * g
        Ur = cfg.U * q0
        Vr = cfg.V * q0
        if "x" in models:
            su_det = -e2g * (3. * q1 - Ur)
            sl_det = e2g * (Ls6 * (q1 - Ur)
                            + H * (3. * q1 - 2. * Ur)) * inv_h
            lo, up = _gp_mean(feats, models["x"])
            S1 = S1 + ((up - su_det) - (lo - sl_det)) * inv_h
        if "y" in models:
            su_det = -e2g * (3. * q2 - Vr)
            sl_det = e2g * (Ls6 * (q2 - Vr)
                            + H * (3. * q2 - 2. * Vr)) * inv_h
            lo, up = _gp_mean(feats, models["y"])
            S2 = S2 + ((up - su_det) - (lo - sl_det)) * inv_h

    rdx = 1. / cfg.dx
    rdy = 1. / cfg.dy

    def ddx(F):
        return -d * (torch.roll(F, d, dims=0) - F) * rdx

    def ddy(F):
        return -d * (torch.roll(F, d, dims=1) - F) * rdy

    u0 = dt * (ddx(q1) + ddy(q2) - S0)
    u1 = dt * (ddx(p + tb_xx) + ddy(tb_xy) - S1)
    u2 = dt * (ddx(tb_xy) + ddy(p + tb_yy) - S2)
    return (u0, u1, u2), p


def _gp_step_layout(cfg, ops, q, statics, dt, refill=None):
    """Pass d0, ``refill`` of the ghosts (ghost-inclusive layout), pass
    d1, the average.  Returns (new state, pass-2 pressure) on the layout
    of ``q``."""
    d0, d1 = mc_directions(cfg.MC_order)
    st = tuple(statics)
    dt = float(dt)
    u, _ = _one_pass_gp(cfg, ops, q[0], q[1], q[2], st, dt, d0)
    pred = torch.stack([a - b for a, b in zip(q, u)])
    if refill is not None:
        pred = refill(pred)
    u, p = _one_pass_gp(cfg, ops, pred[0], pred[1], pred[2], st, dt, d1)
    out = torch.stack([((a - du) + b) / 2. for a, b, du in zip(pred, q, u)])
    return out, p


def gp_step_ref(q_int, statics, dt, cfg, ops, need_p=True):
    """Plain torch twin of :func:`gp_step`: ``(q_new, p)`` on the periodic
    interior (``p`` None unless ``need_p``)."""
    out, p = _gp_step_layout(cfg, ops, q_int, statics, dt)
    return out, (p if need_p else None)


def gp_step_bc_ref(q_int, statics_g, dt, cfg, ops, need_p=False):
    """Plain torch twin of :func:`gp_step_bc`: the ghosts of ``q_int``
    from the edge formulas, refilled by them between the passes."""
    out, p = _gp_step_layout(cfg, ops, with_ghosts(q_int, cfg), statics_g,
                             dt, lambda q: apply_bcs(q, cfg))
    out = out[:, 1:-1, 1:-1].contiguous()
    return (out, p) if need_p else out


def gp_steps_ref(q_int, statics, dt, cfg, ops, n):
    """Plain torch twin of :func:`gp_steps`: ``n`` twin steps."""
    for _ in range(n):
        q_int, _ = gp_step_ref(q_int, statics, dt, cfg, ops)
    return q_int


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_gp(q, statics, ghosted):
    _, nx, ny = q.shape
    g = 2 if ghosted else 0
    _check_tensors(q, (q, (3, nx, ny)),
                   (statics, (N_STATIC, nx + g, ny + g)))
    return nx, ny


def _launch_args(q, cfg, ops):
    iprm, fprm = _kernel_params(cfg)
    bprm, bfprm = _bc_params(cfg)
    meta, coef, data = ops.device_args()
    if data.device != q.device:
        raise ValueError(f"GP operands on {data.device}, state on {q.device}")
    d0, _ = mc_directions(cfg.MC_order)
    return (d0, iprm.ctypes.data, fprm.ctypes.data, bprm.ctypes.data,
            bfprm.ctypes.data, meta.ctypes.data, coef.ctypes.data,
            data.data_ptr())


def _scratch(q, ops, g):
    """The kernels' scratch for one step on the layout (g = 1:
    ghost-inclusive): the predictor's 3 planes, then the fields' planes."""
    _, nx, ny = q.shape
    return torch.empty((3 + ops.planes(), nx + 2 * g, ny + 2 * g),
                       dtype=q.dtype, device=q.device)


def kernel_launches(ops):
    """Device launches of one step: the two passes, and the means before
    each where a surrogate is used."""
    return 4 if ops.models else 2


def gp_step(q_int, statics, dt, cfg, ops, need_p=True):
    """One GP-closed MacCormack step on the periodic interior state.

    ``q_int``: (3, nx, ny); ``statics``: (8, nx, ny) from
    :func:`ops.stencil.interior_statics`; ``ops`` from
    :func:`prep_gp_ops`.  Returns ``(q_new, p)``, ``p`` the pass-2
    pressure (nx, ny), or None with ``need_p=False``.  CUDA tensors
    (float32) launch the kernels; CPU tensors run :func:`gp_step_ref`."""
    if _on_cpu(q_int):
        return gp_step_ref(q_int, statics, dt, cfg, ops, need_p)
    if not gp_kernel_supported(cfg, *_dims_use(ops)):
        raise ValueError("gp_step does not cover this configuration "
                         "(see gp_kernel_supported)")
    nx, ny = _check_gp(q_int, statics, False)
    args = _launch_args(q_int, cfg, ops)
    out = torch.empty_like(q_int)
    p = torch.empty_like(q_int[0]) if need_p else None
    scratch = _scratch(q_int, ops, 0)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_gp_step(q_int.data_ptr(), statics.data_ptr(),
                            out.data_ptr(), None if p is None else p.data_ptr(),
                            scratch.data_ptr(), nx, ny, 0, *args, float(dt),
                            stream)
    _build.check(lib, rc, "gf_gp_step")
    LAUNCHES["gp_step"] += 1
    return out, p


def gp_step_bc(q_int, statics_g, dt, cfg, ops, need_p=False):
    """One GP-closed step on uniform D/N edges (periodic on at most one
    axis): the ghosts of ``q_int`` from the edge formulas, refilled from
    the predictor between the passes.  ``statics_g``: (8, nx+2, ny+2)
    from :func:`ops.stencil.ghost_statics`.  Returns the new interior
    state, with ``need_p`` also the pass-2 pressure (nx+2, ny+2), its
    ghost ring evaluated on the refilled ghosts.  CUDA tensors (float32)
    launch the kernels; CPU tensors run :func:`gp_step_bc_ref`."""
    if _on_cpu(q_int):
        return gp_step_bc_ref(q_int, statics_g, dt, cfg, ops, need_p)
    if not gp_bc_kernel_supported(cfg, *_dims_use(ops)):
        raise ValueError("gp_step_bc does not cover this configuration "
                         "(see gp_bc_kernel_supported)")
    nx, ny = _check_gp(q_int, statics_g, True)
    args = _launch_args(q_int, cfg, ops)
    out = torch.empty_like(q_int)
    p = (torch.empty((nx + 2, ny + 2), dtype=q_int.dtype,
                     device=q_int.device) if need_p else None)
    scratch = _scratch(q_int, ops, 1)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_gp_step(q_int.data_ptr(), statics_g.data_ptr(),
                            out.data_ptr(),
                            None if p is None else p.data_ptr(),
                            scratch.data_ptr(), nx, ny, 1, *args, float(dt),
                            stream)
    _build.check(lib, rc, "gf_gp_step (bc)")
    LAUNCHES["gp_step_bc"] += 1
    return (out, p) if need_p else out


def gp_steps(q_int, statics, dt, cfg, ops, n):
    """``n`` frozen-GP periodic steps (:func:`gp_step` without the
    pressure output) from a loop in C that ping-pongs two buffers.  The
    input is not modified.  CUDA tensors (float32) launch the kernels;
    CPU tensors run :func:`gp_steps_ref`."""
    if _on_cpu(q_int):
        return gp_steps_ref(q_int, statics, dt, cfg, ops, n)
    if not gp_kernel_supported(cfg, *_dims_use(ops)):
        raise ValueError("gp_steps does not cover this configuration "
                         "(see gp_kernel_supported)")
    nx, ny = _check_gp(q_int, statics, False)
    if n == 0:
        return q_int
    args = _launch_args(q_int, cfg, ops)
    bufs = torch.empty((2, 3, nx, ny), dtype=q_int.dtype,
                       device=q_int.device)
    scratch = _scratch(q_int, ops, 0)
    lib = _build.load()
    with torch.cuda.device(q_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_gp_steps(q_int.data_ptr(), statics.data_ptr(),
                             bufs[0].data_ptr(), bufs[1].data_ptr(),
                             scratch.data_ptr(), nx, ny, int(n), *args,
                             float(dt), stream)
    _build.check(lib, rc, "gf_gp_steps")
    LAUNCHES["gp_steps"] += n
    return bufs[(n - 1) % 2]


def gp_fields(q, statics, ops):
    """The used surrogates' GP means at every cell of ``q`` (3, a, b)
    with ``statics`` (8, a, b): ``{key: (n_out, a, b)}``, the kernel the
    steps launch before each pass, on its own.  CUDA tensors (float32)
    launch it; CPU tensors run :func:`gp_fields_ref`."""
    if _on_cpu(q):
        return gp_fields_ref(q, statics, ops)
    _, a, b = q.shape
    _check_tensors(q, (q, (3, a, b)), (statics, (N_STATIC, a, b)))
    meta, coef, data = ops.device_args()
    if data.device != q.device:
        raise ValueError(f"GP operands on {data.device}, state on {q.device}")
    out = torch.empty((ops.planes(), a, b), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_gp_fields(q.data_ptr(), statics.data_ptr(),
                              out.data_ptr(), a, b, meta.ctypes.data,
                              coef.ctypes.data, data.data_ptr(), stream)
    _build.check(lib, rc, "gf_gp_fields")
    LAUNCHES["gp_fields"] += 1
    fields, i = {}, 0
    for k in KEYS:
        if k in ops.models:
            m = ops.models[k][4].shape[1]
            fields[k] = out[i:i + m]
            i += m
    return fields


def sqrt_pair(x):
    """The kernels' written-out sqrt and ``sqrtf`` of the float32 CUDA
    tensor ``x``, computed on the card: (fast, sqrtf)."""
    if _on_cpu(x):
        raise ValueError("sqrt_pair runs on the card only")
    x = x.contiguous()
    fast, ref = torch.empty_like(x), torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.gf_sqrt_pair(x.data_ptr(), fast.data_ptr(), ref.data_ptr(),
                              x.numel(), torch.cuda.current_stream()
                              .cuda_stream)
    _build.check(lib, rc, "gf_sqrt_pair")
    return fast, ref


def _dims_use(ops):
    dims = tuple(ops.models[k][0] if k in ops.models else None for k in KEYS)
    return dims, tuple(k in ops.models for k in KEYS)
