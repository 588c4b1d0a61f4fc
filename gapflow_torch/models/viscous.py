"""Viscous stress tensor closures (public API over generated expressions).

Closed-form (generalized) Newtonian stress tensor components at the bottom
wall, top wall, and averaged across the gap, as functions of the gap-averaged
state ``q = (rho, jx, jy)``, the gap profile ``h = (h, dh/dx, dh/dy)``, wall
velocities, viscosities and slip length.

The expressions are symbolically derived (codegen/derive_closures.py) and
shared verbatim with the JAX package (``_closures.py`` is plain arithmetic,
so it runs on torch tensors as it is); this module provides the slip-mode
dispatch and tensor plumbing.  Matching the JAX package, ``slip="top"``
(no-slip bottom / slip top, the solver default) uses the slip-top closure;
any other value uses the slip-both closure (no-slip for Ls=0).
"""

import torch

from . import _closures as _C

__all__ = ["stress_bottom", "stress_top", "stress_avg"]


def _unpack(q, h, dqx, dqy):
    if dqx is None and dqy is None:
        # hot path: no state gradients -> use the specialized closures
        return (q[0], q[1], q[2], h[0], h[1], h[2]), True
    if dqx is None:
        dqx = torch.zeros_like(q)
    if dqy is None:
        dqy = torch.zeros_like(q)
    return (q[0], q[1], q[2], h[0], h[1], h[2],
            dqx[0], dqx[1], dqx[2], dqy[0], dqy[1], dqy[2]), False


def _normalize_ls(Ls, q):
    """Allow the slip length to come in as the (1, nx, ny) extra field."""
    if torch.is_tensor(Ls) and Ls.ndim == q[0].ndim + 1 and Ls.shape[0] == 1:
        return Ls[0]
    return Ls


def _stack6(parts, like):
    return torch.stack([torch.as_tensor(p, dtype=like.dtype,
                                        device=like.device).expand(like.shape)
                        for p in parts])


def _like(q, h, Ls):
    """Broadcast template of the closure outputs (shape, dtype, device)."""
    return q[0] + h[0] + Ls * 0


def _dispatch(table, slip, nodq):
    # 'top' is special-cased, everything else takes the slip-both
    # expressions (identical to no-slip when Ls == 0).
    mode = "top" if slip == "top" else "both"
    return table[mode + "_nodq" if nodq else mode]


_MODES = ("none", "top", "bottom", "both")
_BOTTOM = {m + s: getattr(_C, f"_tau_bottom_{m}{s and '_nodq'}")
           for m in _MODES for s in ("", "_nodq")}
_TOP = {m + s: getattr(_C, f"_tau_top_{m}{s and '_nodq'}")
        for m in _MODES for s in ("", "_nodq")}
_AVG = {m + s: getattr(_C, f"_tau_avg_{m}{s and '_nodq'}")
        for m in _MODES for s in ("", "_nodq")}


def stress_bottom(q, h, U, V, eta, zeta, Ls, dqx=None, dqy=None, slip="top"):
    """Viscous stress tensor at the bottom wall, Voigt order (xx,yy,zz,yz,xz,xy).

    ``q``: (3, ...) gap-averaged state; ``h``: (3, ...) height and slopes;
    ``eta``/``zeta``: shear/bulk viscosity (scalar or field); ``Ls``: slip
    length (scalar or field).  Returns shape (6, ...).
    """
    Ls = _normalize_ls(Ls, q)
    args, nodq = _unpack(q, h, dqx, dqy)
    parts = _dispatch(_BOTTOM, slip, nodq)(*args, U, V, eta, zeta, Ls)
    return _stack6(parts, _like(q, h, Ls))


def stress_top(q, h, U, V, eta, zeta, Ls, dqx=None, dqy=None, slip="top"):
    """Viscous stress tensor at the top wall, Voigt order (xx,yy,zz,yz,xz,xy)."""
    Ls = _normalize_ls(Ls, q)
    args, nodq = _unpack(q, h, dqx, dqy)
    parts = _dispatch(_TOP, slip, nodq)(*args, U, V, eta, zeta, Ls)
    return _stack6(parts, _like(q, h, Ls))


def stress_avg(q, h, U, V, eta, zeta, Ls, dqx=None, dqy=None, slip="top"):
    """Gap-averaged in-plane viscous stress, component order (xx, yy, xy).

    Returns shape (3, ...).  For slip modes other than 'top'/'both' the
    result is zero, as in the JAX package.
    """
    Ls = _normalize_ls(Ls, q)
    like = _like(q, h, Ls)
    if slip not in ("top", "both"):
        return torch.zeros((3,) + tuple(like.shape), dtype=like.dtype,
                           device=like.device)
    args, nodq = _unpack(q, h, dqx, dqy)
    t = _AVG[slip + ("_nodq" if nodq else "")](*args, U, V, eta, zeta, Ls)
    return _stack6((t[0], t[1], t[5]), like)
