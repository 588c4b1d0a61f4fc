"""Hand-factored hot-path closures (slip-top mode, no state gradients).

The sympy-generated expressions in ``_closures.py`` are exact but live as
wide unfactored polynomials (~90 CSE temporaries).  This module provides
the same quantities in factored form (~25 multiply-adds per cell),
derived by grouping the generated polynomials:

with  g  = 1 / (rho (4 Ls + h)),
      ax = 3 jx - U rho,          ay = 3 jy - V rho,
      bx = 2 Ls (U rho - jx) + h jx,   by = 2 Ls (V rho - jy) + h jy,
      v1 = zeta + 4/3 eta,        v2 = zeta - 2/3 eta:

bulk (gap-averaged) stress:   tb_ij = combinations of (bx, by) * g / h
top-wall stress:              su_ij = 2 (3Ls+h) g/(4Ls+h) * (ax, ay) terms
wall shear:                   su_xz = -2 eta g ax,
                              sl_xz =  2 eta g (6 Ls (jx - U rho)
                                                + h (3 jx - 2 U rho)) / h

Counterpart of :mod:`gapflow_tpu.models.closures_opt`; the CUDA kernel in
``csrc/stencil.cu`` evaluates :func:`fused_pass_top_pre` in the same
order.  Equality with the JAX package is asserted by
tests/test_torch_models.py to 1e-12.
"""

import torch

__all__ = ["fused_pass_top_pre", "precompute_statics", "N_STATIC"]


# ---------------------------------------------------------------------------
# Static-precomputation variant (the fused kernel's hot path)
# ---------------------------------------------------------------------------
#
# Everything built purely from the (static) topography and slip-length
# fields is computed once per run; the per-step kernel is left with exactly
# one reciprocal per cell (1/rho) plus the EOS.

N_STATIC = 8


def precompute_statics(topo, extra):
    """Static per-cell channels for :func:`fused_pass_top_pre`.

    topo: (>=3, ...) height and slopes; extra: (n, ...) slip length in
    channel 0.  Returns an (8, ...) array:
      [Hx, Hy, H, 2*Ls, 1/h, 1/(4Ls+h), 2(3Ls+h)/(4Ls+h)^2, 6*Ls]
    """
    H, Hx, Hy = topo[0], topo[1], topo[2]
    Ls = extra[0]
    ic = 1. / (4. * Ls + H)
    return torch.stack([
        Hx,
        Hy,
        H,
        2. * Ls,
        1. / H,
        ic,
        2. * (3. * Ls + H) * ic * ic,
        6. * Ls,
    ])


def fused_pass_top_pre(q0, q1, q2, st, U, V, eta, zeta):
    """Bulk stresses and source terms of the deterministic MacCormack pass.

    Returns (tb_xx, tb_yy, tb_xy, S0, S1, S2), identical to
    ``_closures._fused_pass_top``, with static per-cell factors
    (reciprocals etc.) taken from :func:`precompute_statics`.

    Exactly one dynamic reciprocal per cell (1/rho)."""
    Hx, Hy, H, Ls2, inv_h, ic, k2s, Ls6 = st

    v1 = zeta + 4. / 3. * eta
    v2 = zeta - 2. / 3. * eta

    ir = 1. / q0
    g = ic * ir

    Ur = U * q0
    Vr = V * q0
    ax = 3. * q1 - Ur
    ay = 3. * q2 - Vr
    bx = Ls2 * (Ur - q1) + H * q1
    by = Ls2 * (Vr - q2) + H * q2

    gh = g * inv_h
    hxbx = Hx * bx
    hyby = Hy * by
    tb_xx = (v1 * hxbx + v2 * hyby) * gh
    tb_yy = (v2 * hxbx + v1 * hyby) * gh
    tb_xy = eta * (Hy * bx + Hx * by) * gh

    k2 = k2s * ir
    hxax = Hx * ax
    hyay = Hy * ay
    su_xx = k2 * (v1 * hxax + v2 * hyay)
    su_yy = k2 * (v2 * hxax + v1 * hyay)
    su_xy = k2 * eta * (Hy * ax + Hx * ay)

    e2g = 2. * eta * g
    su_xz = -e2g * ax
    su_yz = -e2g * ay
    sl_xz = e2g * (Ls6 * (q1 - Ur) + H * (3. * q1 - 2. * Ur)) * inv_h
    sl_yz = e2g * (Ls6 * (q2 - Vr) + H * (3. * q2 - 2. * Vr)) * inv_h

    S0 = (-q1 * Hx - q2 * Hy) * inv_h
    S1 = ((tb_xx - su_xx) * Hx + (tb_xy - su_xy) * Hy + su_xz - sl_xz) * inv_h
    S2 = ((tb_xy - su_xy) * Hx + (tb_yy - su_yy) * Hy + su_yz - sl_yz) * inv_h

    return tb_xx, tb_yy, tb_xy, S0, S1, S2
