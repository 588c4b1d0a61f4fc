"""Analytic z-resolved velocity and stress profiles across the gap.

Used to verify that the gap-averaged closures of
:mod:`gapflow_torch.models.viscous` are consistent with the underlying
velocity-profile ansatz (flux consistency, wall values, gap averages).

Counterpart of :mod:`gapflow_tpu.models.profiles` (same signatures; the
expressions are the generated ones of ``_closures.py``).
"""

import torch

from . import _closures as _C

__all__ = ["get_velocity_profiles", "get_stress_profiles"]

_MODES = ("none", "top", "bottom", "both")


def get_velocity_profiles(z, q, Ls=0.0, U=1.0, V=0.0, slip="both"):
    """Velocity profiles u(z), v(z) for given gap-averaged state.

    ``z``: gap coordinate tensor spanning [0, h] (h is taken as z[-1]);
    ``q``: (3,) or (3, nx, ny) gap-averaged state; ``slip``: one of
    'none'/'top'/'bottom'/'both'.
    """
    if slip not in _MODES:
        raise ValueError(f"slip must be one of {_MODES}")
    z = torch.as_tensor(z)
    h = z[-1]
    fn = getattr(_C, f"_vel_{slip}")
    u = fn(z, q[0], q[1], h, U, Ls)
    v = fn(z, q[0], q[2], h, V, Ls)
    return u, v


def get_stress_profiles(z, h, q, dqx, dqy, U=1.0, V=0.0, eta=1.0, zeta=1.0,
                        Ls=0, mode="both"):
    """Viscous stress tensor profiles tau_ij(z).

    Returns the tuple (tau_xx, tau_yy, tau_zz, tau_yz, tau_xz, tau_xy), each
    evaluated on the given z tensor.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}")
    z = torch.as_tensor(z)
    fn = getattr(_C, f"_tau_profile_{mode}")
    parts = fn(z, q[0], q[1], q[2], h[0], h[1], h[2],
               dqx[0], dqx[1], dqx[2], dqy[0], dqy[1], dqy[2],
               U, V, eta, zeta, Ls)
    return tuple(torch.as_tensor(p, dtype=z.dtype).expand(z.shape)
                 for p in parts)
