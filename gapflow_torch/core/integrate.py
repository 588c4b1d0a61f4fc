"""Flux and source terms of the gap-averaged balance equations (torch).

The one-sided MacCormack flux differences, hyperbolic and diffusive fluxes,
and the geometric source term of Eq. (11) in Holey et al., Tribology
Letters 70 (2022).

Counterpart of :mod:`gapflow_tpu.core.integrate`.  All functions are pure
functions of tensors.
"""

import torch

__all__ = ["predictor_corrector", "source", "hyperbolicFlux", "diffusiveFlux"]


def hyperbolicFlux(q, p):
    """Advective fluxes: Fx = (jx, p, 0), Fy = (jy, 0, p)."""
    zero = torch.zeros_like(p)
    Fx = torch.stack([q[1], p, zero])
    Fy = torch.stack([q[2], zero, p])
    return Fx, Fy


def diffusiveFlux(q, tau):
    """Viscous fluxes from the gap-averaged stress tau = (xx, yy, xy)."""
    zero = torch.zeros_like(tau[0])
    Dx = torch.stack([zero, tau[0], tau[2]])
    Dy = torch.stack([zero, tau[2], tau[1]])
    return Dx, Dy


def predictor_corrector(q, p, tau, direction):
    """One-sided MacCormack flux differences.

    ``direction`` = +1/-1 selects the upwind/downwind shift; the caller
    alternates directions between the predictor and corrector passes.
    Returns (flux_x, flux_y), each shape (3, nx, ny).
    """
    FxH, FyH = hyperbolicFlux(q, p)
    FxD, FyD = diffusiveFlux(q, tau)

    Fx = FxH + FxD
    Fy = FyH + FyD

    flux_x = -direction * (torch.roll(Fx, direction, dims=1) - Fx)
    flux_y = -direction * (torch.roll(Fy, direction, dims=2) - Fy)

    return flux_x, flux_y


def source(q, h, stress, stress_lower, stress_upper):
    """Geometric source term of the gap-averaged balance equations.

    ``h``: (>=3, nx, ny) gap height and slopes; ``stress``: (3, nx, ny)
    gap-averaged viscous stress; ``stress_lower``/``stress_upper``:
    (6, nx, ny) Voigt wall stresses.  Origin at the bottom wall; the top wall
    is static (U_top = 0) and the bottom wall moves with (U, V).
    """
    s0 = (-q[1] * h[1] - q[2] * h[2]) / h[0]

    s1 = ((stress[0] - stress_upper[0]) * h[1]
          + (stress[2] - stress_upper[5]) * h[2]
          + stress_upper[4] - stress_lower[4]) / h[0]

    s2 = ((stress[2] - stress_upper[5]) * h[1]
          + (stress[1] - stress_upper[1]) * h[2]
          + stress_upper[3] - stress_lower[3]) / h[0]

    return torch.stack([s0, s1, s2])
