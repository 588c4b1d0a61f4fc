"""Non-Newtonian viscosity models: piezoviscosity and shear thinning.

All functions are branch-free torch functions on tensors.

Counterpart of :mod:`gapflow_tpu.models.viscosity` (same models/defaults).
"""

import math

import torch

from .eos import true_div

__all__ = ["piezoviscosity", "shear_thinning_factor", "shear_rate_avg",
           "srate_wall_newton"]


# ---------------------------------------------------------------------------
# Piezoviscosity (pressure- or density-dependent viscosity)
# ---------------------------------------------------------------------------

def barus_piezo(p, mu0, aB=2.e-8, **_):
    """Barus law mu(p) = mu0 exp(aB p)."""
    return mu0 * torch.exp(aB * p)


def roelands_piezo(p, mu0, mu_inf=1.e-3, p_ref=1.96e8, z=0.68, **_):
    """Roelands empirical piezoviscosity."""
    return mu0 * torch.exp(math.log(mu0 / mu_inf)
                           * (-1. + (1. + true_div(p, p_ref)) ** z))


def dukler_mixture(rho, eta_l, eta_v=3.9e-5, rho_l=850., rho_v=0.019, **_):
    """Linear (Dukler) two-phase mixture viscosity; input is density."""
    alpha = true_div(rho - rho_l, rho_v - rho_l)
    return alpha * eta_v + (1. - alpha) * eta_l


def mc_adams_mixture(rho, eta_l, eta_v=3.9e-5, rho_l=850., rho_v=0.019, **_):
    """McAdams two-phase mixture viscosity; input is density."""
    alpha = true_div(rho - rho_l, rho_v - rho_l)
    M = alpha * rho_v / rho
    return eta_v * eta_l / (eta_l * M + eta_v * (1. - M))


_PIEZO = {
    "Barus": barus_piezo,
    "Roelands": roelands_piezo,
    "Dukler": dukler_mixture,
    "McAdams": mc_adams_mixture,
}


def piezoviscosity(p, mu0, piezo_dict):
    """Dispatch to the piezoviscosity model named in ``piezo_dict['name']``.

    ``p`` is the pressure field (or density, for the cavitation mixture
    models paired with the Bayada-Chupin EOS).
    """
    func = _PIEZO.get(piezo_dict["name"])
    if func is None:
        return torch.ones_like(torch.as_tensor(p)) * mu0
    kwargs = {k: v for k, v in piezo_dict.items() if k != "name"}
    return func(torch.as_tensor(p), mu0, **kwargs)


# ---------------------------------------------------------------------------
# Shear thinning
# ---------------------------------------------------------------------------

def _asinh(x):
    """arcsinh via the well-conditioned log1p identity (x >= 0 here); the
    same form as the JAX package, so the two agree to rounding."""
    return torch.log1p(x + x * x / (1. + torch.sqrt(1. + x * x)))


def eyring_shear(shear_rate, mu0, tauE=5.e5, **_):
    """Eyring shear thinning; returns mu(gamma)/mu0 ... times mu0 (factor)."""
    tau0 = mu0 * shear_rate
    return true_div(tauE, tau0) * _asinh(true_div(tau0, tauE))


def carreau_shear(shear_rate, mu0, mu_inf=1.e-3, lam=0.02, a=2, N=0.8, **_):
    """Carreau shear thinning, normalized by mu0."""
    mu = mu_inf + (mu0 - mu_inf) * (1. + (lam * shear_rate) ** a) ** ((N - 1.) / a)
    return true_div(mu, mu0)


_THINNING = {
    "Eyring": eyring_shear,
    "Carreau": carreau_shear,
}


def shear_thinning_factor(shear_rate, mu0, thinning_dict):
    """Multiplicative viscosity correction factor for the named model."""
    func = _THINNING.get(thinning_dict["name"])
    if func is None:
        return torch.ones_like(torch.as_tensor(shear_rate))
    kwargs = {k: v for k, v in thinning_dict.items() if k != "name"}
    return func(torch.as_tensor(shear_rate), mu0, **kwargs)


# ---------------------------------------------------------------------------
# Shear-rate estimates (Newtonian profile assumption)
# ---------------------------------------------------------------------------

def srate_wall_newton(dp_dx, h=1., u1=1., u2=0., mu=1.):
    """Newtonian wall shear rates (bottom, top) for combined Couette/Poiseuille."""
    duPois = true_div(h * dp_dx, 2. * mu)
    duCarr = true_div(u2 - u1, h)
    return -duPois + duCarr, duPois + duCarr


def shear_rate_avg(dp_dx, dp_dy, h, u1, u2, mu):
    """Mean magnitude of the wall shear rates, from |grad p| and wall speeds."""
    grad_p = torch.hypot(dp_dx, dp_dy)
    sr_bot, sr_top = srate_wall_newton(grad_p, h, u1, u2, mu)
    return (torch.abs(sr_top) + torch.abs(sr_bot)) / 2.
