"""Equations of state: pressure p(rho) and isothermal sound speed c(rho).

Seven EOS families, all expressed as branch-free torch functions on
tensors.  The fused CUDA kernel (``csrc/stencil.cu``) evaluates the same
formulas per cell; :func:`_bwr_terms` is shared with it through the host
parameter block built in :mod:`gapflow_torch.ops.stencil`.

Counterpart of :mod:`gapflow_tpu.models.eos` (same models, parameters
and defaults).
"""

import math

import torch
from scipy.constants import gas_constant

__all__ = ["eos_pressure", "eos_sound_velocity", "true_div"]


def true_div(a, b):
    """``a / b`` rounded once, on every device.

    With a Python number as divisor, torch's CUDA backend multiplies by the
    number's rounded reciprocal, and ``number / tensor`` is
    ``tensor.reciprocal() * number`` on every device: a second rounding.
    In float32 the DH EOS's ``r - 1`` cancellation amplifies that one ulp
    to about half a percent of a journal bearing's pressure amplitude.
    Passing the number as a 0-d tensor on the other operand's device keeps
    one IEEE division, as in the CUDA kernel and the JAX package.
    """
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    elif not torch.is_tensor(b):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


# Benedict-Webb-Rubin modified (32-coefficient) constants for the
# Lennard-Jones fluid, Johnson, Zollweg & Gubbins, Mol. Phys. 78 (1993).
# Same dataset as reference GaPFlow/models/bwr_coeffs.txt.
BWR_COEFFS = (
    0.8623085097507421, 2.976218765822098, -8.402230115796038,
    0.1054136629203555, -0.8564583828174598, 1.582759470107601,
    0.7639421948305453, 1.753173414312048, 2.798291772190376e+03,
    -4.8394220260857657e-02, 0.9963265197721935, -3.698000291272493e+01,
    2.084012299434647e+01, 8.305402124717285e+01, -9.574799715203068e+02,
    -1.477746229234994e+02, 6.398607852471505e+01, 1.603993673294834e+01,
    6.805916615864377e+01, -2.791293578795945e+03, -6.245128304568454,
    -8.116836104958410e+03, 1.488735559561229e+01, -1.059346754655084e+04,
    -1.131607632802822e+02, -8.867771540418822e+03, -3.986982844450543e+01,
    -4.689270299917261e+03, 2.593535277438717e+02, -2.694523589434903e+03,
    -7.218487631550215e+02, 1.721802063863269e+02,
)


# ---------------------------------------------------------------------------
# Pressure
# ---------------------------------------------------------------------------

def dowson_higginson(dens, rho0=877.7007, P0=101325., C1=3.5e8, C2=1.23):
    """Dowson-Higginson isothermal EOS: p = P0 + C1 (r-1) / (C2 - r), r=rho/rho0.

    Density is clamped at 0.99*C2*rho0 to keep the denominator away from zero.
    """
    rho = dens.clamp(max=0.99 * C2 * rho0)
    r = true_div(rho, rho0)
    return P0 + C1 * (r - 1.) / (C2 - r)


def power_law(dens, rho0=1.1853, P0=101325., alpha=0.):
    """Power-law EOS p = P0 (rho/rho0)^(1/(1 - alpha/2)); ideal gas at alpha=0."""
    return P0 * true_div(dens, rho0) ** (1. / (1. - 0.5 * alpha))


def van_der_waals(dens, M=39.948, T=100., a=1.355, b=0.03201):
    """Van der Waals EOS (a in L^2 bar/mol^2, b in L/mol, M in g/mol)."""
    R = gas_constant
    n = true_div(dens, M) * 1000.       # mol/m^3
    a_si = a / 10.             # m^6 Pa / mol^2
    b_si = b / 1000.           # m^3 / mol
    return R * T * n / (1. - b_si * n) - a_si * n ** 2


def murnaghan_tait(dens, rho0=700, P0=0.101e6, K=0.557e9, n=7.33):
    """Murnaghan-Tait EOS p = K/n ((rho/rho0)^n - 1) + P0."""
    return K / n * (true_div(dens, rho0) ** n - 1.) + P0


def cubic(dens, a=15.2, b=-9.6, c=3.35, d=-0.07):
    """Cubic polynomial EOS p = a rho^3 + b rho^2 + c rho + d."""
    return ((a * dens + b) * dens + c) * dens + d


def _bwr_terms(T, gamma):
    """Precompute the density-polynomial coefficients of the MBWR EOS."""
    x = BWR_COEFFS
    sqT = T ** 0.5
    poly = (  # coefficient of rho^(k+1) for k = 0..8 (non-exponential part)
        T,
        x[0] * T + x[1] * sqT + x[2] + x[3] / T + x[4] / T ** 2,
        x[5] * T + x[6] + x[7] / T + x[8] / T ** 2,
        x[9] * T + x[10] + x[11] / T,
        x[12],
        x[13] / T + x[14] / T ** 2,
        x[15] / T,
        x[16] / T + x[17] / T ** 2,
        x[18] / T ** 2,
    )
    expo = (  # coefficient of rho^(2k+3) inside exp(-gamma rho^2), k = 0..5
        x[19] / T ** 2 + x[20] / T ** 3,
        x[21] / T ** 2 + x[22] / T ** 4,
        x[23] / T ** 2 + x[24] / T ** 3,
        x[25] / T ** 2 + x[26] / T ** 4,
        x[27] / T ** 2 + x[28] / T ** 3,
        x[29] / T ** 2 + x[30] / T ** 3 + x[31] / T ** 4,
    )
    return poly, expo


def bwr(dens, T, gamma=3.):
    """Modified Benedict-Webb-Rubin EOS for the LJ fluid (reduced units)."""
    poly, expo = _bwr_terms(T, gamma)
    rho2 = dens * dens
    p_poly = torch.zeros_like(dens)
    for c in reversed(poly):
        p_poly = (p_poly + c) * dens
    p_exp = torch.zeros_like(dens)
    for c in reversed(expo):
        p_exp = p_exp * rho2 + c
    p_exp = p_exp * dens ** 3 * torch.exp(-gamma * rho2)
    return p_poly + p_exp


def bayada_chupin(dens, rho_l, rho_v, c_l, c_v):
    """Bayada-Chupin two-phase cavitation EOS (branch-free)."""
    N = rho_v * c_v ** 2 * rho_l * c_l ** 2 * (rho_v - rho_l) \
        / (rho_v ** 2 * c_v ** 2 - rho_l ** 2 * c_l ** 2)
    Pcav = rho_v * c_v ** 2 - N * math.log(rho_v ** 2 * c_v ** 2
                                           / (rho_l ** 2 * c_l ** 2))
    alpha = true_div(dens - rho_l, rho_v - rho_l)

    p_liq = Pcav + (dens - rho_l) * c_l ** 2
    # mixture branch: guard the log argument so non-selected lanes stay finite
    denom = rho_l * (rho_v * c_v ** 2 * (1. - alpha) + rho_l * c_l ** 2 * alpha)
    arg = rho_v * c_v ** 2 * dens / denom
    p_mix = Pcav + N * torch.log(torch.where(arg > 0., arg, 1.))
    p_vap = c_v ** 2 * dens

    return torch.where(alpha < 0., p_liq,
                       torch.where(alpha <= 1., p_mix, p_vap))


_PRESSURE = {
    "DH": (dowson_higginson, ("rho0", "P0", "C1", "C2")),
    "PL": (power_law, ("rho0", "P0", "alpha")),
    "vdW": (van_der_waals, ("M", "T", "a", "b")),
    "MT": (murnaghan_tait, ("rho0", "P0", "K", "n")),
    "cubic": (cubic, ("a", "b", "c", "d")),
    "BWR": (bwr, ("T", "gamma")),
    "Bayada": (bayada_chupin, ("rho_l", "rho_v", "c_l", "c_v")),
}


# ---------------------------------------------------------------------------
# Sound speed c = sqrt(dp/drho)
# ---------------------------------------------------------------------------

def sound_dowson_higginson(dens, rho0=877.7007, P0=101325., C1=3.5e8, C2=1.23):
    dp = true_div(C1 * rho0 * (C2 - 1.),
                  dens ** 2 * (true_div(C2 * rho0, dens) - 1.) ** 2)
    return torch.sqrt(dp)


def sound_power_law(dens, rho0=1.1853, P0=101325., alpha=0.):
    dp = (-2. * P0 * true_div(dens, rho0) ** (-2. / (alpha - 2.))
          / ((alpha - 2.) * dens))
    return torch.sqrt(dp)


def sound_van_der_waals(dens, M=39.948, T=100., a=1.355, b=0.03201):
    # dp/drho = dp/dn * dn/drho with n = rho/M*1000 (the reference omits the
    # chain factor 1000/M; we keep c^2 = dp/drho consistent with the EOS)
    R = gas_constant
    n = true_div(dens, M) * 1000.
    a_si = a / 10.
    b_si = b / 1000.
    dp_dn = true_div(R * T, (1. - b_si * n) ** 2) - 2. * a_si * n
    return torch.sqrt(true_div(dp_dn * 1000., M))


def sound_murnaghan_tait(dens, rho0=700, P0=0.101e6, K=0.557e9, n=7.33):
    return torch.sqrt(K / rho0 ** n * dens ** (n - 1.))


def sound_cubic(dens, a=15.2, b=-9.6, c=3.35, d=-0.07):
    return torch.sqrt((3. * a * dens + 2. * b) * dens + c)


def sound_bwr(dens, T, gamma=3.):
    poly, expo = _bwr_terms(T, gamma)
    rho2 = dens * dens
    # d/drho of the polynomial part: sum (k+1) poly[k] rho^k
    dp_poly = torch.zeros_like(dens)
    for k in reversed(range(len(poly))):
        dp_poly = dp_poly * dens + (k + 1) * poly[k]
    # exponential part: E = exp(-g r^2) * sum expo[k] rho^(2k+3)
    s = torch.zeros_like(dens)
    ds = torch.zeros_like(dens)
    for k in reversed(range(len(expo))):
        s = s * rho2 + expo[k]
        ds = ds * rho2 + (2 * k + 3) * expo[k]
    # E = e * s * rho^3  =>  dE/drho = e * (ds * rho^2 - 2 g rho^4 s)
    e = torch.exp(-gamma * rho2)
    dp_exp = e * (ds * rho2 - 2. * gamma * rho2 * rho2 * s)
    return torch.sqrt(dp_poly + dp_exp)


def sound_bayada_chupin(dens, rho_l, rho_v, c_l, c_v):
    alpha = true_div(dens - rho_l, rho_v - rho_l)
    c2_mix = true_div(rho_v * rho_l * (c_v * c_l) ** 2,
                      alpha * rho_l * c_l ** 2
                      + (1. - alpha) * rho_v * c_v ** 2) / dens
    c2 = torch.where(alpha < 0., c_l ** 2,
                     torch.where(alpha <= 1., c2_mix, c_v ** 2))
    return torch.sqrt(c2)


_SOUND = {
    "DH": (sound_dowson_higginson, ("rho0", "P0", "C1", "C2")),
    "PL": (sound_power_law, ("rho0", "P0", "alpha")),
    "vdW": (sound_van_der_waals, ("M", "T", "a", "b")),
    "MT": (sound_murnaghan_tait, ("rho0", "P0", "K", "n")),
    "cubic": (sound_cubic, ("a", "b", "c", "d")),
    "BWR": (sound_bwr, ("T", "gamma")),
    "Bayada": (sound_bayada_chupin, ("rho_l", "rho_v", "c_l", "c_v")),
}


def _apply(table, density, prop):
    func, argnames = table[prop["EOS"]]
    kwargs = {k: prop[k] for k in argnames if k in prop}
    return func(torch.as_tensor(density), **kwargs)


def eos_pressure(density, prop):
    """Pressure field for the EOS selected by ``prop['EOS']``."""
    return _apply(_PRESSURE, density, prop)


def eos_sound_velocity(density, prop):
    """Isothermal sound speed c = sqrt(dp/drho) for the selected EOS."""
    return _apply(_SOUND, density, prop)
