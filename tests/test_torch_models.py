"""Constitutive models of the port agree with the JAX package at float64.

The same numpy inputs go through both packages; agreement to rtol 1e-12
(float64 rounding of the same formulas, evaluated by two libraries).
"""

import numpy as np
import pytest
import torch

import gapflow_tpu  # noqa: F401  (enables float64 in JAX)
import jax.numpy as jnp

from gapflow_tpu.config import sanitize_properties
from gapflow_tpu.models import closures_opt as jco, eos as jeos
from gapflow_tpu.models import viscosity as jvis, viscous as jvsc
from gapflow_torch.models import closures_opt as tco, eos as teos
from gapflow_torch.models import viscosity as tvis, viscous as tvsc

RTOL = 1e-12

# (properties, density range) per EOS, around each model's working point
EOS_CASES = {
    "DH": ({"EOS": "DH"}, (800., 950.)),
    "PL": ({"EOS": "PL", "alpha": 0.3}, (0.8, 1.5)),
    "vdW": ({"EOS": "vdW"}, (0.5, 2.)),
    "MT": ({"EOS": "MT"}, (650., 750.)),
    "cubic": ({"EOS": "cubic"}, (0.8, 1.2)),
    "BWR": ({"EOS": "BWR"}, (0.3, 0.8)),
    "Bayada": ({"EOS": "Bayada"}, (0.01, 900.)),
}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(a, b, rtol=RTOL, atol=0.):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _prop(extra):
    return sanitize_properties({"shear": 0.0794, "bulk": 0.01, **extra})


@pytest.mark.parametrize("name", list(EOS_CASES))
def test_eos_pressure_and_sound_speed(name):
    extra, (lo, hi) = EOS_CASES[name]
    prop = _prop(extra)
    rho = np.random.default_rng(1).uniform(lo, hi, (16, 8))
    _close(teos.eos_pressure(_t(rho), prop),
           jeos.eos_pressure(jnp.asarray(rho), prop))
    if name == "Bayada":
        # the liquid and vapour branches are constant; compare the mixture
        rho = np.random.default_rng(2).uniform(1., 800., (16, 8))
    _close(teos.eos_sound_velocity(_t(rho), prop),
           jeos.eos_sound_velocity(jnp.asarray(rho), prop))


@pytest.mark.parametrize("piezo", [
    {"name": "Barus", "aB": 2e-8},
    {"name": "Roelands", "mu_inf": 1e-3, "p_ref": 1.96e8, "z": 0.68},
    {"name": "Dukler", "eta_v": 3.9e-5, "rho_l": 850., "rho_v": 0.019},
    {"name": "McAdams", "eta_v": 3.9e-5, "rho_l": 850., "rho_v": 0.019},
    {"name": "none"},
], ids=lambda d: d["name"])
def test_piezoviscosity(piezo):
    x = np.random.default_rng(3).uniform(1., 8e7, (16, 8))
    if piezo["name"] in ("Dukler", "McAdams"):
        x = np.random.default_rng(3).uniform(0.1, 850., (16, 8))
    _close(tvis.piezoviscosity(_t(x), 0.0794, piezo),
           jvis.piezoviscosity(jnp.asarray(x), 0.0794, piezo))


@pytest.mark.parametrize("thinning", [
    {"name": "Eyring", "tauE": 5e5},
    {"name": "Carreau", "mu_inf": 1e-9, "lam": 1e-6, "a": 2., "N": 0.6},
], ids=lambda d: d["name"])
def test_shear_thinning(thinning):
    rng = np.random.default_rng(4)
    dpx, dpy = rng.normal(0., 1e10, (2, 16, 8))
    h = rng.uniform(1e-6, 2e-6, (16, 8))
    rate_t = tvis.shear_rate_avg(_t(dpx), _t(dpy), _t(h), 0.1, 0., 0.0794)
    rate_j = jvis.shear_rate_avg(jnp.asarray(dpx), jnp.asarray(dpy),
                                 jnp.asarray(h), 0.1, 0., 0.0794)
    _close(rate_t, rate_j)
    _close(tvis.shear_thinning_factor(rate_t, 0.0794, thinning),
           jvis.shear_thinning_factor(rate_j, 0.0794, thinning))


def _closure_inputs(seed=5, shape=(16, 8)):
    rng = np.random.default_rng(seed)
    q = np.stack([rng.uniform(800., 950., shape),
                  rng.normal(40., 5., shape), rng.normal(0., 5., shape)])
    h = np.stack([rng.uniform(1e-6, 3e-6, shape),
                  rng.normal(0., 1e-3, shape), rng.normal(0., 1e-3, shape)])
    Ls = rng.uniform(0., 1e-7, (1,) + shape)
    eta = rng.uniform(0.05, 0.1, shape)
    return q, h, Ls, eta


def test_statics_and_fused_pass():
    q, h, Ls, eta = _closure_inputs()
    st_t = tco.precompute_statics(_t(h), _t(Ls))
    st_j = jco.precompute_statics(jnp.asarray(h), jnp.asarray(Ls))
    _close(st_t, st_j)
    out_t = tco.fused_pass_top_pre(*_t(q), tuple(st_t), 0.1, 0.02, _t(eta),
                                   0.01)
    out_j = jco.fused_pass_top_pre(*jnp.asarray(q), tuple(st_j), 0.1, 0.02,
                                   jnp.asarray(eta), 0.01)
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-12 * float(np.max(np.abs(b))))


@pytest.mark.parametrize("slip", ["top", "both"])
@pytest.mark.parametrize("fn", ["stress_bottom", "stress_top", "stress_avg"])
def test_viscous_stress(fn, slip):
    q, h, Ls, eta = _closure_inputs(seed=6)
    a = getattr(tvsc, fn)(_t(q), _t(h), 0.1, 0.02, _t(eta), 0.01, _t(Ls),
                          slip=slip)
    b = getattr(jvsc, fn)(jnp.asarray(q), jnp.asarray(h), 0.1, 0.02,
                          jnp.asarray(eta), 0.01, jnp.asarray(Ls), slip=slip)
    b = np.asarray(b)
    assert a.shape == b.shape
    # components cancel to ~0 in places: compare against each one's scale
    for ca, cb in zip(a, b):
        _close(ca, cb, atol=1e-12 * float(np.max(np.abs(cb)) + 1e-300))
