"""Fake MD oracle: analytic closures + deterministic per-sample noise.

Lets the entire GP / database / active-learning stack run without a real MD
engine; the continuum solver keeps its analytic viscosities when the oracle
is a mock (Problem checks ``database.has_mock_md``).

Observable contract (as :mod:`gapflow_tpu.md.mock`): ``read_output``
returns the 13-vector ``Y = [p, tau_bot(6 Voigt), tau_top(6 Voigt)]``
evaluated from the analytic closures at the stored feature vector X (in
float64 on the CPU), perturbed by Gaussian noise of the configured
``obs_stddev``, plus the matching error-bar vector ``Yerr``.  Noise is
applied only to the components whose error bars are nonzero: the pressure
(index 0) and the yz/xz wall shear components (indices 4, 5, 10, 11).

The noise generator is seeded from the *content* of X (a fixed base seed
and the crc32 digest of X's float64 bytes), so re-running an acquisition
reproduces its database while distinct samples see independent scatter.
The draws come from numpy's ``default_rng`` and so differ from the JAX
package's (``jax.random``) for the same X.  ``draws_fn(X) -> (13,)``
replaces the 13 standard-normal draws, so that a test can feed both
packages the same noise.
"""

import zlib

import numpy as np
import torch

from .base import MolecularDynamics
from ..models.viscous import stress_bottom, stress_top
from ..models.eos import eos_pressure

_BASE_SEED = 0x6A9F10  # arbitrary fixed constant: reproducibility anchor

# Y layout: [p, bot xx yy zz yz xz xy, top xx yy zz yz xz xy]
_NOISY_PRESSURE = np.array([0])
_NOISY_SHEAR = np.array([4, 5, 10, 11])


def sample_draws(X):
    """The 13 standard-normal draws of sample X, from a generator seeded
    with the base seed and the crc32 digest of X's float64 bytes."""
    digest = zlib.crc32(np.asarray(X, dtype=np.float64).tobytes())
    return np.random.default_rng([_BASE_SEED, digest]).standard_normal(13)


class Mock(MolecularDynamics):
    """Mock oracle evaluating the implemented constitutive laws at X."""

    name = "mock"

    _ascii_art = "\n  [ mock oracle -- analytic closures + seeded noise ]\n"

    def __init__(self, prop, geo, gp, draws_fn=None):
        self.is_mock = True
        self.noise = (gp["press"]["obs_stddev"] if gp["press_gp"] else 0.,
                      gp["shear"]["obs_stddev"] if gp["shear_gp"] else 0.)
        self.num_worker = 0
        self.geo = geo
        self.prop = prop
        self.params = dict(prop)
        self.draws_fn = sample_draws if draws_fn is None else draws_fn

    def build_input_files(self, dataset, location, X):
        self.X = X

    @property
    def _sigma(self):
        """13-vector of per-component observation stddevs."""
        sig = np.zeros(13)
        sig[_NOISY_PRESSURE] = self.noise[0]
        sig[_NOISY_SHEAR] = self.noise[1]
        return sig

    def read_output(self):
        X = np.asarray(self.X, dtype=np.float64)
        x = torch.as_tensor(X)
        U, V = self.geo["U"], self.geo["V"]
        eta, zeta = self.prop["shear"], self.prop["bulk"]

        clean = torch.cat([
            eos_pressure(x[0:1], self.prop),
            stress_bottom(x[:3], x[3:6], U, V, eta, zeta, x[6]),
            stress_top(x[:3], x[3:6], U, V, eta, zeta, x[6]),
        ]).numpy()

        sigma = self._sigma
        draws = np.asarray(self.draws_fn(X), dtype=np.float64)
        return clean + sigma * draws, sigma
