"""Training database for the GP surrogates.

Holds (Xtrain, Ytrain, Yerr) as float64 numpy arrays with max-abs
normalization, samples initial training points around the current field
state (random / Latin hypercube / Sobol), persists every MD run as a FAIR
dataset on disk, and reloads existing datasets on construction.

Counterpart of :mod:`gapflow_tpu.db` (13-entry observation vector
[p, tau_bottom(6 Voigt), tau_top(6 Voigt)]; feature vector
[rho, jx, jy, h, dh/dx, dh/dy, extra...]).  The Latin hypercube and Sobol
samplers are scipy's, seeded with ``init_seed``, so they give the JAX
package's samples.  The uniform ``rand`` samples and the choice of the
geometry rows come from a numpy ``Generator`` seeded with ``init_seed``
and so differ from the JAX package's (``jax.random``); :meth:`load`
carries a database across.
"""

import os
import tempfile

import numpy as np
import yaml as _yaml
from scipy.stats import qmc

from . import datasets as dt
from .utils import echo


class Database:
    """Container and manager for GP training data with an attached MD runner."""

    def __init__(self, md, db, num_extra_features=1):
        self._md = md
        self._db = db
        self._num_features = 6 + num_extra_features
        self._output_path = None

        training_path = db.get("dtool_path")
        if training_path is not None:
            self._temporary_training_path = False
            self.set_training_path(training_path)
            readme_list = self.get_readme_list_local()
        else:
            # a fresh directory (under TMPDIR), never shared with another
            # run
            self._temporary_training_path = True
            self.set_training_path(tempfile.mkdtemp(prefix="gapflow_train_"))
            readme_list = []

        if readme_list:
            self.load(np.array([rm["X"] for rm in readme_list]),
                      np.array([rm["Y"] for rm in readme_list]),
                      np.array([rm["Yerr"] for rm in readme_list]))
        else:
            self.load(np.empty((0, self.num_features)), np.empty((0, 13)),
                      np.empty((0, 13)))

    # -- properties ---------------------------------------------------------
    @property
    def config(self):
        return self._db

    @property
    def md_config(self):
        return self._md.params

    @property
    def Xtrain(self):
        return self._Xtrain / self.X_scale

    @property
    def Ytrain(self):
        return self._Ytrain / self.Y_scale

    @property
    def Ytrain_err(self):
        return self._Ytrain_err / self.Y_scale

    @property
    def size(self):
        return self._Xtrain.shape[0]

    @property
    def X_scale(self):
        return self._X_scale

    @property
    def Y_scale(self):
        return self._Y_scale

    @property
    def num_features(self):
        return self._num_features

    @property
    def has_mock_md(self):
        return self._md.is_mock

    @property
    def output_path(self):
        return self._output_path

    @output_path.setter
    def output_path(self, path):
        self._output_path = path

    @property
    def training_path(self):
        return self._training_path

    # -- dataset persistence ------------------------------------------------
    def get_readme_list_local(self):
        """Load README metadata of all datasets under the training path."""
        ds_list = list(dt.iter_datasets_in_base_uri(self.training_path))
        readme_list = [_yaml.safe_load(ds.get_readme_content())
                       for ds in ds_list]
        readme_list = [rm for rm in readme_list if rm and "X" in rm]

        echo(f"Loading {len(readme_list)} local datasets "
             f"in '{self.training_path}'.")
        for ds in ds_list:
            echo(f"- {ds.uuid} ({ds.name})")
        return readme_list

    def set_training_path(self, new_path, check_temporary=False):
        """Set where MD datasets are written/read (also for the MD runner)."""
        overwrite = self._temporary_training_path if check_temporary else True
        if overwrite:
            os.makedirs(new_path, exist_ok=True)
            self._training_path = new_path
            self._md._dtool_basepath = new_path
            self._db["dtool_path"] = new_path

    def _normalizer(self, x):
        return np.maximum(np.max(np.abs(x), axis=0), 1e-12)

    def _renormalize(self):
        if self.size == 0:
            self._X_scale = np.ones((self.num_features,))
            self._Y_scale = np.ones((13,))
        else:
            self._X_scale = self._normalizer(self._Xtrain)
            self._Y_scale = self._normalizer(self._Ytrain)

    def load(self, Xtrain, Ytrain, Ytrain_err):
        """Replace the training data (unnormalized, as the MD runs gave
        them) and renormalize; e.g. a database carried over from the JAX
        package as numpy arrays."""
        self._Xtrain = np.array(Xtrain, dtype=np.float64).reshape(
            -1, self.num_features)
        self._Ytrain = np.array(Ytrain, dtype=np.float64).reshape(-1, 13)
        self._Ytrain_err = np.array(Ytrain_err, dtype=np.float64).reshape(
            -1, 13)
        self._renormalize()

    def write(self):
        if self.output_path is not None:
            np.save(os.path.join(self.output_path, "Xtrain.npy"), self._Xtrain)
            np.save(os.path.join(self.output_path, "Ytrain.npy"), self._Ytrain)
            np.save(os.path.join(self.output_path, "Ytrain_err.npy"),
                    self._Ytrain_err)

    # -- data management ----------------------------------------------------
    def initialize(self, Xtest, dim=1):
        """Sample initial training points around the current field state."""
        method = self._db["init_method"]
        width = self._db["init_width"]
        seed = self._db["init_seed"]
        init_size = self._db["init_size"]

        Nsample = init_size - self.size
        if Nsample <= 0:
            return

        echo(f"Database contains less than {init_size} MD runs.")
        echo(f"Generate new training data in {self.training_path}")

        Xtest = np.asarray(Xtest, dtype=np.float64)
        if dim == 1:
            flux = np.mean(Xtest[:, 1])
            active = np.array([0, 1])
        else:
            flux = np.hypot(np.mean(Xtest[:, 1]), np.mean(Xtest[:, 2]))
            active = np.array([0, 1, 2])

        rho = np.mean(Xtest[:, 0])

        l_bounds = np.array([(1. - width) * rho, 0.5 * flux,
                             -0.5 * flux])[active]
        u_bounds = np.array([(1. + width) * rho, 1.5 * flux,
                             0.5 * flux])[active]

        rng = np.random.default_rng(seed)

        if method == "rand":
            samples = rng.uniform(l_bounds, u_bounds,
                                  size=(Nsample, len(l_bounds)))
        elif method == "lhc":
            samples = _get_lhc_samples(Nsample, l_bounds, u_bounds, seed)
        else:  # sobol
            samples = _get_sobol_samples(Nsample, l_bounds, u_bounds, seed)
            Nsample = samples.shape[0]

        choice = rng.choice(Xtest.shape[0], size=Nsample, replace=False)

        if len(active) == 2:
            samples = np.hstack([samples, np.zeros((Nsample, 1))])

        Xnew = np.column_stack([samples, Xtest[choice, 3:]])
        self.add_data(Xnew)

    def add_data(self, Xnew):
        """Run the MD oracle for each new row and append the results."""
        size_before = self.size
        for X in np.asarray(Xnew, dtype=np.float64):
            size_before += 1
            Y, Ye = self._md.run(X, size_before)

            self._Xtrain = np.vstack([self._Xtrain, X])
            self._Ytrain = np.vstack([self._Ytrain, np.asarray(Y)])
            self._Ytrain_err = np.vstack([self._Ytrain_err, np.asarray(Ye)])
            self._renormalize()

        self.write()


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def _get_lhc_samples(N, lo, hi, seed=None):
    # seeded: DB initialization must be reproducible run-to-run
    sampler = qmc.LatinHypercube(d=len(lo), seed=seed)
    return qmc.scale(sampler.random(n=N), np.asarray(lo), np.asarray(hi))


def _get_sobol_samples(N, lo, hi, seed=None):
    sampler = qmc.Sobol(d=len(lo), seed=seed)
    m = int(np.log2(N))
    if 2 ** m != N:
        m = int(np.ceil(np.log2(N)))
        echo(f"Sample size should be a power of 2 for Sobol sampling. "
             f"Use Ninit={2 ** m}.")
    return qmc.scale(sampler.random_base2(m=m), np.asarray(lo),
                     np.asarray(hi))
