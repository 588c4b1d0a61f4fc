"""The port's GP engine, padded buffers, database and mock oracle agree
with the JAX package (CPU, float64).

- the kernel, Gram matrix, conditioning, mean and variance, NLML and its
  closed-form gradient, and the rank-1 append against
  ``gapflow_tpu.models.gp``, rtol 1e-12;
- one scipy-BFGS fit from the same start on well-posed data: the
  hyperparameters (their logs) within 1e-8;
- ``PaddedGP`` init, append and predict against ``gapflow_tpu.models.al_jit``,
  1e-12;
- the Latin hypercube and Sobol samplers, exactly;
- the mock oracle with the JAX package's draws injected against
  ``gapflow_tpu.md.mock``, 1e-12, and its own draws reproducible;
- the database normalisation and the surrogates' data plumbing;
- ``import gapflow_torch`` and every GP module with ``jax`` blocked.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.random as jr
from gapflow_tpu import db as jdb
from gapflow_tpu.md import mock as jmock
from gapflow_tpu.models import al_jit as jal
from gapflow_tpu.models import gp as jgp

from gapflow_torch import db as tdb
from gapflow_torch.md import mock as tmock
from gapflow_torch.models import al_jit as tal
from gapflow_torch.models import gp as tgp

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12


@pytest.fixture(scope="module")
def data():
    """Well-spread training data: 24 points in 3 dims, two outputs."""
    rng = np.random.default_rng(3)
    X = rng.uniform(0., 1., (24, 3))
    Y = np.stack([np.sin(3. * X[:, 0]) + X[:, 1] ** 2,
                  np.cos(2. * X[:, 2]) - X[:, 0]], axis=1)
    Xt = rng.uniform(-0.1, 1.1, (40, 3))
    params = {"log_amp": np.array(0.3),
              "log_scale": np.log(np.array([0.4, 0.7, 0.5]))}
    return X, Y, Xt, params, 0.05


def jparams(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def tparams(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def close(t, j, rtol=RTOL, atol=0.):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_kernel_and_gram(data):
    X, _, Xt, p, _ = data
    close(tgp.kernel_fn(tparams(p), torch.as_tensor(X), torch.as_tensor(Xt)),
          jgp.kernel_fn(jparams(p), X, Xt))
    close(tgp.kernel_gram(tparams(p), torch.as_tensor(X)),
          jgp.kernel_gram(jparams(p), X))


@pytest.mark.parametrize("multi", [False, True])
def test_condition_mean_var(data, multi):
    X, Y, Xt, p, yerr = data
    Y = Y if multi else Y[:, 0]
    tc = tgp.gp_condition(tparams(p), torch.as_tensor(X), torch.as_tensor(Y),
                          yerr)
    jc = jgp.gp_condition(jparams(p), X, Y, yerr)
    for a, b in zip(tc, jc):
        close(a, b, atol=1e-12 * float(np.abs(np.asarray(b)).max()))
    tm, tv = tgp.gp_predict_mean_var(tparams(p), torch.as_tensor(X), tc,
                                     torch.as_tensor(Xt))
    jm, jv = jgp.gp_predict_mean_var(jparams(p), X, jc, Xt)
    close(tm, jm, atol=1e-12)
    close(tv, jv, atol=1e-12)
    close(tgp.gp_predict_mean(tparams(p), torch.as_tensor(X), tc,
                              torch.as_tensor(Xt)), jm, atol=1e-12)


@pytest.mark.parametrize("multi", [False, True])
def test_nlml_value_and_grad(data, multi):
    X, Y, _, p, yerr = data
    Y = Y if multi else Y[:, 0]
    args = (torch.as_tensor(X), torch.as_tensor(Y), yerr)
    tv, tg = tgp.nlml_value_and_grad(tparams(p), *args)
    jv, jg = jgp.nlml_value_and_grad(jparams(p), X, Y, yerr)
    close(tv, jv)
    close(tgp.nlml(tparams(p), *args), jgp.nlml(jparams(p), X, Y, yerr))
    for k in jg:
        close(tg[k], jg[k], rtol=1e-11)


def test_rank1_append(data):
    X, Y, _, p, yerr = data
    Y = Y[:, 0]
    tc = tgp.gp_condition(tparams(p), torch.as_tensor(X[:-1]),
                          torch.as_tensor(Y[:-1]), yerr)
    jc = jgp.gp_condition(jparams(p), X[:-1], Y[:-1], yerr)
    tX, tc = tgp.gp_append(tparams(p), torch.as_tensor(X[:-1]), tc,
                           torch.as_tensor(Y), torch.as_tensor(X[-1]), yerr)
    jX, jc = jgp.gp_append(jparams(p), X[:-1], jc, Y, X[-1], yerr)
    close(tX, jX)
    for a, b in zip(tc, jc):
        close(a, b, atol=1e-12 * float(np.abs(np.asarray(b)).max()))


def test_bfgs_fit_from_the_same_start(data):
    X, Y, _, _, yerr = data
    p0 = {"log_amp": np.log(1.), "log_scale": np.log(np.std(X, axis=0))}
    tp, tobj = tgp.fit_hyperparameters(p0, X, Y, yerr)
    jp, jobj = jgp._fit_hyperparameters_host(jparams(p0), jnp.asarray(X),
                                             jnp.asarray(Y),
                                             jnp.asarray(yerr), "BFGS")
    for k in jp:
        # the logs within 1e-8: the hyperparameters within 1e-8 relative
        close(tp[k], jp[k], rtol=0., atol=1e-8)
    assert tobj == pytest.approx(jobj, rel=1e-12)


@pytest.mark.parametrize("multi", [False, True])
def test_padded_gp(data, multi):
    X, Y, Xt, p, yerr = data
    Y = Y if multi else Y[:, 0]
    n0, cap = 18, 32
    tg = tal.init(tparams(p), cap, torch.as_tensor(X[:n0]),
                  torch.as_tensor(Y[:n0]), yerr)
    jg = jal.init(jparams(p), cap, jnp.asarray(X[:n0]), jnp.asarray(Y[:n0]),
                  jnp.asarray(yerr))
    for i in range(n0, len(X)):
        tg = tal.append(tg, torch.as_tensor(X[i]), torch.as_tensor(Y[i]))
        jg = jal.append(jg, jnp.asarray(X[i]), jnp.asarray(Y[i]))
    assert tg.count == int(jg.count) == len(X)
    for name in ("X", "Y", "Linv", "alpha"):
        b = np.asarray(getattr(jg, name))
        close(getattr(tg, name), b, atol=1e-12 * np.abs(b).max())
    tm, tv = tal.predict(tg, torch.as_tensor(Xt))
    jm, jv = jal.predict(jg, jnp.asarray(Xt))
    close(tm, jm, atol=1e-12)
    close(tv, jv, atol=1e-12)


@pytest.mark.parametrize("sampler", ["_get_lhc_samples",
                                     "_get_sobol_samples"])
def test_samplers_exact(sampler):
    lo, hi = np.array([870., 40., -20.]), np.array([885., 80., 20.])
    t = getattr(tdb, sampler)(8, lo, hi, seed=123)
    j = getattr(jdb, sampler)(8, lo, hi, seed=123)
    np.testing.assert_array_equal(t, np.asarray(j))


GP_CFG = {"press_gp": True, "shear_gp": True,
          "press": {"obs_stddev": 100.}, "shear": {"obs_stddev": 1.}}
PROP = {"shear": 0.0794, "bulk": 0., "EOS": "DH", "P0": 101325.,
        "rho0": 877.7007, "C1": 3.5e10, "C2": 1.23}
GEO = {"U": 0.1, "V": 0.05}


def jax_draws(X):
    """The JAX package's 13 standard-normal draws for sample X."""
    return np.asarray(jr.normal(jmock._sample_key(X), (13,),
                                dtype=jnp.float64))


def test_mock_with_jax_draws():
    rng = np.random.default_rng(5)
    for _ in range(3):
        X = np.array([877.7, 43.9, 21.9, 1.e-5, 3.e-3, 0., 0.])
        X = X * (1. + 0.01 * rng.standard_normal(7))
        t = tmock.Mock(PROP, GEO, GP_CFG, draws_fn=jax_draws)
        j = jmock.Mock(PROP, GEO, GP_CFG)
        t.build_input_files(None, None, X)
        j.build_input_files(None, None, jnp.asarray(X))
        (ty, te), (jy, je) = t.read_output(), j.read_output()
        close(ty, jy, atol=1e-12 * np.abs(np.asarray(jy)).max())
        close(te, je)


def test_mock_own_draws_reproducible():
    X = np.array([877.7, 43.9, 21.9, 1.e-5, 3.e-3, 0., 0.])
    a = tmock.sample_draws(X)
    np.testing.assert_array_equal(a, tmock.sample_draws(X.copy()))
    assert not np.array_equal(a, tmock.sample_draws(X * (1. + 1e-12)))
    assert a.shape == (13,)


def test_database_normalisation_and_load(tmp_path):
    md = tmock.Mock(PROP, GEO, GP_CFG)
    cfg = {"dtool_path": str(tmp_path / "train"), "init_size": 4,
           "init_method": "lhc", "init_width": 1e-2, "init_seed": 123}
    db = tdb.Database(md, cfg)
    assert db.size == 0
    np.testing.assert_array_equal(db.X_scale, np.ones(7))
    rng = np.random.default_rng(0)
    Xtest = np.tile([877.7, 43.9, 21.9, 1.e-5, 3.e-3, 0., 0.], (50, 1))
    Xtest[:, 3] *= 1. + 0.1 * rng.standard_normal(50)
    db.initialize(Xtest, dim=2)
    assert db.size == 4
    np.testing.assert_allclose(db.X_scale,
                               np.maximum(np.abs(db._Xtrain).max(0), 1e-12))
    # the datasets on disk reload into an equal database
    again = tdb.Database(tmock.Mock(PROP, GEO, GP_CFG), dict(cfg))
    np.testing.assert_array_equal(np.sort(again._Xtrain, 0),
                                  np.sort(db._Xtrain, 0))
    db.load(db._Xtrain[:2], db._Ytrain[:2], db._Ytrain_err[:2])
    assert db.size == 2
    np.testing.assert_allclose(db.Ytrain, db._Ytrain / db.Y_scale)


def test_database_without_path_trains_in_a_fresh_directory(tmp_path,
                                                            monkeypatch):
    """Without ``dtool_path`` each Database (and a Mock on its own) writes
    into a new directory under TMPDIR and loads nothing it did not
    make."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    cfg = {"init_size": 4, "init_method": "lhc", "init_width": 1e-2,
           "init_seed": 123}
    a = tdb.Database(tmock.Mock(PROP, GEO, GP_CFG), dict(cfg))
    Xtest = np.tile([877.7, 43.9, 21.9, 1.e-5, 3.e-3, 0., 0.], (50, 1))
    a.initialize(Xtest, dim=2)
    b = tdb.Database(tmock.Mock(PROP, GEO, GP_CFG), dict(cfg))
    assert a.size == 4 and b.size == 0
    paths = {a.training_path, b.training_path,
             tmock.Mock(PROP, GEO, GP_CFG).dtool_basepath}
    assert len(paths) == 3
    assert all(Path(p).parent == tmp_path for p in paths)
    assert len(list(Path(a.training_path).iterdir())) == 4


def test_gp_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gapflow_tpu'] = None; "
            "import gapflow_torch, gapflow_torch.db, gapflow_torch.datasets, "
            "gapflow_torch.md, gapflow_torch.md.mock, gapflow_torch.md.base, "
            "gapflow_torch.md.runner, gapflow_torch.md.utils, "
            "gapflow_torch.models.gp, gapflow_torch.models.al_jit, "
            "gapflow_torch.models.profiles, gapflow_torch.models.stress, "
            "gapflow_torch.core.gp_step, gapflow_torch.core.al_chunked, "
            "gapflow_torch.ops.stencil_gp, gapflow_torch.validate; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules if sys.modules[m] is not None)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
