"""The port's per-step GP loop against the JAX package's (CPU, f64).

Two of the GP example configurations, non-silent, with adaptive dt and
active learning, run by ``Problem.run()`` in both packages (the per-step
host loop: ``_update_gp`` pass by pass, ``_update_gp_fused`` where no
surrogate may retrain or acquire and no output is due):

- ``journal_1d_dowson-higginson_gp`` at its own grid, 30 steps, a frame
  every 10, with a well-conditioned pressure surrogate (density only, a
  regularizing observation noise and a database 1e-2 wide, as in
  tests/test_torch_gp_slice.py), frozen, and one acquisition per
  active-learning episode, so that the wall stress pauses after its
  first episode and the steps between outputs take the fused step (the
  configuration chip_smoke.py's phase 3q runs on the card).  As
  published (a 1e-6 wide database, the pressure on density and gap) its
  noisy Gram matrix is so ill-conditioned that the float64 variance
  maxima of the two packages part by 13 % within 3 steps, and with them
  the acquisition decisions;
- ``asperity_2d_lj_gp`` at 16 x 16 (a seeded surface: the published one
  is drawn unseeded), 6 steps, a frame every 3, with one acquisition per
  active-learning episode and the pressure surrogate frozen, so that the
  wall-stress surrogates pause after their first episode and the steps
  between outputs take the fused step.

What the two runs share, so that they can agree step for step:

- one initial state, perturbed by relative density noise 1e-3 (numpy,
  seed 0), as in tests/test_torch_gp_slice.py;
- the port's initial database, carried into the JAX package, and the
  JAX package's mock noise draws, handed to the port's mock oracle in
  the order the JAX package drew them (keyed by X they would differ: an
  acquired X carries the two runs' rounding);
- the hyperparameters of every fit: the JAX package's surrogates fit by
  the port's optimizer on the JAX package's inputs, each fit is recorded,
  and the port's surrogates take them in the same order (the queue must
  end empty).  The fits have flat directions (a length scale of a feature
  the target hardly depends on), along which two BFGS runs on inputs
  1e-12 apart stop at different points; the protocol, not the optimizer,
  is compared here (the optimizer is in tests/test_torch_gp.py), and the
  JAX package's optimizer is not compiled.

Compared: q, dt and the database size after every step, the
acquisitions of each surrogate and the acquired inputs, the number of
fused steps, the written
``history.csv``, ``gp_{zz,xz,yz}.csv`` and ``gp_*.txt``, and the frames of
``sol.nc`` with their variance fields.  The journal's wall-stress Gram
matrices are still ill-conditioned, so its GP means carry the two
linear-algebra libraries' rounding amplified to ~1e-7: q is held to
1e-6 scaled, dt and the written histories to 1e-5 relative.

Each GP example configuration also builds and runs a few non-silent
steps in the port as published (at a small grid).
"""

import contextlib
import io
import re
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.random as jr
from gapflow_tpu import Problem as JProblem
from gapflow_tpu.md import mock as jmock
from gapflow_tpu.models import gp as jgp

from gapflow_torch import Problem
from gapflow_torch.config import read_history_csv
from gapflow_torch.models import gp as tgp
from gapflow_torch.nc import NCReader
from gapflow_torch.validate import perturbed_q

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64

#: name -> (steps, write_freq, grid points per axis or None for the file's,
#: edits of the file)
CASES = {
    "journal_1d_dowson-higginson_gp": (30, 10, None, (
        ("init_width: 1.e-6", "init_width: 1.e-2"),
        ("obs_stddev: 100.", "obs_stddev: 1.e8\n        active_dims: [0]\n"
         "        active_learning: False"),
        ("max_steps: 5", "max_steps: 1"))),
    "asperity_2d_lj_gp": (6, 3, 16, (
        ("num: 2", "num: 2\n    seed: 0"),
        ("max_steps: 5", "max_steps: 1"),
        ("obs_stddev: 2.e-2", "obs_stddev: 2.e-2\n        active_learning: "
         "False"))),
}


def config(name, out, steps, wf, n, edits=()):
    text = (ROOT / "examples" / "config" / f"{name}.yaml").read_text()
    text = re.sub(r"output: .*", f"output: {out}", text)
    text = re.sub(r"use_tstamp: .*", "use_tstamp: False", text)
    text = re.sub(r"max_it: .*", f"max_it: {steps}", text)
    text = re.sub(r"write_freq: .*", f"write_freq: {wf}", text)
    if n is not None:
        text = re.sub(r"N([xy]): .*", rf"N\1: {n}", text)
    for old, new in edits:
        assert old in text
        text = text.replace(old, new)
    return text


def _record_steps(p, log):
    """Record (q, dt, database size) after every step of ``p.run()``."""
    update = p.update

    def recorded():
        update()
        log.append((p.q.copy(), float(p.dt), int(p.database.size)))
    p.update = recorded


def _record_acquisitions(p, log):
    for m in (p.pressure, p.wall_stress_xz, p.wall_stress_yz):
        if not m.is_gp_model:
            continue
        acquire = m._active_learning

        def recorded(var, idx=None, m=m, acquire=acquire):
            log.append(m.name)
            acquire(var, idx)
        m._active_learning = recorded


def runs(tmp_path, monkeypatch, name):
    """Both packages' ``run()`` on one configuration; returns
    ``(jax, port)`` records: (problem, steps, acquisitions, outdir)."""
    steps, wf, n, edits = CASES[name]
    fits, draws = deque(), deque()

    fit = tgp.fit_hyperparameters

    def jax_fit(params0, X, Y, yerr, method="BFGS"):
        params, obj = fit({k: np.array(v) for k, v in params0.items()},
                          np.array(X), np.array(Y), float(yerr), method)
        params = {k: v.numpy() for k, v in params.items()}
        fits.append((params, float(obj)))
        return {k: jnp.asarray(v) for k, v in params.items()}, obj
    monkeypatch.setattr(jgp, "fit_hyperparameters", jax_fit)

    def port_fit(params0, X, Y, yerr, method="BFGS"):
        params, obj = fits.popleft()
        return tgp.params_to_torch(params), obj
    monkeypatch.setattr(tgp, "fit_hyperparameters", port_fit)

    def jax_key(X):
        key = jax_key.orig(X)
        draws.append(np.asarray(jr.normal(key, (13,), dtype=jnp.float64)))
        return key
    jax_key.orig = jmock._sample_key
    monkeypatch.setattr(jmock, "_sample_key", jax_key)

    out = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    recs = {}
    with contextlib.redirect_stdout(io.StringIO()):
        jp = JProblem.from_string(config(name, out["jax"], steps, wf, n,
                                         edits))
        tp = Problem.from_string(config(name, out["port"], steps, wf, n,
                                        edits), device="cpu", dtype=F64)
        # one perturbed initial state (the journal is mirror-symmetric:
        # its variance maxima tie, and either package may break a tie
        # either way), and the port's initial database (numpy sampling,
        # its own mock draws) in both packages
        q = perturbed_q(jp.q, seed=0, amp=1e-3)
        jp.q[...] = q
        tp.q[...] = q
        for m in tp._surrogates():
            m.init_database(tp.grid["dim"])
        tdb, jdb = tp.database, jp.database
        jdb._Xtrain, jdb._Ytrain, jdb._Ytrain_err = (
            jnp.asarray(a) for a in (tdb._Xtrain, tdb._Ytrain,
                                     tdb._Ytrain_err))
        jdb._X_scale = jdb._normalizer(jdb._Xtrain)
        jdb._Y_scale = jdb._normalizer(jdb._Ytrain)
        jp._pre_run()
        tp.database._md.draws_fn = lambda X: draws.popleft()
        tp._pre_run()
        fused = jp._update_gp_fused

        def counted():
            jp.fused_steps += 1
            fused()
        jp.fused_steps, jp._update_gp_fused = 0, counted
        for tag, p in (("jax", jp), ("port", tp)):
            log, acq = [], []
            _record_steps(p, log)
            _record_acquisitions(p, acq)
            p.run()
            recs[tag] = (p, log, acq, out[tag])
    assert not fits, "the port trained fewer times than the JAX package"
    assert not draws, "the port ran fewer MD samples than the JAX package"
    return recs["jax"], recs["port"]


def scaled(a, b):
    """Max difference scaled by each component's largest magnitude."""
    scale = np.abs(b).reshape(b.shape[0], -1).max(axis=1)
    scale = np.where(scale > 0, scale, 1.)
    return float((np.abs(a - b) / scale[:, None, None]).max())


def _csv(path):
    return {k: np.asarray(v, dtype=float)
            for k, v in read_history_csv(path).items()}


@pytest.mark.parametrize("name", list(CASES))
def test_per_step_gp_loop_matches_jax(tmp_path, monkeypatch, name):
    (jp, jlog, jacq, jout), (tp, tlog, tacq, tout) = runs(
        tmp_path, monkeypatch, name)
    steps, wf = CASES[name][:2]

    assert tp._route == "host_loop"
    assert tp.step == jp.step == steps == len(tlog) == len(jlog)
    for (jq, jdt, jn), (tq, tdt, tn) in zip(jlog, tlog):
        assert tn == jn
        assert scaled(tq, jq) < 1e-6
        assert abs(tdt - jdt) < 1e-5 * jdt
    assert tacq == jacq and len(tacq) > 0
    np.testing.assert_allclose(tp.database._Xtrain,
                               np.asarray(jp.database._Xtrain), rtol=1e-6)
    assert tp.simtime == pytest.approx(jp.simtime, rel=1e-5)
    # the steps between outputs after the surrogates pause are fused
    assert tp._fused_steps == jp.fused_steps > 0

    # the written output
    for tag in ("zz", "xz", "yz"):
        jf = jout / f"gp_{tag}.csv"
        assert (tout / f"gp_{tag}.csv").is_file() == jf.is_file()
        if not jf.is_file():
            continue
        j, t = _csv(jf), _csv(tout / f"gp_{tag}.csv")
        assert list(t) == list(j)
        for k in ("step", "database_size"):
            np.testing.assert_array_equal(t[k], j[k])
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5)
        assert (tout / f"gp_{tag}.txt").read_text().startswith("GP(")
    j, t = _csv(jout / "history.csv"), _csv(tout / "history.csv")
    np.testing.assert_array_equal(t["step"], j["step"])
    for k in ("time", "ekin", "vsound"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5)
    with NCReader(str(jout / "sol.nc")) as jn, \
            NCReader(str(tout / "sol.nc")) as tn:
        assert (tn.num_frames("solution") == jn.num_frames("solution")
                == steps // wf + 1)
        names = [f for f in ("pressure_var", "wall_stress_xz_var",
                             "wall_stress_yz_var") if f in jn.variables]
        assert names and set(names) <= set(tn.variables)
        for f in names + ["solution", "pressure"]:
            for i in range(jn.num_frames("solution")):
                a, b = tn.field(f, i), jn.field(f, i)
                a = a.reshape(-1, *a.shape[-2:])
                b = b.reshape(-1, *b.shape[-2:])
                assert scaled(a, b) < 1e-6, (f, i)


@pytest.mark.parametrize("change,item", [
    (("max_it: 1000", "max_it: 1000\n    gp_fast_pred: True"), "8b"),
    (("db:", "md: {system: lj}\ndb:"), "10"),
])
def test_refusals_that_stay(tmp_path, change, item):
    text = config("journal_1d_dowson-higginson_gp", tmp_path / "o", 1000,
                  100, None)
    assert change[0] in text
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        Problem.from_string(text.replace(*change), device="cpu",
                            dtype=torch.float64)


@pytest.mark.parametrize("name,n", [
    ("asperity_2d_lj_gp", 16), ("journal_1d_dowson-higginson_gp", None),
    ("journal_2d_dowson-higginson_gp", 16), ("parabolic_1d_lj_gp", None)])
def test_gp_examples_run_non_silent(tmp_path, name, n):
    """Each GP example configuration as published (at a small grid)
    builds and runs the per-step loop, writing its frames, GP histories
    and training datasets."""
    out = tmp_path / "o"
    with contextlib.redirect_stdout(io.StringIO()):
        p = Problem.from_string(config(name, out, 4, 2, n), device="cpu",
                                dtype=F64)
        p.run()
    assert p._route == "host_loop" and p.step == 4 and p.q_is_valid
    tags = ("zz", "xz") if p.grid["dim"] == 1 else ("zz", "xz", "yz")
    for tag in tags:
        rows = read_history_csv(out / f"gp_{tag}.csv")
        assert rows["step"][0] == 0 and rows["step"][-1] == 4
    assert not (out / "gp_yz.csv").exists() or "yz" in tags
    with NCReader(str(out / "sol.nc")) as nc:
        assert nc.num_frames("solution") == 3
        assert "pressure_var" in nc.variables
    assert len(list((out / "train").iterdir())) >= p.database.size
