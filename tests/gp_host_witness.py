"""Witnesses for the per-step GP loop's numerics on the CPU (JAX package
and port side by side); prints its readings.

    python tests/gp_host_witness.py [f32] [reorder] [published]

- ``f32``: the 1D GP journal of tests/test_torch_gp_host.py (chip_smoke.py
  phase 3q's configuration), 30 steps: the JAX package's per-step loop in
  float32 against its own float64 run (each in a process of its own, the
  float32 run taking the float64 run's fits and noise draws in order),
  then the port's on the CPU likewise, and the port's float32 run with
  the GP means evaluated in float64 (the features still float32).  Per
  step, the scaled distance of rho and jx from the float64 run.
- ``reorder``: the JAX package against itself on the published
  ``journal_1d_dowson-higginson_gp``: the same initial database in two
  row orders (a change of reduction order only), the same fits and noise
  draws; the variance maximum at each acquisition.
- ``published``: the port against the JAX package on the published
  configuration through tests/test_torch_gp_host.py's harness (the port's
  fits and the JAX package's draws in both), 30 steps: acquisitions and
  the scaled q distance per step.
"""

import contextlib
import io
import os
import pickle
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
NAME = "journal_1d_dowson-higginson_gp"
STEPS, WF = 30, 10


def journal_text(out, edits=True):
    from test_torch_gp_host import CASES, config
    text = config(NAME, out, STEPS, WF, None, CASES[NAME][3] if edits else ())
    return re.sub(r"^(\s*)tol: .*", r"\1tol: 1e-30", text, flags=re.M)


def scaled(a, b):
    """rho and jx: max difference over each component's largest value."""
    a, b = np.asarray(a)[:2], np.asarray(b)[:2]
    scale = np.abs(b).reshape(2, -1).max(axis=1)
    return float((np.abs(a - b) / scale[:, None, None]).max())


def jax_run(dtype, store):
    """The JAX package's run in this process (GAPFLOW_X64 set by the
    caller): float64 records its fits and draws into ``store``, float32
    replays them.  Writes the q after every step beside ``store``."""
    import jax.numpy as jnp
    import jax.random as jr
    from gapflow_tpu import Problem
    from gapflow_tpu.md import mock
    from gapflow_tpu.models import gp
    record = dtype == "f64"
    fits, draws = ([], []) if record else pickle.loads(store.read_bytes())
    fit, normal = gp.fit_hyperparameters, jr.normal

    def fit_(*a, **k):
        if record:
            r = fit(*a, **k)
            fits.append(({n: np.asarray(v) for n, v in r[0].items()},
                         float(r[1])))
            return r
        p, obj = fits.pop(0)
        return {n: jnp.asarray(v, jnp.float32) for n, v in p.items()}, obj

    class Random:
        key, fold_in = staticmethod(jr.key), staticmethod(jr.fold_in)

        @staticmethod
        def normal(key, shape, dtype):
            if record:
                d = normal(key, shape, dtype=dtype)
                draws.append(np.asarray(d))
                return d
            return jnp.asarray(draws.pop(0), dtype)

    gp.fit_hyperparameters, mock.jr = fit_, Random
    log = []
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        p = Problem.from_string(journal_text(tmp))
        update = p.update

        def recorded():
            update()
            log.append(np.array(p.q, dtype=np.float64))
        p.update = recorded
        p.run()
    if record:
        store.write_bytes(pickle.dumps((fits, draws)))
    np.save(f"{store}.{dtype}.npy", np.stack(log))


def port_runs():
    """The port's runs on the CPU: float64, float32, and float32 with the
    GP means in float64; fits and draws of the first run replayed."""
    import torch
    from gapflow_torch import Problem
    from gapflow_torch.core import gp_step
    from gapflow_torch.models import gp
    fits, draws, runs = {}, [], {}
    fit, mean = gp.fit_hyperparameters, gp_step._gp_mean

    def keyed_fit(params0, X, Y, yerr, method="BFGS"):
        key = (np.shape(params0["log_scale"]), np.shape(X)[0], np.ndim(Y))
        if key not in fits:
            fits[key] = fit(params0, X, Y, yerr, method)
        return fits[key]

    def mean64(params, X, alpha, Xt):
        return mean({k: v.double() for k, v in params.items()}, X.double(),
                    alpha.double(), Xt.double()).to(Xt.dtype)

    gp.fit_hyperparameters = keyed_fit
    try:
        for label, dtype, m in (("f64", torch.float64, mean),
                                ("f32", torch.float32, mean),
                                ("f32, means in f64", torch.float32, mean64)):
            gp_step._gp_mean = m
            log, replay = [], list(draws)
            with tempfile.TemporaryDirectory() as tmp, \
                    contextlib.redirect_stdout(io.StringIO()):
                p = Problem.from_string(journal_text(tmp), device="cpu",
                                        dtype=dtype)
                md = p.database._md
                own = md.draws_fn

                def draw(X, replay=replay, own=own):
                    if replay:
                        return replay.pop(0)
                    d = own(X)
                    draws.append(d)
                    return d
                md.draws_fn = draw
                update = p.update

                def recorded(update=update, p=p, log=log):
                    update()
                    log.append(np.array(p.q, dtype=np.float64))
                p.update = recorded
                p.run()
            runs[label] = log
    finally:
        gp.fit_hyperparameters, gp_step._gp_mean = fit, mean
    return runs


def f32():
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "fits_draws.pkl"
        for dtype in ("f64", "f32"):
            env = dict(os.environ, GAPFLOW_X64="1" if dtype == "f64" else "0",
                       JAX_PLATFORMS="cpu")
            subprocess.run([sys.executable, __file__, "--jax", dtype,
                            str(store)], env=env, check=True)
        jx = {d: np.load(f"{store}.{d}.npy") for d in ("f64", "f32")}
    port = port_runs()
    rows = {"JAX package f32": [scaled(a, b) for a, b in zip(jx["f32"],
                                                              jx["f64"])]}
    for label in ("f32", "f32, means in f64"):
        rows[f"port {label}"] = [scaled(a, b) for a, b in
                                 zip(port[label], port["f64"])]
    print(f"f32: {NAME} (tests/test_torch_gp_host.py's configuration), "
          f"{STEPS} steps; rho and jx scaled distance from the same "
          f"package's float64 run")
    for label, d in rows.items():
        print(f"  {label}: max {max(d):.3e}; steps 1-5 "
              + ", ".join(f"{x:.3e}" for x in d[:5]))


def reorder():
    import jax.numpy as jnp
    import jax.random as jr
    import torch
    from gapflow_tpu import Problem as JProblem
    from gapflow_tpu.md import mock
    from gapflow_tpu.models import gp
    from gapflow_torch import Problem
    from gapflow_torch.validate import perturbed_q
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        tp = Problem.from_string(journal_text(tmp, edits=False),
                                 device="cpu", dtype=torch.float64)
        for m in tp._surrogates():
            m.init_database(tp.grid["dim"])
    db = [np.array(a) for a in (tp.database._Xtrain, tp.database._Ytrain,
                                tp.database._Ytrain_err)]
    fits, draws, vmax = [], [], {}
    fit, normal, random = gp.fit_hyperparameters, jr.normal, mock.jr
    for run, order in (("database as drawn", None),
                       ("rows reordered", np.roll(np.arange(len(db[0])), 1))):
        replay = order is not None
        fq, dq = list(fits), list(draws)

        def fit_(*a, **k):
            if replay:
                return fq.pop(0)
            r = fit(*a, **k)
            fits.append(r)
            return r

        class Random:
            key, fold_in = staticmethod(jr.key), staticmethod(jr.fold_in)

            @staticmethod
            def normal(key, shape, dtype):
                if replay:
                    return dq.pop(0)
                d = normal(key, shape, dtype=dtype)
                draws.append(d)
                return d
        gp.fit_hyperparameters, mock.jr = fit_, Random
        vmax[run] = []
        try:
            with tempfile.TemporaryDirectory() as tmp, \
                    contextlib.redirect_stdout(io.StringIO()):
                jp = JProblem.from_string(journal_text(tmp, edits=False))
                jp.q[...] = perturbed_q(jp.q, seed=0, amp=1e-3)
                arrays = db if order is None else [a[order] for a in db]
                jdb = jp.database
                jdb._Xtrain, jdb._Ytrain, jdb._Ytrain_err = (
                    jnp.asarray(a) for a in arrays)
                jdb._X_scale = jdb._normalizer(jdb._Xtrain)
                jdb._Y_scale = jdb._normalizer(jdb._Ytrain)
                for m in (jp.pressure, jp.wall_stress_xz, jp.wall_stress_yz):
                    if not m.is_gp_model:
                        continue

                    def acquire(var, idx=None, m=m, run=run,
                                orig=m._active_learning):
                        vmax[run].append((m.name, float(np.max(var))))
                        orig(var, idx)
                    m._active_learning = acquire
                jp._pre_run()
                jp.run()
        finally:
            gp.fit_hyperparameters, mock.jr = fit, random
    print(f"reorder: the JAX package on the published {NAME}, its initial "
          f"database in two row orders, same fits and draws; variance "
          f"maximum at each acquisition")
    for (name, a), (_, b) in zip(*vmax.values()):
        print(f"  {name}: {a:.9e} vs {b:.9e}, relative {abs(a / b - 1):.3e}")


def published():
    import test_torch_gp_host as T

    class Patch:
        def setattr(self, obj, attr, value):
            setattr(obj, attr, value)
    T.CASES[NAME] = (STEPS, WF, None, ())
    with tempfile.TemporaryDirectory() as tmp:
        (_, jlog, jacq, _), (_, tlog, tacq, _) = T.runs(Path(tmp), Patch(),
                                                        NAME)
    d = [T.scaled(t[0], j[0]) for t, j in zip(tlog, jlog)]
    print(f"published: the port against the JAX package on the published "
          f"{NAME}, {STEPS} steps (tests/test_torch_gp_host.py's harness): "
          f"acquisitions {'identical' if tacq == jacq else 'differ'} "
          f"({len(jacq)} vs {len(tacq)}), q max scaled {max(d):.3e}, dt max "
          f"relative {max(abs(t[1] / j[1] - 1) for t, j in zip(tlog, jlog)):.3e}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        jax_run(sys.argv[2], Path(sys.argv[3]))
    else:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        for what in sys.argv[1:] or ("f32", "reorder", "published"):
            {"f32": f32, "reorder": reorder, "published": published}[what]()
