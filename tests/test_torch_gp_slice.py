"""The port's GP-surrogate path agrees with the JAX package's (CPU, f64).

One 32 x 128 journal bearing with all three surrogates on the mock
oracle, in both packages: the same configuration, the same perturbed
initial state (numpy, seed 0: without it the y-uniform, mirror-symmetric
journal has exactly tied variance maxima, which either package may break
either way), the JAX package's initial database carried into the port
(its sampler draws differ) and the JAX package's noise draws injected
into the port's mock oracle.

- chunked active learning (``run_steps_gp_chunked``): the same number of
  acquisitions, the same acquired samples (rtol 1e-12), the
  hyperparameters within 1e-8 (their logs, absolute), the same pause
  counters, the final state within 1e-10 scaled;
- frozen surrogates (``run_steps_gp_fast``, the JAX package's fits
  carried over as well): the final state and the pressure field within
  1e-10 scaled;
- ``Problem.run()`` takes the chunked or the frozen route, and the GP
  configurations the port does not cover yet raise, naming their
  ROADMAP item.

The surrogates are chosen so that every BFGS fit has a well-posed
optimum: the pressure GP sees the density only (the DH pressure depends
on nothing else; with the gap height as a second input its length scale
runs off along a flat ridge and two correct optimizers stop 1e-6 apart),
with an observation noise that regularizes the fit.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.random as jr
from gapflow_tpu import Problem as JProblem
from gapflow_tpu.md.mock import _sample_key

from gapflow_torch import Problem
from gapflow_torch.models.gp import params_to_torch
from gapflow_torch.validate import gp_yaml, kernel_vs_plain_err, perturbed_q

NX, NY, N = 32, 128, 4


def gp_section(al):
    return (f"press: {{fix_noise: True, atol: 2., rtol: 0., "
            f"obs_stddev: 1.e8, max_steps: 2, active_dims: [0], "
            f"active_learning: {al}}}, "
            f"shear: {{fix_noise: True, atol: 2., rtol: 0., obs_stddev: 1., "
            f"max_steps: 2, active_learning: {al}}}")


def jax_draws(X):
    return np.asarray(jr.normal(_sample_key(X), (13,), dtype=jnp.float64))


def pair(tmp_path, al, init_size=4):
    """(JAX Problem, port Problem) after _pre_run, from one configuration,
    perturbed state and initial database."""
    def text(tag):
        return gp_yaml(NX, NY, gp=gp_section(al), out=str(tmp_path / tag),
                       dtool_path=str(tmp_path / f"{tag}_train"),
                       init_method="lhc", init_width=1e-2,
                       init_size=init_size)

    with contextlib.redirect_stdout(io.StringIO()):
        jp = JProblem.from_string(text("jax"))
        q = perturbed_q(jp.q, seed=0, amp=1e-3)
        jp.q[...] = q
        jp._pre_run()
        tp = Problem.from_string(text("torch"), device="cpu",
                                 dtype=torch.float64)
        tp.database._md.draws_fn = jax_draws
        jdb = jp.database
        tp.database.load(np.asarray(jdb._Xtrain), np.asarray(jdb._Ytrain),
                         np.asarray(jdb._Ytrain_err))
        tp.q[...] = q
        tp._pre_run()
    return jp, tp


def models(p):
    return (p.pressure, p.wall_stress_xz, p.wall_stress_yz)


def scaled(a, b):
    return kernel_vs_plain_err(torch.as_tensor(np.array(a)),
                               torch.as_tensor(np.array(b)))


def test_chunked_active_learning_matches_jax(tmp_path):
    jp, tp = pair(tmp_path, "True")
    with contextlib.redirect_stdout(io.StringIO()):
        j_acq = jp.run_steps_gp_chunked(N)
        t_acq = tp.run_steps_gp_chunked(N)

    assert t_acq == j_acq > 0
    assert tp.database.size == jp.database.size
    np.testing.assert_allclose(tp.database._Xtrain,
                               np.asarray(jp.database._Xtrain), rtol=1e-12)
    for mj, mt in zip(models(jp), models(tp)):
        for k in mj.params:
            np.testing.assert_allclose(mt.params[k].numpy(),
                                       np.asarray(mj.params[k]), rtol=0.,
                                       atol=1e-8)
        assert mt._pause == mj._pause
    assert tp.step == jp.step == N
    assert tp.al_stats["acquisitions"] == t_acq
    assert scaled(tp.q, jp.q) < 1e-10


def test_frozen_surrogates_match_jax(tmp_path):
    """The JAX package's fits are carried over too: frozen, the
    surrogates keep the 4-point initial fits, whose optima are flat."""
    jp, tp = pair(tmp_path, "False")
    for mj, mt in zip(models(jp), models(tp)):
        mt.params = params_to_torch({k: np.asarray(v)
                                     for k, v in mj.params.items()})
        mt.cond_gp = None
    with contextlib.redirect_stdout(io.StringIO()):
        jp.run_steps_gp_fast(N)
        assert tp.run_steps_gp_chunked(N) == 0      # delegates
    assert tp.step == jp.step == N
    assert tp.database.size == jp.database.size
    assert scaled(tp.q, jp.q) < 1e-10
    pj = np.asarray(jp.pressure.pressure)
    assert (np.abs(tp.pressure.pressure - pj).max() / np.abs(pj).max()
            < 1e-10)


def test_float32_state_triggers_as_float64(tmp_path):
    """On a float32 state the AL variance check runs in float64, so the
    first step triggers, and the host acquires, as in a float64 run from
    the same state.  (In float32 the variance of this 4-point database
    cancels to noise, negative or below the host's, and acquisitions are
    missed.)"""
    from gapflow_torch.validate import GP_CASES
    q0, runs = None, []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        p = Problem.from_string(
            gp_yaml(32, 32, gp=GP_CASES["all"], max_it=1,
                    out=str(tmp_path / tag),
                    dtool_path=str(tmp_path / f"{tag}_train")),
            device="cpu", dtype=dtype)
        q0 = np.array(p.q, dtype=np.float32) if q0 is None else q0
        p.q[...] = q0
        with contextlib.redirect_stdout(io.StringIO()):
            p._pre_run()
            p.run_steps_gp_chunked(1)
        runs.append(p)
    t32, t64 = (p.al_stats["triggers"] for p in runs)
    assert any(t[3] == "acquired" for t in t64)
    assert [(s, k, v) for s, k, _, v in t32] == \
        [(s, k, v) for s, k, _, v in t64]
    np.testing.assert_allclose([t[2] for t in t32], [t[2] for t in t64],
                               rtol=1e-3)
    np.testing.assert_allclose(runs[0].database._Xtrain,
                               runs[1].database._Xtrain, rtol=1e-6)


@pytest.mark.parametrize("al,route", [("True", "gp_chunked"),
                                      ("False", "gp_fast")])
def test_run_takes_the_gp_route(tmp_path, al, route):
    text = gp_yaml(16, 8, gp=gp_section(al), max_it=3,
                   out=str(tmp_path / "o"),
                   dtool_path=str(tmp_path / "train"))
    p = Problem.from_string(text, device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(io.StringIO()):
        p.run()
    assert p._route == route and p.step == 3
    assert np.isfinite(p.q).all() and (p.q[0] > 0).all()
    assert np.isfinite(p.pressure.pressure).all()
    assert p.database.size >= 4


@pytest.mark.parametrize("change", [
    ("silent: True", "silent: False"),
    ("adaptive: 0", "adaptive: 1"),
    ("max_it: 10}", "max_it: 10, gp_fast_pred: True}"),
    ("db: {", "md: {system: lj}\ndb: {"),
])
def test_unported_gp_configs_raise(tmp_path, change):
    """gp_fast_pred and an md: section raise, naming their ROADMAP item.
    Non-silent GP runs and adaptive dt with active learning, which raised
    the same way until the per-step GP loop was ported, build (and take
    that loop: tests/test_torch_gp_host.py)."""
    text = gp_yaml(16, 8, out=str(tmp_path / "o"),
                   dtool_path=str(tmp_path / "train"))
    assert change[0] in text
    if change[0] in ("silent: True", "adaptive: 0"):
        p = Problem.from_string(text.replace(*change), device="cpu",
                                dtype=torch.float64)
        assert p.has_gp_model
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Problem.from_string(text.replace(*change), device="cpu",
                            dtype=torch.float64)


def test_all_device_al_loop_not_ported(tmp_path):
    text = gp_yaml(16, 8, out=str(tmp_path / "o"),
                   dtool_path=str(tmp_path / "train"))
    p = Problem.from_string(text, device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p.run_steps_gp_device(2)


def test_cli_runs_a_gp_config(tmp_path):
    """python -m gapflow_torch on a silent GP configuration."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    cfg = tmp_path / "gp.yaml"
    cfg.write_text(gp_yaml(16, 8, gp=gp_section("True"), max_it=2,
                           out=str(tmp_path / "o"),
                           dtool_path=str(tmp_path / "train")))
    env = {k: v for k, v in os.environ.items() if k != "GAPFLOW_X64"}
    res = subprocess.run([sys.executable, "-m", "gapflow_torch", "-i",
                          str(cfg), "--device", "cpu"],
                         cwd=Path(__file__).resolve().parents[1], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert len(list((tmp_path / "train").iterdir())) >= 4
