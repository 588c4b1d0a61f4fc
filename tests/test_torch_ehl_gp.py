"""The port's GP x elastic paths and EHL routes agree with the JAX
package's (CPU, f64).

On the LJ line contact of the JAX package's tests/test_adaptive_device.py
with GP surrogates on the mock oracle (the JAX initial database, noise
draws and, for frozen surrogates, fits carried into the port):

- adaptive dt with frozen surrogates (``run_steps_gp_fast``), with and
  without elastic coupling: the state within 1e-10 scaled, dt and the
  simulated time to rtol 1e-12;
- chunked active learning with elastic coupling, acquisition for
  acquisition;
- ``Problem.run()``'s routes on elastic problems (``ehl_pass2``, the
  non-silent host loop with its topography frames, ``gp_chunked``,
  ``gp_fast``) and the refusals that remain.
"""

import contextlib
import io
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.random as jr
from gapflow_tpu import Problem as JProblem
from gapflow_tpu.md.mock import _sample_key

from gapflow_torch import Problem
from gapflow_torch.core.step import apply_bcs
from gapflow_torch.validate import perturbed_q

from test_torch_ehl import F64, N, lj_sim, scaled, sim, u_err


def gp_pair(tmp_path, text_of, frozen):
    """(JAX Problem, port Problem) after _pre_run on one perturbed state,
    as tests/test_torch_gp_slice.py builds them: the JAX initial database
    and noise draws carried into the port; with ``frozen`` the JAX fits
    and initial dt as well."""
    from gapflow_torch.models.gp import params_to_torch
    with contextlib.redirect_stdout(io.StringIO()), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the line-contact notice
        jp = JProblem.from_string(text_of(tmp_path / "jax"))
        tp = Problem.from_string(text_of(tmp_path / "torch"), device="cpu",
                                 dtype=F64)
        q = apply_bcs(torch.as_tensor(perturbed_q(jp.q, seed=0, amp=1e-3)),
                      tp._solver_cfg).numpy()
        jp.q[...] = q
        jp._pre_run()
        tp.database._md.draws_fn = lambda X: np.asarray(
            jr.normal(_sample_key(X), (13,), dtype=jnp.float64))
        jdb = jp.database
        tp.database.load(np.asarray(jdb._Xtrain), np.asarray(jdb._Ytrain),
                         np.asarray(jdb._Ytrain_err))
        tp.q[...] = q
        tp._pre_run()
    if frozen:
        for mj, mt in zip((jp.pressure, jp.wall_stress_xz, jp.wall_stress_yz),
                          (tp.pressure, tp.wall_stress_xz,
                           tp.wall_stress_yz)):
            assert mt.is_gp_model == mj.is_gp_model
            if not mj.is_gp_model:
                continue
            mt.params = params_to_torch({k: np.asarray(v)
                                         for k, v in mj.params.items()})
            mt.cond_gp = None
        tp.dt = jp.dt
    return jp, tp


@pytest.mark.parametrize("elastic", [False, True])
def test_frozen_gp_adaptive_matches_jax(tmp_path, elastic):
    """Adaptive dt with frozen surrogates (``run_steps_gp_fast``): the GP
    sound speed by autograd, dt refreshed every step; with elastic
    coupling after the deformation, from the deformed gap."""
    jp, tp = gp_pair(tmp_path, lambda out: lj_sim(out, elastic=elastic,
                                                  al="False"), frozen=True)
    with contextlib.redirect_stdout(io.StringIO()):
        jp.run_steps_gp_fast(N)
        tp.run_steps_gp_fast(N)
    assert tp.step == jp.step == N
    assert scaled(tp.q, jp.q) < 1e-10
    assert tp.dt != 0.02
    np.testing.assert_allclose(tp.dt, jp.dt, rtol=1e-12)
    np.testing.assert_allclose(tp.simtime, jp.simtime, rtol=1e-12)
    if elastic:
        assert u_err(tp.topo.deformation,
                     np.asarray(jp.topo.deformation)) < 1e-10


def test_chunked_al_elastic_matches_jax(tmp_path):
    """Chunked active learning on the elastic LJ line contact (fixed dt):
    the same acquisitions, the same acquired samples, the state and the
    deformation; the advance composes the half-space per step."""
    jp, tp = gp_pair(tmp_path, lambda out: lj_sim(out, adaptive=0,
                                                  al="True"), frozen=False)
    with contextlib.redirect_stdout(io.StringIO()):
        j_acq = jp.run_steps_gp_chunked(4)
        t_acq = tp.run_steps_gp_chunked(4)
    assert t_acq == j_acq > 0
    np.testing.assert_allclose(tp.database._Xtrain,
                               np.asarray(jp.database._Xtrain), rtol=1e-12)
    assert scaled(tp.q, jp.q) < 1e-10
    assert u_err(tp.topo.deformation, np.asarray(jp.topo.deformation)) \
        < 1e-10


# ---------------------------------------------------------------------------
# Routes and refusals
# ---------------------------------------------------------------------------

def test_run_routes(tmp_path):
    from gapflow_torch.nc import NCReader
    p = Problem.from_string(sim(16, 8, max_it=3), device="cpu", dtype=F64)
    with contextlib.redirect_stdout(io.StringIO()):
        p.run()
    assert p._route == "ehl_pass2" and p.step == 3
    assert np.abs(p.topo.deformation).max() > 0.

    # non-silent: the per-step host loop with a topography frame per output
    p = Problem.from_string(sim(16, 8, silent="False", out=tmp_path / "o",
                                max_it=4, write_freq=2),
                            device="cpu", dtype=F64)
    with contextlib.redirect_stdout(io.StringIO()):
        p.run()
    assert p._route == "host_loop" and p.step == 4
    with NCReader(str(tmp_path / "o" / "topo.nc")) as nc:
        assert nc.num_frames() == 4               # initial, 0, 2, 4
        np.testing.assert_allclose(nc.field("topography", 3)[3],
                                   p.topo.deformation)


@pytest.mark.parametrize("al,route", [("True", "gp_chunked"),
                                      ("False", "gp_fast")])
def test_run_takes_the_gp_route_on_elastic_problems(tmp_path, al, route):
    text = lj_sim(tmp_path, adaptive=0, al=al, max_it=3)
    with pytest.warns(UserWarning, match="line contact"):
        p = Problem.from_string(text, device="cpu", dtype=F64)
    with contextlib.redirect_stdout(io.StringIO()):
        p.run()
    assert p._route == route and p.step == 3
    assert np.isfinite(p.q).all() and np.abs(p.topo.deformation).max() > 0


def test_refusals(tmp_path):
    p = Problem.from_string(sim(16, 8), device="cpu", dtype=F64)
    for run in (lambda: p.run_steps(2), lambda: p.run_steps_fast(2)):
        with pytest.raises(RuntimeError, match="elastic"):
            run()
    with pytest.warns(UserWarning, match="line contact"):
        # adaptive dt with active learning (the per-step GP loop) and with
        # frozen surrogates are ported
        p = Problem.from_string(lj_sim(tmp_path, al="True"), device="cpu",
                                dtype=F64)
        assert p._route_uses_al() and p.numerics["adaptive"]
        Problem.from_string(lj_sim(tmp_path, al="False"), device="cpu",
                            dtype=F64)
