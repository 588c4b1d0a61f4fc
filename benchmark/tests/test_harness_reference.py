"""The plain reference against the port's plain step (float64, CPU, a
tiny grid): the gap, the CFL step and five MacCormack steps."""

import json

import numpy as np
import pytest
import torch
import yaml

import cellkit  # noqa: F401  (paths)
import inputs
from reference.fv import Solver


def problem_and_reference(config, seed=5, nx=16, ny=12):
    from gapflow_torch import Problem
    cfg = json.loads((cellkit.BENCH / "configs" / f"{config}.json")
                     .read_text())
    traffic = json.loads((cellkit.BENCH / "traffic" / "n2048.json")
                         .read_text())
    traffic.update(Nx=nx, Ny=ny)
    sections = inputs.sections(cfg, traffic, seed, "unused")
    p = Problem.from_string(yaml.safe_dump(sections), device="cpu",
                            dtype=torch.float64)
    p.q[0][...] = inputs.density(cfg, traffic, seed)
    p._pre_run()
    cfg_run = dict(cfg, **{k: sections[k] for k in
                           ("grid", "geometry", "numerics")})
    return p, Solver(cfg_run, nx, ny)


@pytest.mark.parametrize("config", ["journal-dh", "asperity-bwr"])
def test_reference_follows_the_ports_plain_step(config):
    from gapflow_torch.core.step import make_det_step
    p, ref = problem_and_reference(config)
    topo = ref.gap()
    for a, b in zip(p.topo.full[:3], topo):
        assert np.max(np.abs(a - b)) <= 1e-13 * np.max(np.abs(b))
    ref.set_gap(topo)
    q0 = ref.fill_ghosts(torch.tensor(p.q).clone())
    assert ref.dt(torch.tensor(p.q)) == pytest.approx(p.dt, rel=1e-14)
    step = make_det_step(p._solver_cfg, with_aux=False)
    state = p._make_state()._replace(q=q0)
    for _ in range(5):
        state = step(state._replace(dt=torch.tensor(p.dt,
                                                    dtype=torch.float64)))
    q_ref = ref.run(p.q, p.dt, 5)
    inner = (slice(None), slice(1, -1), slice(1, -1))
    diff = (state.q - q_ref)[inner].abs().amax(dim=(1, 2))
    change = (q_ref - q0)[inner].abs().amax(dim=(1, 2))
    assert bool((diff <= 1e-9 * change).all())


def test_seeded_inputs_repeat():
    cfg = json.loads((cellkit.BENCH / "configs" / "asperity-bwr.json")
                     .read_text())
    traffic = {"Nx": 8, "Ny": 8, "max_it": 10, "perturbation":
               {"amplitude": 1e-5, "modes": 4, "max_wavenumber": 4}}
    big = 2 ** 31 + 12345
    a = inputs.density(cfg, traffic, big)
    assert np.array_equal(a, inputs.density(cfg, traffic, big))
    assert not np.array_equal(a, inputs.density(cfg, traffic, big + 1))
    assert np.max(np.abs(a / 0.8 - 1.)) <= 1e-5 * (1 + 1e-12)
    s = inputs.geometry_seed(cfg, big)
    assert s >= big
    from reference.fv import asperity_minima
    mins = asperity_minima(dict(cfg["geometry"], seed=s))
    assert mins.min() >= 12. and mins.max() <= 60.


@pytest.mark.parametrize("config", ["journal-dh", "asperity-bwr"])
def test_end_residual_falls_toward_the_steady_state(config):
    """``end_residual`` of the seeded start against the state the
    reference reaches after 3000 steps: near the steady state the density
    moves a small share of what it moves at the start."""
    import check
    p, ref = problem_and_reference(config)
    ref.set_gap()
    q = torch.tensor(p.q)
    at_start = check.residual(ref, q, 64)
    later = ref.run(q, ref.dt(q, factor=0.9), 3000)
    assert check.residual(ref, later, 64) < 0.1 * at_start
    # the density alone, in float32 units of its largest value
    moved = ref.run(q, ref.dt(q, factor=0.9), 64)[0, 1:-1, 1:-1]
    assert at_start == pytest.approx(
        float((moved - q[0, 1:-1, 1:-1]).abs().max()
              / (2. ** -24 * q[0, 1:-1, 1:-1].abs().max())))
