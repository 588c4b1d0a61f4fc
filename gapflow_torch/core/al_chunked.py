"""Chunked device/host GP active learning: host protocol, device stepping.

Counterpart of :mod:`gapflow_tpu.core.al_chunked` (one device).  It
keeps the exact host protocol of the reference
(GaPFlow/models/gp.py:419-506): per-acquisition max-abs renormalization,
scipy-BFGS hyperparameter refits, per-surrogate budgets and pause
counters, while the fluid steps between acquisitions run on the device:

- the device advances GP-closed MacCormack steps (``core.gp_step``: the
  GP kernels on a float32 CUDA state) while every unpaused surrogate's
  predictive variance over the candidate cells stays below its
  tolerance, checking it before each step like a host predictor pass
  (padded ``al_jit`` buffers);
- the moment a surrogate needs data the advance returns, without
  stepping;
- the host then decides with its own float64 variance, acquires the
  argmax-variance point through ``Database.add_data`` (MD oracle, dataset
  packaging, renormalization), retrains with BFGS, rebuilds the padded
  buffers under the new normalization, and re-enters at the same step
  (the pause decrement is skipped on re-entry).

Elastic problems compose (multiscale EHL, reference
GaPFlow/problem.py:565-569, topography.py:424-441): per step the
topography is rebuilt from the carried deformation, and after the step
the pass-2 pressure deforms the surface under-relaxed, the host
``topo.update()`` sequencing.  The advance then needs the pass-2
pressure, so periodic domains take the GP kernel with its pressure
output and D/N domains the plain GP step (as on the TPU).

The JAX package runs the advance as one ``lax.while_loop`` on the device;
here it is a Python loop over steps.  The trigger ``max(var) >= tol`` is
evaluated on the device for every checked surrogate, and the stacked
flags are the one host synchronisation per step.  The check runs in
float64 whatever the state's dtype (the JAX package uses the working
dtype): the variance ``amp + yerr^2 - |Linv k|^2`` cancels
catastrophically in float32, and on a few-point database it comes out
negative or far below the host's float64 variance, so a float32 check
misses acquisitions the host protocol makes.

Also here, from the JAX package's ``core.al_loop`` (whose all-device loop
is not ported): :func:`_surrogate_specs`, :func:`_tol_norm` and
:func:`init_gp_states`.
"""

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from ..models import al_jit
from .gp_step import make_gp_step_core, _features

_Y_COLS = {"z": (0,), "x": (5, 11), "y": (4, 10)}
_KEYS = ("z", "x", "y")


class SurrogateSpec(NamedTuple):
    """Static per-surrogate configuration (hashable)."""

    dims: tuple          # active feature dims
    ycols: tuple         # columns of the 13-wide Y record
    atol: float
    rtol: float
    max_steps: int       # acquisition budget per timestep
    pause_steps: int
    use_al: bool


def _models(problem):
    return dict(zip(_KEYS, (problem.pressure, problem.wall_stress_xz,
                            problem.wall_stress_yz)))


def _surrogate_specs(problem):
    specs = {}
    for key, m in _models(problem).items():
        if not m.is_gp_model:
            continue
        specs[key] = SurrogateSpec(
            dims=tuple(int(d) for d in m.active_dims),
            ycols=_Y_COLS[key],
            atol=float(m.atol), rtol=float(m.rtol),
            max_steps=int(m.max_steps), pause_steps=int(m.pause_steps),
            use_al=bool(m.use_active_learning))
    return specs


def _tol_norm(spec, yerr):
    """Variance tolerance in normalized-target units (host form:
    max_var * Yscale^2 < max(atol * Yerr * Yscale, rtol * Yscale)^2)."""
    return max(spec.atol * yerr, spec.rtol) ** 2


def init_gp_states(problem, capacity=64, dtype=None):
    """PaddedGP per active surrogate from the current host fit, plus the
    pause counters.  The buffers are conditioned in float64 on the CPU
    and then cast to ``dtype`` (the Problem's by default) on its
    device."""
    db = problem.database
    specs = _surrogate_specs(problem)
    models = _models(problem)
    if capacity < db.size:
        raise ValueError(f"capacity {capacity} < database size {db.size}")

    gps, pauses = {}, {}
    for k, spec in specs.items():
        m = models[k]
        X0 = torch.as_tensor(db.Xtrain[:, list(spec.dims)])
        Ycols = db._Ytrain[:, list(spec.ycols)] / m.Yscale
        Y0 = torch.as_tensor(Ycols[:, 0] if len(spec.ycols) == 1 else Ycols)
        gp = al_jit.init(m.params, capacity, X0, Y0, m.Yerr)
        gps[k] = al_jit.cast(gp, dtype or problem.dtype, problem.device)
        pauses[k] = int(m._pause)
    return gps, pauses


def gp_state_of(gps, Xscale, Yscales):
    """The ``core.gp_step`` state of padded buffers."""
    state = {"Xscale": Xscale}
    for k, g in gps.items():
        state[f"params_{k}"] = g.params
        state[f"Xfit_{k}"] = g.X
        state[f"alpha_{k}"] = g.alpha
        state[f"Yscale_{k}"] = Yscales[k]
    return state


@functools.lru_cache(maxsize=16)
def make_advance_fn(cfg, specs_t, dims3, nfeat, use3, ncells, n_candidates,
                    allow_pallas=True):
    """Cached non-elastic :func:`_build_advance` (``problem``-free, so
    cached per configuration)."""
    return _build_advance(cfg, specs_t, dims3, nfeat, use3, ncells,
                          n_candidates, allow_pallas, None)


def _build_advance(cfg, specs_t, dims3, nfeat, use3, ncells, n_candidates,
                   allow_pallas, elastic_fns):
    """``advance``: GP-closed steps until a surrogate needs data.

    ``advance(q, topo, extra, u, gps, pauses, Xscale, Yscales, step0, dt,
    n_rem, skip_first, suppress) -> (q, u, steps_done, needs, pauses,
    peaks)`` runs at most ``n_rem`` steps on ghost-inclusive device
    arrays and returns early, before the offending step, when an unpaused
    surrogate's maximum predictive variance over the candidate cells
    reaches its tolerance.  ``needs`` is one trigger flag per surrogate
    (specs order); the host makes the acquisition decision.  ``peaks``
    holds the last check's maximum variance per checked surrogate (0-d
    device tensors).  ``skip_first`` suppresses the pause decrement of
    the first step attempt (re-entry at the same step); ``suppress[k]``
    masks surrogate k's trigger for that first attempt (the host ruled k
    trusted at the contested step).  ``allow_pallas=False`` keeps the
    plain GP step on every state.

    ``elastic_fns = (deformation function, h_undeformed, alpha,
    shift_ref)`` composes the half-space: step 0 of the call uses
    ``topo`` (the host field) verbatim, later steps the topography of the
    carried deformation ``u`` (the unshifted relaxed state, shifted by
    u[0, 0] for half/none periodicity where applied), which the pass-2
    pressure updates after every step.  Non-elastic problems pass
    ``u=None`` through."""
    from .ehl import _topo_from_deformation
    specs = dict(specs_t)
    keys = list(specs)
    elastic = elastic_fns is not None
    # a non-elastic advance discards p_last: periodic domains take the
    # kernel variant without the pressure, uniform D/N domains the
    # boundary kernel
    step_core = make_gp_step_core(cfg, dims3, nfeat, use3, allow_pallas,
                                  need_p=elastic)
    if elastic:
        hs_deform, h_und, alpha, shift_ref = elastic_fns
    stride = (max(1, ncells // n_candidates)
              if n_candidates and n_candidates < ncells else None)

    def advance(q, topo, extra, u, gps, pauses, Xscale, Yscales, step0, dt,
                n_rem, skip_first, suppress, stats=None):
        gp_state = gp_state_of(gps, Xscale, Yscales)
        stepper = step_core.prepare(q, topo, extra, gp_state)
        s = stepper.inner(q)
        topo_d = topo
        cand = (None if stride is None
                else torch.arange(0, ncells, stride, device=q.device))
        tols = {k: _tol_norm(specs[k], float(gps[k].yerr)) for k in keys}
        pauses = dict(pauses)
        needs = [False] * len(keys)
        peaks = {}
        i = 0
        while i < n_rem:
            # host predict(): the pause decrements at every predictor pass
            # start, before the variance check
            if not (skip_first and i == 0):
                pauses = {k: max(-1, p - 1) for k, p in pauses.items()}
            if elastic and i > 0:
                # the gap of the carried deformation; the step's statics
                # follow it
                u_eff = u - u[0, 0] if shift_ref else u
                topo_d = _topo_from_deformation(
                    h_und, u_eff.to(q.dtype), cfg.dx, cfg.dy)
                q_full = stepper.full(s)
                stepper = step_core.prepare(q_full, topo_d, extra, gp_state)
                s = stepper.inner(q_full)
            checked = [k for k in keys
                       if specs[k].use_al and pauses[k] < 0
                       and not (suppress[k] and i == 0)]
            if checked:
                Xf = (_features(stepper.full(s), topo_d, extra)
                      .reshape(nfeat, -1).T.to(Xscale.dtype)
                      / Xscale[None, :])
                if cand is not None:
                    Xf = Xf[cand]
                peaks = {k: al_jit.predict(gps[k], Xf[:, list(specs[k].dims)])
                         [1].max() for k in checked}
                flags = torch.stack([peaks[k] >= tols[k]
                                     for k in checked]).tolist()
                if stats is not None:
                    stats["checks"] += len(checked)
                needs = [k in checked and flags[checked.index(k)]
                         for k in keys]
                if any(needs):
                    break
            s, p = stepper.step(s, dt, step0 + i)
            if elastic:
                # host topo.update() after the step: the pass-2 pressure
                if shift_ref:
                    p = p - p[0, 0]
                u = (1. - alpha) * u + alpha * hs_deform(p.to(u.dtype))
            i += 1
        return stepper.full(s), u, i, needs, pauses, peaks

    return advance


def _next_capacity(n):
    cap = 16
    while cap < n:
        cap *= 2
    return cap


def new_stats():
    """Counters and host-clock seconds of :func:`run_gp_al_chunked`:
    steps, variance checks (one per checked surrogate and step attempt),
    acquisitions, and the time in the device advance (stepping, checks,
    their synchronisations) and in the host protocol (variance,
    acquisition, BFGS, buffer rebuild).  ``triggers`` lists every device
    trigger as ``(step, surrogate, peak / tol, outcome)``: the device's
    maximum variance over its tolerance, and the host's verdict
    (``"acquired"``, ``"trusted"`` or ``"budget"``)."""
    return {"steps": 0, "checks": 0, "acquisitions": 0, "advance_s": 0.,
            "host_s": 0., "triggers": []}


def run_gp_al_chunked(problem, n_steps, capacity=None, n_candidates=None,
                      allow_pallas=True):
    """Advance ``n_steps`` GP-surrogate timesteps with host-protocol AL.

    Returns the number of acquisitions; adds its counters to
    ``problem.al_stats`` (:func:`new_stats`).  All database, training and
    pause bookkeeping follows ``models.gp`` ``predict`` exactly.
    ``allow_pallas=False`` steps with the plain GP step on every state."""
    db = problem.database
    specs = _surrogate_specs(problem)
    if not specs:
        raise ValueError("no GP surrogates on this problem")
    models = {k: m for k, m in _models(problem).items() if k in specs}
    stats = problem.al_stats

    tic = time.perf_counter()
    # host predict() trains at pass start whenever the database grew
    for m in models.values():
        if m.params is None or m.last_fit_train_size < db.size:
            m._train(reason=0)

    nfeat = db.num_features
    dims3 = tuple(tuple(specs[k].dims) if k in specs else None
                  for k in _KEYS)
    use3 = tuple(k in specs for k in _KEYS)
    ncells = int(np.prod(problem.q.shape[1:]))
    if n_candidates is None:
        n_candidates = max(int(getattr(m, "al_candidates", 0) or 0)
                           for m in models.values())
    elastic = problem.topo.elastic
    u = None
    if elastic:
        ed = problem.topo.ElasticDeformation
        shift_ref = ed.periodicity in ("half", "none")
        advance = _build_advance(
            problem._solver_cfg, tuple(specs.items()), dims3, nfeat, use3,
            ncells, int(n_candidates), allow_pallas,
            (ed.deformation_full, problem._tensor(problem.topo.h_undeformed),
             float(ed.alpha_underrelax), shift_ref))
        u = ed.u_prev
    else:
        advance = make_advance_fn(problem._solver_cfg, tuple(specs.items()),
                                  dims3, nfeat, use3, ncells,
                                  int(n_candidates), allow_pallas)

    q = problem._tensor(problem.q)
    topo = problem._tensor(problem.topo.full)
    extra = problem._tensor(problem.fc.get_real_field("extra").p)
    dt = float(problem.dt)

    def _sync_state(total_steps):
        """Mirror the device state into the host fields (the host
        variance and acquisition read them).  The topography is rewritten
        only once a step has advanced: before the first ``topo.update()``
        the host field carries the geometry's analytic gradients, which
        the ``h`` setter would replace by numerical ones."""
        problem.q[...] = q.cpu().numpy()
        if elastic and total_steps > 0:
            ed.u_prev = u
            u_np = u.cpu().numpy()
            shift = u_np[0, 0] if shift_ref else 0.
            problem.topo.deformation = u_np - shift
            # the h setter refreshes the gradients (host update() order)
            problem.topo.h = problem.topo.h_undeformed + (u_np - shift)

    steps_done = 0
    n_acquired = 0
    counters = {k: 0 for k in specs}
    suppressed = {k: False for k in specs}
    skip_first = False

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=problem.device)

    while steps_done < n_steps:
        cap = capacity or _next_capacity(db.size + 1)
        # float64 buffers for the variance check; the step casts them to
        # the state's dtype
        gps, pauses = init_gp_states(problem, cap, torch.float64)
        Yscales = {k: f64(models[k].Yscale) for k in specs}
        Xscale = f64(db.X_scale)
        if elastic:
            # the advance's first step takes the host field verbatim
            # (refreshed by _sync_state after the last exit)
            topo = problem._tensor(problem.topo.full)
        stats["host_s"] += time.perf_counter() - tic

        tic = time.perf_counter()
        q, u, steps, needs, pauses, peaks = advance(
            q, topo, extra, u, gps, pauses, Xscale, Yscales,
            problem.step + steps_done, dt, n_steps - steps_done,
            skip_first, suppressed, stats)
        stats["advance_s"] += time.perf_counter() - tic

        tic = time.perf_counter()
        for k in specs:
            models[k]._pause = int(pauses[k])

        if steps > 0:
            # the device advanced past the last contested step: the
            # per-step acquisition budgets (and trusted-rule suppressions)
            # reset, as host predict() starts a fresh loop every pass
            counters = {k: 0 for k in specs}
            suppressed = {k: False for k in specs}
        steps_done += steps

        if not any(needs):
            break

        k = next(k for i, k in enumerate(specs) if needs[i])
        m, spec = models[k], specs[k]
        skip_first = True
        trigger = [problem.step + steps_done, k,
                   float(peaks[k]) / _tol_norm(spec, float(gps[k].yerr))]

        # the host decides with its own dense variance (models.gp
        # predict()), from the contested step's state (and topography)
        _sync_state(problem.step + steps_done)
        cand = m._candidate_indices() if spec.use_al else None
        if cand is None:
            m._infer(compute_var=True)
            v_acq = m._predictive_var
        else:
            v_acq = m._infer_subset_var(cand)

        if m.trusted:
            # rounding disagreement at the threshold: the host verdict
            # stands; mask this surrogate's trigger for the contested step
            suppressed[k] = True
            stats["triggers"].append((*trigger, "trusted"))
            continue

        if counters[k] >= spec.max_steps:
            # host: "Active learning loop missed uncertainty threshold"
            m._pause = spec.pause_steps
            stats["triggers"].append((*trigger, "budget"))
            continue

        # host _active_learning + _train(reason=1)
        stats["triggers"].append((*trigger, "acquired"))
        m._active_learning(v_acq, idx=cand)
        counters[k] += 1
        n_acquired += 1
        m._train(reason=1)
        # the other surrogates see the grown database at their next
        # predictor pass, which is this step, resumed on re-entry
        for mm in models.values():
            if mm.last_fit_train_size < db.size:
                mm._train(reason=0)

    _sync_state(problem.step + steps_done)
    for m in models.values():
        m._step += n_steps
        m.cond_gp = None
    problem.step += n_steps
    problem.simtime += n_steps * float(problem.dt)
    stats["host_s"] += time.perf_counter() - tic
    stats["steps"] += n_steps
    stats["acquisitions"] += n_acquired
    return n_acquired
