"""The Problem: configuration, time loop, I/O and model orchestration.

Counterpart of :class:`gapflow_tpu.problem.Problem`: analytic
constitutive laws or GP surrogates on the mock MD oracle, rigid or
elastic (FFT half-space) topography.  Fields live in a host
:class:`~gapflow_torch.fields.FieldCollection` of numpy arrays
(float64); the solver runs on ``device`` in ``dtype``.  Deterministic
problems take one of two execution paths, as in the JAX package:

- silent runs advance on the device without per-step host I/O: float32 on
  a CUDA device with a configuration the fused kernels cover (periodic,
  Dirichlet/Neumann or mixed per-component edges, shear thinning
  included) takes :meth:`run_compiled_fast` (the CUDA kernels of
  :mod:`ops.stencil` and :mod:`ops.mixed_bc`, residual checked between
  chunks); anything else takes
  :meth:`run_compiled` (the plain torch step, reference per-step
  semantics);
- non-silent runs advance ``write_freq`` steps at a time
  (:meth:`run_steps`) and write a frame after each chunk.

Silent GP and elastic problems advance in device chunks
(:meth:`_run_device_multiscale`): with active learning on any surrogate
through :meth:`run_steps_gp_chunked` (host acquisition protocol between
device advances), with frozen surrogates through
:meth:`run_steps_gp_fast`, deterministic elastic problems through
:meth:`_run_steps_ehl_pass2` (the host ``update()`` protocol on the
device); float32 CUDA states take the GP kernels of
:mod:`ops.stencil_gp`.  Adaptive dt rides the device loops except with
active learning.  Non-silent GP and elastic runs, and silent GP runs with
adaptive dt and active learning, take the per-step host loop
(:meth:`update`, a frame every ``write_freq`` steps): a GP step is the
host protocol pass by pass (:meth:`_update_gp`: the surrogates predict,
retrain and acquire between the two MacCormack passes), or, when no
surrogate may retrain or acquire and no output is due, one fused GP step
(:meth:`_update_gp_fused`, the GP kernels on a covered float32 CUDA
state).  :meth:`run_steps_ehl` is the fast EHL loop (end-of-step
pressure; the EHL kernel K8 on a covered float32 CUDA state).
:meth:`run_steps_sharded` decomposes deterministic and deterministic
elastic runs over a mesh of shards (:mod:`gapflow_torch.parallel`; the
shard sweep on a covered float32 CUDA mesh).

Not ported yet (ROADMAP queue 1): ``numerics: gp_fast_pred``, a real MD
engine, the sharded GP families.  Configurations and calls that need
them raise ``NotImplementedError``.
"""

import os
from collections import deque
from datetime import datetime

import numpy as np
import torch

from . import DTYPE, __version__
from .config import (read_yaml_input, read_yaml_string, write_yaml,
                     create_output_directory, history_to_csv)
from .core.al_chunked import (_next_capacity, _surrogate_specs, gp_state_of,
                              init_gp_states, new_stats, run_gp_al_chunked)
from .core.ehl import make_ehl_loop, make_gp_ehl_loop
from .core.gp_step import (make_gp_adaptive_loop, make_gp_step,
                           make_gp_step_core)
from .core.state import SimState
from .core.step import (SolverConfig, apply_bcs, make_det_step,
                        make_pass_fn, make_run_loop, make_trajectory,
                        mc_directions)
from .db import Database
from .fields import FieldCollection
from .md import Mock
from .models import Pressure, WallStress, BulkStress
from .models.eos import eos_pressure, eos_sound_velocity
from .nc import NCWriter
from .ops.mixed_bc import mixed_supported
from .ops.stencil import (K_MULTI, interior_statics, make_pallas_loop,
                          pallas_supported, with_ghosts)
from .ops.stencil_gp import gp_step, gp_steps, prep_gp_ops
from .topography import Topography
from .utils import handle_signals, get_termination_signals, set_quiet, echo


def resolve_device(device):
    """``torch.device`` for ``device``; a CUDA device without CUDA raises
    (there is no implicit CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


class Problem:
    """A gap-averaged lubrication flow problem.

    Use :meth:`from_yaml` / :meth:`from_string` to construct from sanitized
    YAML input.  ``device`` is where the solver runs (default ``cuda``);
    ``dtype`` its float type (default :data:`gapflow_torch.DTYPE`).
    ``gp`` (the sanitized ``gp:`` section) and ``database`` (a
    :class:`~gapflow_torch.db.Database`) make the pressure and wall
    stresses GP surrogates.
    """

    def __init__(self, options, grid, numerics, prop, geo, device="cuda",
                 dtype=None, gp=None, database=None):
        self.device = resolve_device(device)
        self.dtype = DTYPE if dtype is None else dtype

        self.options = options
        set_quiet(options.get("silent", False))
        self.grid = grid
        self.numerics = numerics
        self.geo = geo
        self.prop = prop

        nb_grid_pts = (grid["Nx"] + 2, grid["Ny"] + 2)
        fc = FieldCollection(nb_grid_pts)
        self.fc = fc

        # solution field
        self.step = None
        self.__field = fc.real_field("solution", (3,))
        self._initialize(rho0=prop["rho0"], U=geo["U"], V=geo["V"])

        # extra features (slip length, zero)
        fc.real_field("extra", (1,))

        fc.register_real_field("x")
        fc.register_real_field("y")
        fc.register_real_field("pressure")
        fc.register_real_field("topography", (4,))

        gpx, gpy, gpz = self._select_gp_config(gp)
        self.has_gp_model = bool(gp)
        self.database = database
        self.al_stats = new_stats()
        model_args = (fc, prop, geo, self.device, self.dtype)
        self.pressure = Pressure(*model_args, data=database, gp=gpz)
        self.bulk_stress = BulkStress(*model_args)
        self.wall_stress_xz = WallStress(*model_args, direction="x",
                                         data=database, gp=gpx)
        self.wall_stress_yz = WallStress(*model_args, direction="y",
                                         data=database, gp=gpy)

        self.topo = Topography(fc, grid, geo, prop, device=self.device,
                               dtype=self.dtype)

        self._solver_cfg = SolverConfig.from_dicts(grid, geo, prop, numerics)
        self._det_step = None
        self._pass_fn = None
        self._route = None
        #: fused steps of the per-step GP loop (:meth:`_update_gp_fused`)
        self._fused_steps = 0

        # I/O
        if not options["silent"]:
            self.outdir = create_output_directory(options["output"],
                                                  options["use_tstamp"])
            if database is not None:
                database.set_training_path(os.path.join(self.outdir, "train"),
                                           check_temporary=True)
                database.output_path = self.outdir
                options["output"] = self.outdir

            full_dict = {"version": __version__}
            for k, v in zip(["options", "grid", "numerics", "geo", "prop"],
                            [options, grid, numerics, geo, prop]):
                full_dict[k] = v
            if database is not None:
                full_dict["gp"] = gp
                full_dict["db"] = database.config
                full_dict["md"] = database.md_config
            write_yaml(full_dict, os.path.join(self.outdir, "config.yml"))

            # topography output: once, or a frame per output when elastic
            self.topofile = NCWriter(os.path.join(self.outdir, "topo.nc"),
                                     fc, field_names=["topography"])
            self.topofile.append_frame().write()
            if not self.topo.elastic:
                self.topofile.close()

            field_names = ["solution", "pressure", "wall_stress_xz",
                           "wall_stress_yz"]
            if gpx is not None:
                field_names.append("wall_stress_xz_var")
            if gpy is not None:
                field_names.append("wall_stress_yz_var")
            if gpz is not None:
                field_names.append("pressure_var")
            self.file = NCWriter(os.path.join(self.outdir, "sol.nc"), fc,
                                 field_names=field_names)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @staticmethod
    def _get_mandatory_input(input_dict):
        return (input_dict["options"], input_dict["grid"],
                input_dict["numerics"], input_dict["properties"],
                input_dict["geometry"])

    @staticmethod
    def _check_ported(input_dict):
        """Refuse what the port does not run yet, naming its ROADMAP item
        (queue 1), rather than run it another way."""
        def refuse(what, item):
            raise NotImplementedError(
                f"{what} is not ported to gapflow_torch yet (ROADMAP queue "
                f"1, item {item}); run it with gapflow_tpu")

        if input_dict.get("md"):
            refuse("a real MD engine (md: section)", "10")
        if (input_dict.get("gp") or input_dict.get("db")) \
                and input_dict["numerics"].get("gp_fast_pred"):
            refuse("numerics: gp_fast_pred", "8b")

    @classmethod
    def from_yaml(cls, fname, device="cuda", dtype=None):
        """Build a Problem from a YAML file."""
        print(f"Reading input file: {fname}")
        with open(fname) as ymlfile:
            input_dict = read_yaml_input(ymlfile)
        return cls._from_dict(input_dict, device, dtype)

    @classmethod
    def from_string(cls, ymlstring, device="cuda", dtype=None):
        """Build a Problem from a YAML string."""
        return cls._from_dict(read_yaml_string(ymlstring), device, dtype)

    @staticmethod
    def _get_optional_input(input_dict):
        gp, db = input_dict.get("gp"), input_dict.get("db")
        if db is None:
            return {"gp": gp, "database": None}
        md = Mock(input_dict["properties"], input_dict["geometry"], gp)
        return {"gp": gp, "database": Database(md, db)}

    @classmethod
    def _from_dict(cls, input_dict, device, dtype):
        cls._check_ported(input_dict)
        return cls(*cls._get_mandatory_input(input_dict), device=device,
                   dtype=dtype, **cls._get_optional_input(input_dict))

    # ------------------------------------------------------------------
    # Field accessors / scalars (host arrays)
    # ------------------------------------------------------------------

    @property
    def q(self):
        """The conserved-variable field (rho, jx, jy), ghost cells included."""
        return self.__field.p

    @property
    def q_has_nan(self):
        return bool(np.any(np.isnan(self.q)))

    @property
    def q_has_negative_density(self):
        return bool(np.any(self.q[0] < 0.))

    @property
    def q_is_valid(self):
        return not self.q_has_nan and not self.q_has_negative_density

    @property
    def mass(self):
        """Total mass integrated over the domain."""
        return np.sum(self.q[0] * self.topo.h
                      * self.grid["dx"] * self.grid["dy"])

    @property
    def kinetic_energy(self):
        return np.sum((self.q[1] ** 2 + self.q[2] ** 2) / self.q[0] / 2.)

    @property
    def v_max(self):
        return np.sqrt((self.q[1] ** 2 + self.q[2] ** 2) / self.q[0]).max()

    @property
    def dt_crit(self):
        """Critical timestep from grid spacing, flow speed and sound speed."""
        return (min(self.grid["dx"], self.grid["dy"])
                / (self.v_max + self.pressure.v_sound))

    @property
    def cfl(self):
        return self.dt / self.dt_crit

    @property
    def converged(self):
        return bool(np.all(np.array(self.residual_buffer) < self.tol))

    # ------------------------------------------------------------------
    # Run loop
    # ------------------------------------------------------------------

    def run(self, keep_open=False):
        """Advance until convergence, max_it, or a termination signal.

        If ``options['profile']`` is set, the run is traced with
        ``torch.profiler`` into ``<profile>/trace.json`` (Chrome trace).
        """
        profile_dir = self.options.get("profile")
        if not profile_dir:
            return self._run(keep_open)
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            self._run(keep_open)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    def _run(self, keep_open=False):
        if self.step is None:
            self._pre_run()

        self._stop = False
        self.history = {"step": [], "time": [], "ekin": [],
                        "residual": [], "vsound": []}

        # Silent runs need no per-step host I/O: the whole convergence loop
        # runs on the device.  Float32 CUDA problems the fused kernels
        # cover take the chunked kernel path (convergence checked at chunk
        # granularity); GP and elastic problems the multiscale device
        # routes; everything else the plain step with the reference
        # per-step semantics.
        # Silent GP runs with adaptive dt and active learning keep the
        # per-step host loop (the chunked AL advance carries a fixed dt).
        per_step_al = (self.has_gp_model and self.numerics["adaptive"]
                       and self._route_uses_al())
        if self.options["silent"] and not per_step_al:
            self._tic = datetime.now()
            if self.has_gp_model or self.topo.elastic:
                self._run_device_multiscale()
            elif self._fast_run_eligible():
                self._route = "run_compiled_fast"
                self.run_compiled_fast()
            else:
                self._route = "run_compiled"
                self.run_compiled()
            if not keep_open:
                self._post_run()
            return

        if self.has_gp_model or self.topo.elastic:
            self._route = "host_loop"
            self._run_host_loop(keep_open)
            return
        self._route = "run_chunked"
        self._run_chunked(keep_open)

    def _run_host_loop(self, keep_open=False):
        """The per-step host loop (non-silent GP or elastic runs, silent
        GP runs with adaptive dt and active learning): one :meth:`update`
        per step, a frame every ``write_freq`` steps unless silent."""
        silent = self.options["silent"]
        if not silent:
            print(61 * "-")
            print(f"{'Step':6s} {'Timestep':10s} {'Time':10s} "
                  f"{'CFL':10s} {'Residual':10s}")
            print(61 * "-")
            # GP problems refreshed their fields in _pre_run
            if not self.has_gp_model:
                self._refresh_det_fields()
            self.write(params=False)

        self._tic = datetime.now()
        while (not self.converged and self.step < self.max_it
               and not self._stop):
            self.update()
            if self.step % self.options["write_freq"] == 0 and not silent:
                self.write()
            handle_signals(self._receive_signal)

        if not keep_open:
            self._post_run()

    def _run_chunked(self, keep_open=False):
        """Non-silent run: on-device chunks of write_freq steps, one frame
        written after each."""
        print(61 * "-")
        print(f"{'Step':6s} {'Timestep':10s} {'Time':10s} "
              f"{'CFL':10s} {'Residual':10s}")
        print(61 * "-")
        self._refresh_det_fields()
        self.write()

        self._tic = datetime.now()
        chunk = self.options["write_freq"]
        while (not self.converged and self.step < self.max_it
               and not self._stop):
            n = min(chunk, self.max_it - self.step)
            self.run_steps(n)
            self._refresh_det_fields()
            self.write()
            handle_signals(self._receive_signal)

        if not keep_open:
            self._post_run()

    def _refresh_det_fields(self):
        """Recompute pressure/stress output fields (GP variances included)
        from the current q."""
        self.pressure.update(predictor=False, compute_var=True)
        self.wall_stress_xz.update(predictor=False, compute_var=True)
        self.wall_stress_yz.update(predictor=False, compute_var=True)
        self.bulk_stress.update()

    def _pre_run(self):
        for m in self._surrogates():
            m.init_database(self.grid["dim"])
        for m in self._surrogates():
            m.init()
        if not self.options["silent"]:
            for m in self._surrogates():
                m.write()

        self.step = 0
        self.simtime = 0.
        self.residual = 1.
        self._stop = False
        self.residual_buffer = deque([self.residual], 5)

        # GP-driven problems need pressure/stress fields before step 0
        if self.has_gp_model:
            self._refresh_det_fields()

        if self.numerics["adaptive"]:
            self.dt = self.numerics["CFL"] * self.dt_crit
        else:
            self.dt = self.numerics["dt"]

        self.tol = self.numerics["tol"]
        self.max_it = self.numerics["max_it"]

    def _receive_signal(self, signum, frame):
        if signum in get_termination_signals():
            self._stop = True

    def _post_run(self):
        walltime = datetime.now() - self._tic

        # final unwritten frame (chunked runs write after every chunk)
        if (getattr(self, "_last_written_step", None) != self.step
                and not self.options["silent"]):
            self.write()

        if not self.options["silent"]:
            self.file.close()
            if self.topo.elastic:
                self.topofile.close()

        speed = self.step / max(walltime.total_seconds(), 1e-12)

        echo(33 * "=")
        echo("Total walltime   : ", str(walltime).split(".")[0])
        echo(f"({speed:.2f} steps/s)")
        for model, tag in zip(self._surrogates(), ("zz", "xz", "yz")):
            if model.is_gp_model:
                echo(f" - GP train ({tag}) : ",
                     str(model.cumtime_train).split(".")[0])
                echo(f" - GP infer ({tag}) : ",
                     str(model.cumtime_infer).split(".")[0])
        echo(33 * "=")

        if not self.options["silent"]:
            history_to_csv(os.path.join(self.outdir, "history.csv"),
                           self.history)
            for model, tag in zip(self._surrogates(), ("zz", "xz", "yz")):
                if model.is_gp_model:
                    history_to_csv(os.path.join(self.outdir, f"gp_{tag}.csv"),
                                   model.history)
                    with open(os.path.join(self.outdir, f"gp_{tag}.txt"),
                              "w") as fh:
                        print(model.gp, file=fh)

    # ------------------------------------------------------------------
    # Single timestep
    # ------------------------------------------------------------------

    def _tensor(self, arr):
        return torch.as_tensor(arr, dtype=self.dtype, device=self.device)

    def _make_state(self):
        buf = list(self.residual_buffer)[::-1]
        return SimState(
            q=self._tensor(self.q),
            topo=self._tensor(self.topo.full),
            extra=self._tensor(self.fc.get_real_field("extra").p),
            dt=self._tensor(self.dt),
            step=torch.tensor(self.step, dtype=torch.int32,
                              device=self.device),
            simtime=self._tensor(self.simtime),
            ekin_old=self._tensor(self.kinetic_energy_old),
            residual=self._tensor(self.residual),
            residual_buffer=self._tensor(buf + [np.inf] * (5 - len(buf))),
            valid=torch.tensor(True, device=self.device),
        )

    def _sync_state(self, state):
        """Copy a state back into the host fields and scalars."""
        self.q[...] = state.q.cpu().numpy()
        self.step = int(state.step)
        self.simtime = float(state.simtime)
        self.dt = float(state.dt)
        self.residual = float(state.residual)
        self.kinetic_energy_old = float(state.ekin_old)
        self.residual_buffer = deque(
            [float(r) for r in state.residual_buffer.cpu().numpy()[::-1]
             if np.isfinite(r)], 5)

    def update(self):
        """One MacCormack timestep: the GP-driven step
        (:meth:`_update_gp`) with GP surrogates, else the deterministic
        step (plain torch step); an elastic problem then deforms from the
        pass-2 pressure (reference order)."""
        if self.has_gp_model:
            self._update_gp()
            return
        if self._det_step is None:
            self._det_step = make_det_step(self._solver_cfg)

        new_state, aux = self._det_step(self._make_state())
        self._sync_closure_fields(*aux)

        if bool(new_state.valid):
            self._sync_state(new_state)
            self.topo.update()
        else:
            # rollback: q reset to pre-step values by the solver
            self.q[...] = new_state.q.cpu().numpy()
            print("Invalid state (NaN or negative density) detected.", end=" ")
            self._refresh_det_fields()
            print("Writing previous step and aborting simulation.")
            self._stop = True

    def _sync_closure_fields(self, p, tau_bulk, s_lo, s_up):
        """Mirror the last-pass closure fields into the host registry."""
        self.fc.get_real_field("pressure").p[...] = p.cpu().numpy()
        self.fc.get_real_field("bulk_viscous_stress").p[...] = \
            tau_bulk.cpu().numpy()
        s_lo = s_lo.cpu().numpy()
        s_up = s_up.cpu().numpy()
        for field, oi in ((self.fc.get_real_field("wall_stress_xz"), 4),
                          (self.fc.get_real_field("wall_stress_yz"), 3)):
            f = field.p
            f[:3] = s_lo[:3] / 2.
            f[5] = s_lo[5] / 2.
            f[oi] = s_lo[oi]
            f[3 if oi == 4 else 4] = 0.
            f[6:9] = s_up[:3] / 2.
            f[11] = s_up[5] / 2.
            f[oi + 6] = s_up[oi]
            f[9 if oi == 4 else 10] = 0.

    # -- GP-driven step (the per-step host protocol) ---------------------

    def _gp_models(self):
        return [m for m in self._surrogates() if m.is_gp_model]

    def _gp_fused_eligible(self, one_step_before_output):
        """The whole GP step can run as one fused step when no model may
        retrain or acquire this step and no variance output is due."""
        if one_step_before_output:
            return False
        models = self._gp_models()
        if not models:
            return False
        for m in models:
            # predict() decrements _pause BEFORE its AL check, so AL can
            # trigger this step whenever _pause - 1 < 0, the initial
            # _pause == 0 included (hence <= 0, not < 0)
            if m.use_active_learning and m._pause <= 0:
                return False
            if m.last_fit_train_size < m.database.size:
                return False
            if m.params is None:
                return False
        return True

    def _gp_state(self):
        """The surrogates' conditioned caches (float64, on the inference
        device) in the ``core.gp_step`` layout, unpadded."""
        f64 = dict(dtype=torch.float64, device=self.device)
        state = {"Xscale": torch.as_tensor(self.database.X_scale, **f64)}
        for key, model in zip(("z", "x", "y"), self._surrogates()):
            if not model.is_gp_model:
                continue
            model._ensure_conditioned()
            state[f"params_{key}"] = model._params_dev
            state[f"Xfit_{key}"] = model._X_at_fit
            state[f"alpha_{key}"] = model.cond_gp[1]
            state[f"Yscale_{key}"] = torch.as_tensor(model.Yscale, **f64)
        return state

    def _update_gp_fused(self):
        """One fused GP-closed step (:func:`core.gp_step.make_gp_step`):
        the GP kernel on a covered float32 CUDA state (periodic edges K5,
        uniform D/N edges K6, each with its pass-2 pressure), else the
        plain GP step.  The surrogates' step and pause counters advance
        as one predictor pass would advance them."""
        models = self._surrogates()
        dims = tuple(tuple(m.active_dims) if m.is_gp_model else None
                     for m in models)
        use = tuple(m.is_gp_model for m in models)
        step_fn = make_gp_step(self._solver_cfg, dims,
                               self.database.num_features, use)
        q_new, p_last = step_fn(
            self._tensor(self.q), self._tensor(self.topo.full),
            self._tensor(self.fc.get_real_field("extra").p),
            self._tensor(self.dt), self.step, self._gp_state())

        q0 = self.q.copy()
        self.q[...] = q_new.cpu().numpy()
        self.fc.get_real_field("pressure").p[...] = p_last.cpu().numpy()
        self._fused_steps += 1

        for m in self._gp_models():
            m._step += 1
            m._pause = max(-1, m._pause - 1)

        if self.q_is_valid:
            self.topo.update()
            self._post_update()
        else:
            self._finalize(q0)

    def _update_gp(self):
        """One GP-driven step by the host protocol: per MacCormack pass
        the surrogates predict (the first pass as the predictor, which
        retrains and acquires as needed; variances on the step before an
        output), then the pass advances q; the temporal average follows,
        and an invalid state rolls back.  Steps in which no surrogate may
        retrain or acquire take :meth:`_update_gp_fused`."""
        one_step_before_output = \
            (self.step + 1) % self.options["write_freq"] == 0

        if self._gp_fused_eligible(one_step_before_output):
            self._update_gp_fused()
            return

        if self._pass_fn is None:
            self._pass_fn = make_pass_fn(self._solver_cfg)

        if self.numerics["MC_order"] == 0:
            switch = (self.step % 2 == 0) * 2 - 1
        else:
            switch = self.numerics["MC_order"]

        dt = self._tensor(self.dt)
        topo = self._tensor(self.topo.full)
        q0 = self.q.copy()

        for i, d in enumerate(mc_directions(switch)):
            for m in self._surrogates():
                m.update(predictor=i == 0,
                         compute_var=one_step_before_output)
            self.bulk_stress.update()

            q_new = self._pass_fn(
                self._tensor(self.q), topo,
                self._tensor(self.pressure.pressure),
                self._tensor(self.bulk_stress.stress),
                self._tensor(self.wall_stress_xz.lower
                             + self.wall_stress_yz.lower),
                self._tensor(self.wall_stress_xz.upper
                             + self.wall_stress_yz.upper),
                dt, d)
            self.q[...] = q_new.cpu().numpy()

        self.q[...] = (self.q + q0) / 2.

        if self.q_is_valid:
            self.topo.update()
            self._post_update()
        else:
            self._finalize(q0)

    def _post_update(self):
        """Bookkeeping after a valid GP step: ghosts, residual, step and
        time, adaptive dt from the new state."""
        self._communicate_ghost_buffers()

        self.residual = (abs(self.kinetic_energy - self.kinetic_energy_old)
                         / self.kinetic_energy_old / self.cfl)
        self.residual_buffer.append(self.residual)
        self.kinetic_energy_old = self.kinetic_energy

        self.step += 1
        self.simtime += self.dt

        if self.numerics["adaptive"]:
            self.dt = self.numerics["CFL"] * self.dt_crit

    def _finalize(self, q0):
        """Roll back to ``q0`` after an invalid GP step and stop."""
        if self.q_has_nan:
            print("NaN detected.", end=" ")
        elif self.q_has_negative_density:
            print("Negative density detected.", end=" ")

        self.q[...] = q0
        self._refresh_det_fields()

        print("Writing previous step and aborting simulation.")
        self._stop = True

    def _communicate_ghost_buffers(self):
        self.q[...] = apply_bcs(self._tensor(self.q),
                                self._solver_cfg).cpu().numpy()

    # ------------------------------------------------------------------
    # Whole-run paths
    # ------------------------------------------------------------------

    def run_steps(self, n):
        """Advance ``n`` deterministic steps on the device; return the
        trajectory (qs, times), stacked along a leading axis of length n.
        The Problem state is synced to the final step."""
        if self.has_gp_model:
            raise RuntimeError("run_steps requires a deterministic problem")
        if self.topo.elastic:
            raise RuntimeError("run_steps does not cover elastic problems "
                               "(the step freezes the topography; use "
                               "update()/run() or run_steps_ehl)")
        if self.step is None:
            self._pre_run()

        state, (qs, times) = make_trajectory(self._solver_cfg, n)(
            self._make_state())

        if not bool(state.valid):
            # the step rolled back to the last valid q and froze
            print("Invalid state (NaN or negative density) detected during "
                  "on-device stepping; stopping at the last valid state.")
            self._stop = True

        self._sync_state(state)
        return qs.cpu().numpy(), times.cpu().numpy()

    def run_steps_fast(self, n, dtype=None, compensated=True):
        """Advance ``n`` fixed-dt steps through the fused stencil loop.

        Float32 by default.  Falls back to :meth:`run_steps` for adaptive
        dt and for configurations the kernels do not cover, as the JAX
        package does.  Tracks no residuals; syncs q afterwards.
        ``compensated`` enables Kahan accumulation of the per-step
        increments, required for small fixed dt in float32 (see
        ops.stencil.make_pallas_loop).
        """
        if self.has_gp_model or self.topo.elastic:
            raise RuntimeError("run_steps_fast requires a deterministic, "
                               "non-elastic problem")
        if self.step is None:
            self._pre_run()
        if self.numerics["adaptive"] or not self._kernels_cover():
            self.run_steps(n)
            return

        loop = make_pallas_loop(self._solver_cfg, self.grid["Nx"],
                                self.grid["Ny"],
                                dtype=dtype or torch.float32,
                                compensated=compensated)
        q = loop(self._tensor(self.q), self.topo.full,
                 self.fc.get_real_field("extra").p, self.dt, n)
        self.q[...] = q.cpu().numpy()
        self.step += n
        self.simtime += n * self.dt

    def _kernels_cover(self):
        """Whether the fused kernels cover this configuration: uniform
        edges (periodic or D/N, shear thinning included) or mixed
        per-component edges."""
        cfg = self._solver_cfg
        return pallas_supported(cfg) or mixed_supported(
            cfg, self.grid["Ny"], self.grid["Nx"])

    def _fast_run_eligible(self):
        """The chunked kernel run applies to float32 problems on a CUDA
        device that the fused kernels cover."""
        return (self.dtype == torch.float32
                and self.device.type == "cuda"
                and self._kernels_cover())

    def run_compiled_fast(self, max_steps=None, chunk=1024,
                          compensated=True):
        """Whole convergence run through the fused stencil loop.

        Advances ``chunk`` steps per call of
        :func:`gapflow_torch.ops.stencil.make_pallas_loop` (compensated
        accumulation by default, required near steady state in f32), then
        checks validity and the kinetic-energy residual; with adaptive
        numerics, dt is refreshed from the CFL criterion between chunks
        (with a 0.9 safety factor since it stays frozen within a chunk).
        Convergence = 5 consecutive chunk-averaged residuals below tol.
        """
        if self.step is None:
            self._pre_run()
        max_steps = max_steps or self.max_it

        cfg = self._solver_cfg
        loop = make_pallas_loop(cfg, self.grid["Nx"], self.grid["Ny"],
                                dtype=self.dtype, compensated=compensated)

        def stats(q):
            ekin = torch.sum((q[1] ** 2 + q[2] ** 2) / q[0] / 2.)
            ok = torch.isfinite(q).all() & (q[0].min() > 0.)
            # the CFL criterion's v_max is sqrt(j^2/rho), not the physical
            # velocity sqrt(j^2/rho^2) (as in core.step.v_max)
            v_max = torch.sqrt(torch.max((q[1] ** 2 + q[2] ** 2) / q[0]))
            c_max = torch.max(eos_sound_velocity(q[0], cfg.prop))
            ekin, ok, v_max, c_max = torch.stack(
                [ekin, ok.to(q.dtype), v_max, c_max]).tolist()
            return ekin, bool(ok), v_max, c_max

        # moved to the device once; each chunk derives its statics there
        topo = self._tensor(self.topo.full)
        extra = self._tensor(self.fc.get_real_field("extra").p)
        q = self._tensor(self.q)
        q_prev = q
        ekin_old = self.kinetic_energy

        dmin = min(self.grid["dx"], self.grid["dy"])
        while self.step < max_steps and not self._stop:
            n = int(min(chunk, max_steps - self.step))
            q = loop(q, topo, extra, self.dt, n)
            ekin, ok, v_max, c_max = stats(q)

            if not ok:
                print("Invalid state (NaN or negative density) detected; "
                      "stopped at the last valid chunk.")
                q = q_prev
                self._stop = True
                break
            q_prev = q

            self.step += n
            self.simtime += n * self.dt
            # CFL from the CURRENT device state (self.cfl would read the
            # stale host q, frozen since the loop started)
            cfl_now = self.dt * (v_max + c_max) / dmin
            self.residual = (abs(ekin - ekin_old)
                             / max(ekin_old, 1e-300) / cfl_now / n)
            self.residual_buffer.append(self.residual)
            ekin_old = ekin
            self.kinetic_energy_old = ekin

            if self.numerics["adaptive"]:
                self.dt = float(0.9 * self.numerics["CFL"] * dmin
                                / (v_max + c_max))

            handle_signals(self._receive_signal)
            if self.converged and len(self.residual_buffer) == 5:
                break

        self.q[...] = q.cpu().numpy()
        self._refresh_det_fields()

    def run_compiled(self, max_steps=None):
        """Run the whole convergence loop on the device with the plain
        torch step (reference per-step semantics).  Output files get only
        the final frame."""
        if self.step is None:
            self._pre_run()

        runner = make_run_loop(self._solver_cfg, self.tol,
                               max_steps or self.max_it)
        state = runner(self._make_state())

        if not bool(state.valid):
            print("Invalid state (NaN or negative density) detected; "
                  "stopped at the last valid state.")
            self._stop = True

        self._sync_state(state)
        self._refresh_det_fields()
        return state

    # ------------------------------------------------------------------
    # GP-surrogate paths (silent, fixed dt, non-elastic)
    # ------------------------------------------------------------------

    def _surrogates(self):
        return (self.pressure, self.wall_stress_xz, self.wall_stress_yz)

    def _route_uses_al(self):
        """True when any surrogate runs active learning (the chunked-AL
        route)."""
        return any(s.use_al for s in _surrogate_specs(self).values())

    def _run_device_multiscale(self):
        """Silent GP or elastic convergence run in device chunks.

        Active learning on any surrogate takes :meth:`run_steps_gp_chunked`
        (host acquisition protocol between device advances), frozen
        surrogates :meth:`run_steps_gp_fast` (elastic composes),
        deterministic elastic problems :meth:`_run_steps_ehl_pass2`; the
        route is recorded in ``self._route``.  Residual convergence and
        the rollback on NaN or negative density are evaluated between
        chunks, as in :meth:`run_compiled_fast`.
        """
        if self.has_gp_model:
            self._route = ("gp_chunked" if self._route_uses_al()
                           else "gp_fast")
        else:
            self._route = "ehl_pass2"
        chunk = int(max(1, min(self.options["write_freq"], 512)))
        dmin = min(self.grid["dx"], self.grid["dy"])
        ekin_old = self.kinetic_energy
        q_prev = self.q.copy()

        while self.step < self.max_it and not self._stop:
            n = int(min(chunk, self.max_it - self.step))
            if self._route == "gp_chunked":
                self.run_steps_gp_chunked(n)
            elif self._route == "gp_fast":
                self.run_steps_gp_fast(n)
            else:
                self._run_steps_ehl_pass2(n)

            if not self.q_is_valid:
                print("Invalid state (NaN or negative density) detected; "
                      "stopped at the last valid chunk.")
                self.q[...] = q_prev
                self._refresh_det_fields()
                self._stop = True
                break
            q_prev = self.q.copy()

            ekin = self.kinetic_energy
            cfl = self.dt * (self.v_max + self.pressure.v_sound) / dmin
            self.residual = (abs(ekin - ekin_old)
                             / max(ekin_old, 1e-300) / cfl / n)
            self.residual_buffer.append(self.residual)
            ekin_old = ekin
            self.kinetic_energy_old = ekin

            handle_signals(self._receive_signal)
            if self.converged and len(self.residual_buffer) == 5:
                break

    def run_steps_gp_chunked(self, n, capacity=None, n_candidates=None):
        """Advance ``n`` fixed-dt GP-surrogate steps with host-protocol
        active learning and device stepping (:mod:`core.al_chunked`).

        Between acquisitions the fluid advances on the device (the GP
        kernels for a float32 CUDA state the kernels cover); each
        acquisition is a round trip in which the host runs the reference
        protocol: MD oracle through ``Database.add_data``
        (renormalization included) and scipy-BFGS retraining.  Frozen
        surrogates delegate to :meth:`run_steps_gp_fast`.  Returns the
        number of acquisitions.
        """
        if not self.has_gp_model:
            raise RuntimeError("run_steps_gp_chunked requires GP surrogates")
        if self.step is None:
            self._pre_run()
        if not self._route_uses_al():
            self.run_steps_gp_fast(n, capacity=capacity)
            return 0
        if self.numerics["adaptive"]:
            raise RuntimeError(
                "adaptive dt with active learning runs the per-step host "
                "protocol loop (plain run() routes it there); the chunked "
                "advance carries a fixed dt between acquisitions")
        return run_gp_al_chunked(self, n, capacity=capacity,
                                 n_candidates=n_candidates)

    def run_steps_gp_device(self, n, capacity=64, refit_steps=40):
        """The JAX package's experimental all-device AL loop
        (``core/al_loop.py``) is not ported (ROADMAP queue 1, item 8);
        :meth:`run_steps_gp_chunked` is the AL path."""
        raise NotImplementedError(
            "run_steps_gp_device is not ported to gapflow_torch (ROADMAP "
            "queue 1, item 8, deferred); use run_steps_gp_chunked")

    def run_steps_gp_fast(self, n, capacity=None, chunk=512,
                          deform_every=1):
        """Advance ``n`` GP-closed steps with frozen surrogates.

        The cached (hyperparameters, alpha) close every step and nothing
        retrains, as the reference's predict() with active learning off
        and an unchanged database.  A float32 CUDA state on periodic edges
        advances through :func:`ops.stencil_gp.gp_steps` in sweeps of a
        multiple of ``K_MULTI`` steps (at most ``chunk`` per call), the
        remainder through :func:`~ops.stencil_gp.gp_step`; D/N edges take
        the boundary GP kernel per step, other states the plain GP step.
        Syncs q and the constitutive fields afterwards.

        Elastic problems take the GP x elastic loop
        (:func:`core.ehl.make_gp_ehl_loop`, pass-2 protocol; the GP kernel
        with its pressure output where covered), ``deform_every`` FFT
        updates apart; adaptive dt carries dt through the loop
        (:func:`core.gp_step.make_gp_adaptive_loop` without elastic
        coupling).
        """
        if not self.has_gp_model:
            raise RuntimeError("run_steps_gp_fast requires GP surrogates")
        if self.step is None:
            self._pre_run()
        adaptive = bool(self.numerics["adaptive"])
        gp_state, dims3, use3, nf = self._frozen_gp_state(capacity)
        cfg = self._solver_cfg

        q = self._tensor(self.q)
        topo = self._tensor(self.topo.full)
        extra = self._tensor(self.fc.get_real_field("extra").p)

        if self.topo.elastic:
            ed = self.topo.ElasticDeformation
            loop = make_gp_ehl_loop(self, dims3, nf, use3,
                                    deform_every=(1 if adaptive
                                                  else deform_every),
                                    adaptive=adaptive)
            out = loop(q, ed.u_prev, topo, self.dt, self.step, n, gp_state)
            t_inc = None
            if adaptive:
                q, u, dt_new, t_inc = out
                self.dt = float(dt_new)
                t_inc = float(t_inc)
            else:
                q, u = out
            self._sync_deformation(u)
            self._sync_gp_fast_tail(q, n, simtime_inc=t_inc)
            return

        if adaptive:
            loop = make_gp_adaptive_loop(cfg, dims3, nf, use3, int(n))
            q, dt_new, t_inc = loop(q, topo, extra, self.dt, self.step,
                                    gp_state)
            self.dt = float(dt_new)
            self._sync_gp_fast_tail(q, n, simtime_inc=float(t_inc))
            return

        step_core = make_gp_step_core(cfg, dims3, nf, use3, need_p=False)
        dt = float(self.dt)

        if step_core.route(q) == "gp_step":
            ops = prep_gp_ops(gp_state, dims3, use3)
            st = interior_statics(topo, extra, q.dtype, q.device)
            q_int = q[:, 1:-1, 1:-1].contiguous()
            nk = n // K_MULTI * K_MULTI
            ck = chunk // K_MULTI * K_MULTI or K_MULTI
            done = 0
            while done < nk:
                c = min(ck, nk - done)
                q_int = gp_steps(q_int, st, dt, cfg, ops, c)
                done += c
            for _ in range(n - nk):
                q_int, _ = gp_step(q_int, st, dt, cfg, ops, need_p=False)
            q = with_ghosts(q_int, cfg)
        else:
            stepper = step_core.prepare(q, topo, extra, gp_state)
            s = stepper.inner(q)
            for i in range(n):
                s, _ = stepper.step(s, dt, self.step + i)
            q = stepper.full(s)

        self._sync_gp_fast_tail(q, n)

    def _frozen_gp_state(self, capacity=None):
        """Padded frozen-surrogate buffers (``core.gp_step`` layout) in the
        Problem's dtype on its device, plus the static dims.  Requires
        active learning off on every surrogate.  Returns ``(gp_state,
        dims3, use3, num_features)``."""
        specs = _surrogate_specs(self)
        if any(s.use_al for s in specs.values()):
            raise RuntimeError(
                "active learning is on; run_steps_gp_chunked runs the "
                "host acquisition protocol with device stepping")
        db = self.database
        gps, _ = init_gp_states(self, capacity or _next_capacity(db.size))
        models = dict(zip(("z", "x", "y"), self._surrogates()))
        gp_state = gp_state_of(
            gps, self._tensor(db.X_scale),
            {k: self._tensor(models[k].Yscale) for k in gps})
        dims3 = tuple(tuple(m.active_dims) if m.is_gp_model else None
                      for m in self._surrogates())
        use3 = tuple(m.is_gp_model for m in self._surrogates())
        return gp_state, dims3, use3, db.num_features

    def _sync_gp_fast_tail(self, q, n, simtime_inc=None):
        """Host sync after a frozen-GP run: write q back and refresh the
        constitutive fields through the host predict path (cached dense
        conditioning).  ``simtime_inc``: the run's simulated time
        (adaptive dt), else ``n * dt``."""
        self.q[...] = q.cpu().numpy()
        for m in self._surrogates():
            m.update(predictor=False, compute_var=False)
            m._step += n
        self.bulk_stress.update()
        self.step += n
        self.simtime += n * self.dt if simtime_inc is None else simtime_inc

    def _sync_deformation(self, u):
        """The relaxed deformation state ``u`` (unshifted, ghost-inclusive
        tensor) into the half-space's ``u_prev`` (in its dtype) and the
        topography: the deformation shifted by u[0, 0] for half/none
        periodicity, and the gap with fresh gradients (``h`` setter)."""
        ed = self.topo.ElasticDeformation
        ed.u_prev = u.to(ed.u_prev.dtype)
        u = u.cpu().numpy()
        shift = u[0, 0] if ed.periodicity in ("half", "none") else 0.
        self.topo.deformation = u - shift
        self.topo.h = self.topo.h_undeformed + (u - shift)

    # ------------------------------------------------------------------
    # Elastic (EHL) paths
    # ------------------------------------------------------------------

    def run_steps_ehl(self, n, deform_every=1, dtype=None):
        """Advance ``n`` fixed-dt steps of a deterministic elastic problem
        through :func:`core.ehl.make_ehl_loop` (end-of-step pressure).

        ``deform_every=1`` evaluates the elastic FFT every fluid step (the
        reference protocol); a larger ``deform_every`` chunks the updates
        with the compounded relaxation factor (same fixed point).  On a
        CUDA problem of a fully periodic configuration without thinning,
        the fluid step is the EHL kernel K8 (float32, the interior Kahan
        carry, which starts at zero on every call).  Adaptive numerics
        delegate to :meth:`_run_steps_ehl_pass2`.  Syncs q, the
        deformation state, the topography and the pressure field.
        """
        if not self.topo.elastic:
            raise RuntimeError("run_steps_ehl requires an elastic problem")
        if self.has_gp_model:
            raise RuntimeError("run_steps_ehl covers deterministic "
                               "constitutive models only")
        if self.step is None:
            self._pre_run()
        if self.numerics["adaptive"]:
            self._run_steps_ehl_pass2(n)
            return

        loop = make_ehl_loop(self, dtype=dtype, deform_every=deform_every)
        q, u = loop(self._tensor(self.q), self.topo.ElasticDeformation.u_prev,
                    self.dt, n)
        self.q[...] = q.cpu().numpy()
        self._sync_deformation(u)
        self.fc.get_real_field("pressure").p[...] = eos_pressure(
            self._tensor(self.q[0]), self._solver_cfg.prop).cpu().numpy()
        self.step += n
        self.simtime += n * self.dt

    def _run_steps_ehl_pass2(self, n, allow_pallas=True):
        """Advance a deterministic elastic problem ``n`` steps on the
        device with the host ``update()`` protocol: deformation from the
        pass-2 pressure, the first step on the host topography (analytic
        gradients until the first ``topo.update()``), dt refreshed every
        step for adaptive numerics.  Drives
        :func:`core.ehl.make_gp_ehl_loop` with every surrogate
        deterministic, so on a covered float32 CUDA state each step is the
        GP kernel K5 without surrogates (``allow_pallas=False``: the plain
        step).  :meth:`run` takes this route."""
        if not self.topo.elastic or self.has_gp_model:
            raise RuntimeError("_run_steps_ehl_pass2 covers deterministic "
                               "elastic problems")
        if self.step is None:
            self._pre_run()
        adaptive = bool(self.numerics["adaptive"])
        nf = 6 + self.fc.get_real_field("extra").p.shape[0]
        loop = make_gp_ehl_loop(self, (None, None, None), nf,
                                (False, False, False), adaptive=adaptive,
                                allow_pallas=allow_pallas)
        ed = self.topo.ElasticDeformation
        out = loop(self._tensor(self.q), ed.u_prev,
                   self._tensor(self.topo.full), self.dt, self.step, n,
                   {"Xscale": torch.ones(nf, dtype=self.dtype,
                                         device=self.device)})
        q, u = out[:2]
        self.q[...] = q.cpu().numpy()
        self._sync_deformation(u)
        self._refresh_det_fields()
        self.step += n
        if adaptive:
            self.simtime += float(out[3])
            self.dt = float(out[2])
        else:
            self.simtime += n * self.dt

    # ------------------------------------------------------------------
    # Sharded paths (spatial decomposition over a mesh of shards)
    # ------------------------------------------------------------------

    @staticmethod
    def _refuse_sharded(what, item):
        raise NotImplementedError(
            f"run_steps_sharded: {what} is not ported to gapflow_torch yet "
            f"(ROADMAP queue 1, item {item}); run it with gapflow_tpu or "
            f"without a mesh")

    def run_steps_sharded(self, n, mesh=None, use_pallas=None,
                          deform_every=1):
        """Advance ``n`` steps sharded over a 2D mesh of shards
        (:mod:`gapflow_torch.parallel`).

        The state is cut into blocks, one per shard, with a halo copied
        from the mesh neighbours before every pass.  The family routes as
        the JAX package's:

        - deterministic, adaptive dt: the sharded state step (global CFL
          over the shards' owned cells, uniform rollback);
        - deterministic, fixed dt: the shard sweep once per shard and
          ``parallel.pallas_halo.SHARD_K`` steps, after one exchange of a
          halo that deep (``use_pallas``; periodic edges with every flag
          zero, D/N edges with each shard's edge flags), or the plain
          sharded step;
        - elastic (fixed dt): the sharded fluid between deformation
          updates every ``deform_every`` steps (:mod:`.parallel.ehl`).

        ``mesh`` defaults to every visible CUDA device
        (:func:`parallel.grid_mesh`).  ``use_pallas=None`` takes the
        shard sweep where every shard is on a CUDA device, the dtype is
        float32 and the kernel covers the configuration
        (:func:`ops.stencil.shard_supported`);
        ``True`` takes it in any case (the plain twins on the CPU; a CUDA
        tensor the kernel does not take raises).  The interior grid must
        divide the mesh.  GP problems, and adaptive elastic ones, raise
        ``NotImplementedError`` naming their ROADMAP item.  Syncs q with
        its ghost ring, ``step`` and ``simtime`` (and dt, the residual and
        the deformation where the route changes them) back into the
        Problem; returns the interior q on the first shard's device.
        """
        from .ops.stencil import _fully_periodic, shard_supported
        from .parallel import grid_mesh
        from .parallel.halo import gather, shard_problem_arrays

        if self.has_gp_model:
            if self._route_uses_al():
                self._refuse_sharded("the sharded chunked active-learning "
                                     "advance", "11c")
            if self.topo.elastic:
                self._refuse_sharded("GP x elastic", "11b")
            self._refuse_sharded("the frozen-GP family", "11a")
        if self.topo.elastic and self.numerics["adaptive"]:
            # the JAX package runs it through the GP x elastic loop
            self._refuse_sharded("adaptive dt on an elastic problem", "11b")
        if self.step is None:
            self._pre_run()
        if mesh is None:
            mesh = grid_mesh()
        cfg = self._solver_cfg
        nx, ny = self.grid["Nx"], self.grid["Ny"]
        px, py = mesh.shape["x"], mesh.shape["y"]
        if nx % px or ny % py:
            raise RuntimeError("interior grid must divide the mesh shape")

        if self.topo.elastic:
            return self._run_steps_sharded_ehl(n, mesh, use_pallas,
                                               deform_every)

        if self.numerics["adaptive"]:
            from .parallel import (make_sharded_state_trajectory,
                                   shard_problem_state)
            out = make_sharded_state_trajectory(cfg, mesh, n)(
                shard_problem_state(self, mesh))
            q = gather(out.q)
            self.q[:, 1:-1, 1:-1] = q.cpu().numpy()
            self._communicate_ghost_buffers()
            self.step = int(out.step)
            self.simtime = float(out.simtime)
            self.dt = float(out.dt)
            self.residual = float(out.residual)
            self.kinetic_energy_old = float(out.ekin_old)
            return q

        if use_pallas is None:
            use_pallas = (all(d.type == "cuda" for d in mesh.devices)
                          and self.dtype == torch.float32
                          and shard_supported(cfg))

        if use_pallas:
            # the kernel route takes its statics from the deeper blocks
            # below: only the state is cut here
            from .parallel.halo import shard, split_blocks
            q = shard(np.asarray(self.q)[:, 1:-1, 1:-1], mesh, self.dtype)
            from .parallel.pallas_halo import (
                make_sharded_bc_pallas_loop, make_sharded_pallas_loop,
                pad_blocks2, pad_blocks2_bc, statics_depth)
            extra_f = self.fc.get_real_field("extra").p
            d = statics_depth()
            if _fully_periodic(cfg):
                loop = make_sharded_pallas_loop(cfg, mesh, nx, ny,
                                                self.dtype)
                t2 = pad_blocks2(self.topo.full, px, py, d)
                e2 = pad_blocks2(extra_f, px, py, d)
            else:
                per_x = all(cfg.bc_edge(0)["P"])
                per_y = all(cfg.bc_edge(2)["P"])
                loop = make_sharded_bc_pallas_loop(cfg, mesh, nx, ny,
                                                   self.dtype)
                t2 = pad_blocks2_bc(self.topo.full, px, py, per_x, per_y, d)
                e2 = pad_blocks2_bc(extra_f, px, py, per_x, per_y, d)
            q = loop(q, split_blocks(t2, mesh, self.dtype),
                     split_blocks(e2, mesh, self.dtype), self.dt, n)
        else:
            from .parallel import make_sharded_trajectory
            q, topo, extra = shard_problem_arrays(self, mesh)
            q = make_sharded_trajectory(cfg, mesh, n)(q, topo, extra,
                                                      self.dt)

        q = gather(q)
        self.q[:, 1:-1, 1:-1] = q.cpu().numpy()
        self._communicate_ghost_buffers()
        self.step += n
        self.simtime += n * self.dt
        return q

    def _run_steps_sharded_ehl(self, n, mesh, use_pallas, deform_every):
        """The deterministic elastic family of :meth:`run_steps_sharded`:
        the sharded fluid and the deformation every ``deform_every`` steps
        on the first shard's device (:func:`parallel.ehl.make_sharded_ehl_loop`)."""
        from .parallel.ehl import make_sharded_ehl_loop
        from .parallel.halo import gather, shard

        loop = make_sharded_ehl_loop(self, mesh, deform_every=deform_every,
                                     use_pallas=use_pallas)
        q = shard(np.asarray(self.q)[:, 1:-1, 1:-1], mesh, self.dtype)
        q, u = loop(q, self.topo.ElasticDeformation.u_prev, self.dt, n)
        self._sync_deformation(u)
        q = gather(q)
        self.q[:, 1:-1, 1:-1] = q.cpu().numpy()
        self._communicate_ghost_buffers()
        self.fc.get_real_field("pressure").p[...] = eos_pressure(
            self._tensor(self.q[0]), self._solver_cfg.prop).cpu().numpy()
        self.step += n
        self.simtime += n * self.dt
        return q

    # ------------------------------------------------------------------
    # I/O
    # ------------------------------------------------------------------

    def write(self, scalars=True, fields=True, params=True):
        if scalars:
            print(f"{self.step:<6d} {self.dt:.4e} {self.simtime:.4e} "
                  f"{self.cfl:.4e} {self.residual:.4e}")
            self.history["step"].append(self.step)
            self.history["time"].append(self.simtime)
            self.history["ekin"].append(self.kinetic_energy)
            self.history["residual"].append(self.residual)
            self.history["vsound"].append(float(self.pressure.v_sound))

        if fields:
            self.file.append_frame().write()
            self._last_written_step = self.step

        if params:
            for m in self._surrogates():
                m.write()

        if self.topo.elastic:
            self.topofile.append_frame().write()

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------

    def _select_gp_config(self, gp):
        """(xz, yz, pressure) sections of a sanitized ``gp:`` section, None
        where that stress is analytic: a 1D problem has no yz surrogate
        (its jy and y-slopes vanish)."""
        gp = gp or {}
        shear = gp.get("shear") if gp.get("shear_gp") else None
        press = gp.get("press") if gp.get("press_gp") else None
        return shear, None if self.grid["dim"] == 1 else shear, press

    def _initialize(self, rho0, U, V):
        self.__field.p[0] = rho0
        self.__field.p[1] = rho0 * U / 2.
        self.__field.p[2] = rho0 * V / 2.
        self.kinetic_energy_old = self.kinetic_energy
