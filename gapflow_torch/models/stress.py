"""Constitutive model classes: pressure, wall stress and bulk stress.

Each model owns its output field(s) in the host
:class:`~gapflow_torch.fields.FieldCollection`; it evaluates on the
Problem's device and dtype and copies the result back.  Pressure and wall
stress run in one of two modes: deterministic (analytic EOS, Newtonian
closures with piezoviscous and shear-thinning corrections) or GP
surrogate (:class:`~gapflow_torch.models.gp.GaussianProcessSurrogate`,
trained from the MD database; inference in float64 on the device).

Field conventions (as in :mod:`gapflow_tpu.models.stress`): the xz and yz
wall-stress fields each store 12 Voigt components (6 bottom + 6 top); the
shared components (xx, yy, zz, xy) are stored *halved* so that summing the
two fields reconstructs the full wall stress used by the source term.
"""

import numpy as np
import torch

from .eos import eos_pressure, eos_sound_velocity
from .gp import GaussianProcessSurrogate, kernel_fn
from .viscous import stress_bottom, stress_top, stress_avg
from .viscosity import piezoviscosity, shear_thinning_factor, shear_rate_avg


def _effective_viscosity(prop, geo, pressure, rho, height, dp_dx, dp_dy):
    """Shear viscosity with optional piezoviscous / shear-thinning factors."""
    if "piezo" in prop:
        arg = rho if prop["EOS"] == "Bayada" else pressure
        mu0 = piezoviscosity(arg, prop["shear"], prop["piezo"])
    else:
        mu0 = prop["shear"]

    if "thinning" in prop:
        rate = shear_rate_avg(dp_dx, dp_dy, height, geo["U"], geo["V"], mu0)
        return mu0 * shear_thinning_factor(rate, mu0, prop["thinning"])
    return mu0


class _FieldModel:
    """Shared plumbing: host field views and the device/dtype of evaluation."""

    def __init__(self, fc, prop, geo, device, dtype):
        self._solution = fc.get_real_field("solution")
        self._topo = fc.get_real_field("topography")
        self._extra = fc.get_real_field("extra")
        self._pressure = fc.get_real_field("pressure")
        self._x = fc.get_real_field("x")
        self._y = fc.get_real_field("y")
        self.prop = prop
        self.geo = geo
        self.device = device
        self.dtype = dtype

    def _t(self, arr):
        return torch.as_tensor(arr, dtype=self.dtype, device=self.device)

    @property
    def solution(self):
        return self._solution.p

    @property
    def height_and_slopes(self):
        return self._topo.p[:3]

    @property
    def extra(self):
        return self._extra.p

    @property
    def pressure(self):
        return self._pressure.p

    def _eta(self):
        thin = "thinning" in self.prop
        dp_dx = dp_dy = 0.
        if thin:
            dp_dx = self._t(np.gradient(self.pressure, self._x.p[:, 0], axis=0))
            dp_dy = self._t(np.gradient(self.pressure, self._y.p[0, :], axis=1))
        return _effective_viscosity(
            self.prop, self.geo, self._t(self.pressure),
            self._t(self.solution[0]), self._t(self._topo.p[0]),
            dp_dx, dp_dy)

    def _closure_args(self):
        return (self._t(self.solution), self._t(self.height_and_slopes),
                self.geo["U"], self.geo["V"], self._eta(), self.prop["bulk"],
                self._t(self.extra))


def _gp_settings(model, gp, dims):
    """Copy the surrogate settings of a sanitized ``gp:`` sub-section."""
    model.active_dims = list(dims)
    model.atol = gp["atol"]
    model.rtol = gp["rtol"]
    model.max_steps = gp["max_steps"]
    model.pause_steps = gp["pause_steps"]
    model.al_candidates = gp.get("al_candidates", 0)
    model.is_gp_model = True
    model.use_active_learning = gp["active_learning"]


class WallStress(_FieldModel, GaussianProcessSurrogate):
    """Wall shear stress model for the xz ('x') or yz ('y') plane."""

    def __init__(self, fc, prop, geo, device, dtype, direction="x",
                 data=None, gp=None):
        self.__field = fc.real_field(f"wall_stress_{direction}z", (12,))
        super().__init__(fc, prop, geo, device, dtype)
        self.name = f"{direction}z"
        self._out_index = {"x": 4, "y": 3}[direction]
        if gp is not None:
            _gp_settings(self, gp, {"x": gp.get("active_dims_x", [0, 1, 3]),
                                    "y": gp.get("active_dims_y", [0, 2, 3])
                                    }[direction])
            self.__field_variance = fc.real_field(
                f"wall_stress_{direction}z_var")
        else:
            self.is_gp_model = False
            self.use_active_learning = False
        self._gp_init(data)

    @property
    def variance(self):
        return self.__field_variance.p

    @property
    def lower(self):
        return self.__field.p[:6]

    @property
    def upper(self):
        return self.__field.p[6:]

    # -- GP data plumbing ---------------------------------------------------
    def _ycols(self, arr):
        n = self.last_fit_train_size
        i = self._out_index
        return np.stack([arr[:n, i + 1], arr[:n, i + 7]], axis=1)

    @property
    def _Ytrain(self):
        return self._ycols(self.database._Ytrain)

    @property
    def Yscale(self):
        i = self._out_index
        return float(np.max(self.database.Y_scale[[i + 1, i + 7]]))

    @property
    def Yerr(self):
        return float(np.mean(self._ycols(self.database._Ytrain_err)
                             / self.Yscale))

    def init(self):
        if self.is_gp_model:
            self._init_params()
            self._train()
            self._infer()

    def update(self, predictor=False, compute_var=False):
        args = self._closure_args()
        s_bot = stress_bottom(*args).cpu().numpy()
        s_top = stress_top(*args).cpu().numpy()

        f = self.__field.p
        f[:3] = s_bot[:3] / 2.
        f[6:9] = s_top[:3] / 2.
        f[5] = s_bot[-1] / 2.
        f[11] = s_top[-1] / 2.
        if self.is_gp_model:
            mean, var = self.predict(predictor=predictor,
                                     compute_var=compute_var)
            mean = mean.cpu().numpy()
            f[self._out_index] = mean[0]
            f[self._out_index + 6] = mean[1]
            if var is not None:
                self.__field_variance.p[...] = var.cpu().numpy()
        else:
            f[self._out_index] = s_bot[self._out_index]
            f[self._out_index + 6] = s_top[self._out_index]


class BulkStress(_FieldModel):
    """Gap-averaged in-plane viscous stress."""

    name = "bulk"

    def __init__(self, fc, prop, geo, device, dtype):
        self.__field = fc.real_field("bulk_viscous_stress", (3,))
        super().__init__(fc, prop, geo, device, dtype)

    @property
    def stress(self):
        return self.__field.p

    def update(self):
        self.__field.p[...] = stress_avg(*self._closure_args()).cpu().numpy()


class Pressure(_FieldModel, GaussianProcessSurrogate):
    """Pressure model: analytic EOS or GP surrogate of the MD pressure."""

    name = "zz"

    def __init__(self, fc, prop, geo, device, dtype, data=None, gp=None):
        super().__init__(fc, prop, geo, device, dtype)
        if gp is not None:
            _gp_settings(self, gp, gp.get("active_dims", [0, 3]))
            self.__field_variance = fc.real_field("pressure_var")
        else:
            self.is_gp_model = False
            self.use_active_learning = False
        self._gp_init(data)

    @property
    def variance(self):
        return self.__field_variance.p

    @property
    def v_sound(self):
        """Max sound speed: the analytic EOS's, or for a GP pressure
        sqrt(max d mean / d rho_norm * Yscale / Xscale[0]), the gradient of
        the conditioned GP mean by autograd (float64 on the device)."""
        if not self.is_gp_model:
            return float(eos_sound_velocity(self._t(self.solution[0]),
                                            self.prop).max())

        self._ensure_conditioned()
        _, alpha, _ = self.cond_gp
        with torch.enable_grad():
            X = self.Xtest.detach().requires_grad_(True)
            mean = kernel_fn(self._params_dev, self._X_at_fit, X).T @ alpha
            (dmean,) = torch.autograd.grad(mean.sum(), X)
        return float(torch.sqrt(dmean[:, 0].max() * float(self.Yscale)
                                / float(self.database.X_scale[0])))

    # -- GP data plumbing ---------------------------------------------------
    @property
    def _Ytrain(self):
        return self.database._Ytrain[:self.last_fit_train_size, 0]

    @property
    def Yscale(self):
        return float(self.database.Y_scale[0])

    @property
    def Yerr(self):
        return float(np.mean(
            self.database.Ytrain_err[:self.last_fit_train_size, 0]))

    def init(self):
        if self.is_gp_model:
            self._init_params()
            self._train()
            self._infer()

    def update(self, predictor=False, compute_var=False):
        if self.is_gp_model:
            mean, var = self.predict(predictor=predictor,
                                     compute_var=compute_var)
            self._pressure.p[...] = mean.cpu().numpy()
            if var is not None:
                self.__field_variance.p[...] = var.cpu().numpy()
        else:
            self._pressure.p[...] = eos_pressure(
                self._t(self.solution[0]), self.prop).cpu().numpy()
