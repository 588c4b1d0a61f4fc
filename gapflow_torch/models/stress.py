"""Constitutive model classes: pressure, wall stress and bulk stress.

Deterministic closures only (analytic EOS, Newtonian closures with
piezoviscous and shear-thinning corrections).  Each model owns its output
field(s) in the host :class:`~gapflow_torch.fields.FieldCollection`; it
evaluates on the Problem's device and dtype and copies the result back.

Field conventions (as in :mod:`gapflow_tpu.models.stress`): the xz and yz
wall-stress fields each store 12 Voigt components (6 bottom + 6 top); the
shared components (xx, yy, zz, xy) are stored *halved* so that summing the
two fields reconstructs the full wall stress used by the source term.
"""

import numpy as np
import torch

from .eos import eos_pressure, eos_sound_velocity
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


class WallStress(_FieldModel):
    """Wall shear stress model for the xz ('x') or yz ('y') plane."""

    def __init__(self, fc, prop, geo, device, dtype, direction="x"):
        self.__field = fc.real_field(f"wall_stress_{direction}z", (12,))
        super().__init__(fc, prop, geo, device, dtype)
        self.name = f"{direction}z"
        self._out_index = {"x": 4, "y": 3}[direction]

    def update(self):
        args = self._closure_args()
        s_bot = stress_bottom(*args).cpu().numpy()
        s_top = stress_top(*args).cpu().numpy()

        f = self.__field.p
        f[:3] = s_bot[:3] / 2.
        f[6:9] = s_top[:3] / 2.
        f[5] = s_bot[-1] / 2.
        f[11] = s_top[-1] / 2.
        f[self._out_index] = s_bot[self._out_index]
        f[self._out_index + 6] = s_top[self._out_index]


class BulkStress(_FieldModel):
    """Gap-averaged in-plane viscous stress."""

    name = "bulk"

    def __init__(self, fc, prop, geo, device, dtype):
        self.__field = fc.real_field("bulk_viscous_stress", (3,))
        super().__init__(fc, prop, geo, device, dtype)

    def update(self):
        self.__field.p[...] = stress_avg(*self._closure_args()).cpu().numpy()


class Pressure(_FieldModel):
    """Pressure model: the analytic EOS."""

    name = "zz"

    @property
    def v_sound(self):
        """Max isothermal sound speed of the current state."""
        return float(eos_sound_velocity(self._t(self.solution[0]),
                                        self.prop).max())

    def update(self):
        self._pressure.p[...] = eos_pressure(
            self._t(self.solution[0]), self.prop).cpu().numpy()
