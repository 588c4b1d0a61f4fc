"""Gap topography: midpoint grids, analytic height profiles, elastic coupling.

Counterpart of :mod:`gapflow_tpu.topography` (same geometry families,
ghost-cell midpoint grid, flip semantics and elastic update protocol,
reference GaPFlow/topography.py:38-324); the elastic half-space itself
lives in :mod:`gapflow_torch.elastic`.
"""

import numpy as np

from .elastic import ElasticDeformation
from .fields import wrap_field


def create_midpoint_grid(disc):
    """Cell-center coordinates including one ghost cell per side."""
    Lx, Ly = disc["Lx"], disc["Ly"]
    Nx, Ny = disc["Nx"], disc["Ny"]

    x = (np.arange(-1, Nx + 1) + 0.5) * (Lx / Nx)
    y = (np.arange(-1, Ny + 1) + 0.5) * (Ly / Ny)

    return np.meshgrid(x, y, indexing="ij")


def journal_bearing(xx, grid, geo):
    """Unrolled journal bearing: h = shift + amp cos(2 pi x / Lx)."""
    freq = 2. * np.pi / grid["Lx"]
    if "CR" in geo and "eps" in geo:
        shift = geo["CR"] / freq
        amp = geo["eps"] * shift
    else:
        amp = (geo["hmax"] - geo["hmin"]) / 2.
        shift = (geo["hmax"] + geo["hmin"]) / 2.

    h = shift + amp * np.cos(freq * xx)
    return h, -amp * freq * np.sin(freq * xx), np.zeros_like(h)


def inclined_slider(xx, grid, geo):
    """Linear wedge from hmax at x=0 to hmin at x=Lx."""
    slope = (geo["hmin"] - geo["hmax"]) / grid["Lx"]
    h = geo["hmax"] + slope * xx
    return h, np.full_like(h, slope), np.zeros_like(h)


def parabolic_slider(xx, grid, geo):
    """Parabolic profile with minimum hmin at the channel center."""
    Lx = grid["Lx"]
    prefac = 4. / Lx ** 2 * (geo["hmax"] - geo["hmin"])
    h = prefac * (xx - Lx / 2.) ** 2 + geo["hmin"]
    return h, 2. * prefac * (xx - Lx / 2.), np.zeros_like(h)


def cdc(xx, grid, geo):
    """Convergent-divergent channel with flat center section of half-width b."""
    Lx = grid["Lx"]
    h0, h1, b = geo["hmin"], geo["hmax"], geo["b"]
    slope = (h1 - h0) / (Lx / 2. - 2. * b)

    conv = (xx >= b) & (xx < Lx / 2. - b)
    center = (xx >= Lx / 2. - b) & (xx < Lx / 2. + b)
    div = (xx >= Lx / 2. + b) & (xx < Lx - b)

    h = np.full_like(xx, h1)
    h[conv] = h1 - slope * (xx[conv] - b)
    h[center] = h0
    h[div] = h0 + slope * (xx[div] - (Lx / 2. + b))

    dh_dx = np.zeros_like(h)
    dh_dx[conv] = -slope
    dh_dx[div] = slope

    return h, dh_dx, np.zeros_like(h)


def asperity(xx, yy, grid, geo):
    """2D field of cosine asperities, num x num, random depths for num > 1."""
    h0, h1, num = geo["hmin"], geo["hmax"], geo["num"]
    Lx, Ly = grid["Lx"], grid["Ly"]

    if num == 1:
        hmins = np.array([h0])
    else:
        # Gaussian with 99% mass between hmin and hmax; optional seed is
        # our extension (the reference draws unseeded) for reproducible
        # rough surfaces and checkpoint/resume
        std = (h1 - h0) / 2. / 2.57
        rng = (np.random.default_rng(geo["seed"])
               if geo.get("seed") is not None else np.random)
        hmins = rng.normal(loc=h0 + (h1 - h0) / 2., scale=std,
                           size=num ** 2)

    xid = (xx // (Lx / num)).astype(int)
    yid = (yy // (Ly / num)).astype(int)

    bx = np.pi / (Lx / num)
    by = np.pi / (Ly / num)

    h = np.full_like(xx, h1)
    dh_dx = np.zeros_like(h)
    dh_dy = np.zeros_like(h)

    idx = 0
    for i in range(num):
        for j in range(num):
            m = (xid == i) & (yid == j)
            if not m.any():
                idx += 1
                continue
            depth = h1 - hmins[idx]
            cx, cy = np.mean(xx[m]), np.mean(yy[m])
            h[m] -= depth * np.cos(bx * (xx[m] - cx)) * np.cos(by * (yy[m] - cy))
            dh_dx[m] += bx * depth * np.sin(bx * (xx[m] - cx)) * np.cos(by * (yy[m] - cy))
            dh_dy[m] += by * depth * np.cos(bx * (xx[m] - cx)) * np.sin(by * (yy[m] - cy))
            idx += 1

    return h, dh_dx, dh_dy


_PROFILES_1D = {
    "journal": journal_bearing,
    "inclined": inclined_slider,
    "parabolic": parabolic_slider,
    "cdc": cdc,
}


class Topography:
    """Container for the (possibly deforming) gap profile.

    Field layout: component 0 = h, 1 = dh/dx, 2 = dh/dy, 3 = elastic
    deformation (reference GaPFlow/problem.py:141).  An elastic
    configuration's half-space constants and relaxed deformation state
    live on ``device``, the state in ``dtype`` (:data:`gapflow_torch.DTYPE`
    unless given).
    """

    def __init__(self, fc, grid, geo, prop, device="cpu", dtype=None):
        xx, yy = create_midpoint_grid(grid)

        self.__field = wrap_field(fc.get_real_field("topography"))
        self._x = wrap_field(fc.get_real_field("x"))
        self._y = wrap_field(fc.get_real_field("y"))
        self._x.p[...] = xx
        self._y.p[...] = yy

        self.dx = grid["dx"]
        self.dy = grid["dy"]

        gtype = geo["type"]
        if gtype == "asperity":
            h, dh_dx, dh_dy = asperity(xx, yy, grid, geo)
        else:
            h, dh_dx, dh_dy = _PROFILES_1D[gtype](xx, grid, geo)

        ix, iy = 1, 2
        if geo["flip"]:
            if grid["Nx"] != grid["Ny"]:
                raise ValueError(
                    "flip=True requires a square grid (Nx == Ny): the "
                    "transposed profile must fit the same field shape "
                    "(the reference crashes with a broadcast error here)")
            h, dh_dx, dh_dy = h.T, dh_dx.T, dh_dy.T
            ix, iy = 2, 1

        if prop["elastic"]["enabled"]:
            self.elastic = True
            self.h_undeformed = h.copy()
            self.__pressure = wrap_field(fc.get_real_field("pressure"))
            self.ElasticDeformation = ElasticDeformation(
                E=prop["elastic"]["E"],
                v=prop["elastic"]["v"],
                alpha_underrelax=prop["elastic"]["alpha_underrelax"],
                grid=grid,
                n_images=prop["elastic"]["n_images"],
                fft_grid=prop["elastic"].get("fft_grid", "interior"),
                device=device,
                dtype=dtype,
            )
        else:
            self.elastic = False

        self.__field.p[0] = h
        self.__field.p[ix] = dh_dx
        self.__field.p[iy] = dh_dy
        self.__field.p[3] = 0.

    def update(self):
        """Recompute the elastic deformation from the current pressure
        field (under-relaxed; shifted by its [0, 0] value for half/none
        periodicity)."""
        if not self.elastic:
            return
        ed = self.ElasticDeformation
        if ed.periodicity in ("half", "none"):
            p = self.__pressure.p - self.__pressure.p[0, 0]
            deformation = ed.get_deformation_underrelax(p).cpu().numpy()
            deformation = deformation - deformation[0, 0]
        else:
            deformation = ed.get_deformation_underrelax(
                self.__pressure.p).cpu().numpy()
        self.deformation = deformation
        self.h = self.h_undeformed + deformation

    def update_gradients(self):
        """Second-order central-difference height gradients."""
        h = self.__field.p[0]
        self.__field.p[1] = np.gradient(h, axis=0) / self.dx
        self.__field.p[2] = np.gradient(h, axis=1) / self.dy

    @property
    def full(self):
        """(4, Nx+2, Ny+2): height, slopes and deformation."""
        return self.__field.p

    @property
    def h(self):
        return self.__field.p[0]

    @h.setter
    def h(self, value):
        self.__field.p[0] = value
        self.update_gradients()

    @property
    def deformation(self):
        return self.__field.p[3]

    @deformation.setter
    def deformation(self, value):
        self.__field.p[3] = value

    @property
    def dh_dx(self):
        return self.__field.p[1]

    @property
    def dh_dy(self):
        return self.__field.p[2]

    @property
    def x(self):
        return self._x.p

    @property
    def y(self):
        return self._y.p
