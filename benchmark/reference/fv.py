"""Plain reference of the gap-averaged MacCormack solver (plain torch).

The independent yardstick that decides ``correct``: the gap and its
slopes, the initial state, the CFL time step and the MacCormack steps of
the deterministic model, written from the equations of Holey et al.,
Tribology Letters 70 (2022), with the analytic closures at no slip and no
bulk viscosity.  It imports nothing of the measured program (and neither
JAX nor the JAX package); it runs in any float type on any device, so the
same code is the float64 reference and, in bfloat16, the control.

Arrays are ghost-inclusive, ``(3, nx + 2, ny + 2)`` for the state
``(rho, jx, jy)``, one ghost cell per side.  A step is two one-sided
passes (backward differences, then forward ones), each followed by the
ghost fill, and the average of the second pass with the step's start.
"""

import math

import numpy as np
import torch

# Modified Benedict-Webb-Rubin constants of the Lennard-Jones fluid,
# Johnson, Zollweg & Gubbins, Mol. Phys. 78 (1993) 591, table 10.
BWR_X = (
    0.8623085097507421, 2.976218765822098, -8.402230115796038,
    0.1054136629203555, -0.8564583828174598, 1.582759470107601,
    0.7639421948305453, 1.753173414312048, 2.798291772190376e+03,
    -4.8394220260857657e-02, 0.9963265197721935, -3.698000291272493e+01,
    2.084012299434647e+01, 8.305402124717285e+01, -9.574799715203068e+02,
    -1.477746229234994e+02, 6.398607852471505e+01, 1.603993673294834e+01,
    6.805916615864377e+01, -2.791293578795945e+03, -6.245128304568454,
    -8.116836104958410e+03, 1.488735559561229e+01, -1.059346754655084e+04,
    -1.131607632802822e+02, -8.867771540418822e+03, -3.986982844450543e+01,
    -4.689270299917261e+03, 2.593535277438717e+02, -2.694523589434903e+03,
    -7.218487631550215e+02, 1.721802063863269e+02,
)


# ---------------------------------------------------------------------------
# Gap
# ---------------------------------------------------------------------------

def midpoints(n, length):
    """Cell centres with one ghost cell per side."""
    return (np.arange(-1, n + 1) + 0.5) * (length / n)


def asperity_minima(geo):
    """The ``num**2`` asperity minima drawn from ``geo['seed']``: normal,
    centred between hmin and hmax with 99 % of the mass between them."""
    h0, h1, num = geo["hmin"], geo["hmax"], geo["num"]
    if num == 1:
        return np.array([h0])
    std = (h1 - h0) / 2. / 2.57
    return np.random.default_rng(geo["seed"]).normal(
        loc=h0 + (h1 - h0) / 2., scale=std, size=num ** 2)


def gap(geo, nx, ny, lx, ly):
    """``(h, dh/dx, dh/dy)``, each ``(nx + 2, ny + 2)`` float64."""
    x, y = midpoints(nx, lx), midpoints(ny, ly)
    if geo["type"] == "journal":
        k = 2. * math.pi / lx
        shift = geo["CR"] / k
        amp = geo["eps"] * shift
        h = np.broadcast_to((shift + amp * np.cos(k * x))[:, None],
                            (nx + 2, ny + 2)).copy()
        hx = np.broadcast_to((-amp * k * np.sin(k * x))[:, None],
                             (nx + 2, ny + 2)).copy()
        return h, hx, np.zeros_like(h)
    if geo["type"] != "asperity":
        raise NotImplementedError(f"gap of type {geo['type']!r}")
    # num x num cosine dimples in a flat top wall at hmax; cells outside
    # the domain (the ghosts) belong to none
    h1, num = geo["hmax"], geo["num"]
    wx, wy = lx / num, ly / num
    bx, by = math.pi / wx, math.pi / wy
    h = np.full((nx + 2, ny + 2), h1)
    hx = np.zeros_like(h)
    hy = np.zeros_like(h)
    ix = np.floor(x / wx).astype(int)
    iy = np.floor(y / wy).astype(int)
    for n, hmin in enumerate(asperity_minima(geo)):
        i, j = divmod(n, num)
        mx, my = ix == i, iy == j
        if not (mx.any() and my.any()):
            continue
        cx, cy = x[mx].mean(), y[my].mean()
        cos_x, sin_x = np.cos(bx * (x[mx] - cx)), np.sin(bx * (x[mx] - cx))
        cos_y, sin_y = np.cos(by * (y[my] - cy)), np.sin(by * (y[my] - cy))
        depth = h1 - hmin
        block = np.ix_(mx, my)
        h[block] -= depth * np.outer(cos_x, cos_y)
        hx[block] += bx * depth * np.outer(sin_x, cos_y)
        hy[block] += by * depth * np.outer(cos_x, sin_y)
    return h, hx, hy


# ---------------------------------------------------------------------------
# Equation of state
# ---------------------------------------------------------------------------

def _bwr_coefficients(T):
    x = BWR_X
    poly = (T,
            x[0] * T + x[1] * T ** 0.5 + x[2] + x[3] / T + x[4] / T ** 2,
            x[5] * T + x[6] + x[7] / T + x[8] / T ** 2,
            x[9] * T + x[10] + x[11] / T,
            x[12],
            x[13] / T + x[14] / T ** 2,
            x[15] / T,
            x[16] / T + x[17] / T ** 2,
            x[18] / T ** 2)
    expo = (x[19] / T ** 2 + x[20] / T ** 3,
            x[21] / T ** 2 + x[22] / T ** 4,
            x[23] / T ** 2 + x[24] / T ** 3,
            x[25] / T ** 2 + x[26] / T ** 4,
            x[27] / T ** 2 + x[28] / T ** 3,
            x[29] / T ** 2 + x[30] / T ** 3 + x[31] / T ** 4)
    return poly, expo


def pressure(rho, prop):
    """p(rho) of the configuration's equation of state."""
    if prop["EOS"] == "DH":
        # Dowson-Higginson, density clamped below the pole at C2 rho0
        rho0, c2 = prop["rho0"], prop["C2"]
        r = rho.clamp(max=0.99 * c2 * rho0) / rho0
        return prop["P0"] + prop["C1"] * (r - 1.) / (c2 - r)
    if prop["EOS"] == "BWR":
        poly, expo = _bwr_coefficients(prop["T"])
        rho2 = rho * rho
        p = torch.zeros_like(rho)
        for c in reversed(poly):
            p = (p + c) * rho
        e = torch.zeros_like(rho)
        for c in reversed(expo):
            e = e * rho2 + c
        return p + e * rho2 * rho * torch.exp(-prop["gamma"] * rho2)
    raise NotImplementedError(f"EOS {prop['EOS']!r}")


def sound_speed(rho, prop):
    """c = sqrt(dp/drho)."""
    if prop["EOS"] == "DH":
        rho0, c2 = prop["rho0"], prop["C2"]
        return torch.sqrt(prop["C1"] * rho0 * (c2 - 1.)
                          / (rho * rho * (c2 * rho0 / rho - 1.) ** 2))
    if prop["EOS"] == "BWR":
        poly, expo = _bwr_coefficients(prop["T"])
        g = prop["gamma"]
        rho2 = rho * rho
        dp = torch.zeros_like(rho)
        for k in reversed(range(len(poly))):
            dp = dp * rho + (k + 1) * poly[k]
        s = torch.zeros_like(rho)
        ds = torch.zeros_like(rho)
        for k in reversed(range(len(expo))):
            s = s * rho2 + expo[k]
            ds = ds * rho2 + (2 * k + 3) * expo[k]
        return torch.sqrt(dp + torch.exp(-g * rho2)
                          * (ds * rho2 - 2. * g * rho2 * rho2 * s))
    raise NotImplementedError(f"EOS {prop['EOS']!r}")


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

class Solver:
    """The deterministic model of one configuration on one grid.

    ``cfg``: the configuration's sections (``grid`` with the edge specs,
    ``geometry``, ``properties``, ``numerics``); ``nx``, ``ny``: the
    grid; ``dtype``, ``device``: where and in what it computes."""

    def __init__(self, cfg, nx, ny, dtype=torch.float64, device="cpu"):
        grid, geo, prop = cfg["grid"], cfg["geometry"], cfg["properties"]
        for key in ("piezo", "thinning", "elastic"):
            if prop.get(key):
                raise NotImplementedError(f"properties: {key}")
        if prop.get("bulk", 0.) != 0.:
            raise NotImplementedError("bulk viscosity")
        self.nx, self.ny = nx, ny
        self.lx, self.ly = grid["Lx"], grid["Ly"]
        self.dx, self.dy = self.lx / nx, self.ly / ny
        self.geo, self.prop = geo, prop
        self.numerics = cfg["numerics"]
        self.dtype, self.device = dtype, torch.device(device)
        self.edges = [self._edge(grid, e, o) for e, o in
                      (("xE", "xW"), ("xW", "xE"), ("yS", "yN"),
                       ("yN", "yS"))]
        self.h = None

    @staticmethod
    def _edge(grid, edge, opposite):
        """(kinds, value) of one edge: its P/D/N letter per component and
        its Dirichlet value, which GaPFlow reads from the opposite edge's
        key (``xE_D`` lands on the high-x edge)."""
        kinds = tuple(grid.get(edge, ["P", "P", "P"]))
        return kinds, grid.get(f"{opposite}_D", 0.)

    def tensor(self, a):
        if not torch.is_tensor(a):
            a = torch.as_tensor(np.asarray(a))
        return a.to(self.device, self.dtype)

    # -- set-up ---------------------------------------------------------
    def gap(self):
        """``(h, dh/dx, dh/dy)`` as float64 numpy arrays."""
        return gap(self.geo, self.nx, self.ny, self.lx, self.ly)

    def set_gap(self, topo=None):
        """Hold the gap on the device; ``topo`` defaults to :meth:`gap`."""
        h, hx, hy = self.gap() if topo is None else topo
        self.h, self.hx, self.hy = (self.tensor(a) for a in (h, hx, hy))
        self.r_h = 1. / self.h
        self.eta_r_h = self.prop["shear"] * self.r_h

    def initial_state(self, rho):
        """``(rho, rho0 U / 2, rho0 V / 2)`` from the density field."""
        rho0 = self.prop["rho0"]
        q = np.empty((3,) + rho.shape)
        q[0] = rho
        q[1] = rho0 * self.geo["U"] / 2.
        q[2] = rho0 * self.geo["V"] / 2.
        return q

    def dt(self, q, factor=1.):
        """``factor * CFL * min(dx, dy) / (v + c)``: ``v`` the largest
        ``sqrt((jx^2 + jy^2) / rho)``, ``c`` the largest sound speed,
        both over the ghost-inclusive state."""
        v = torch.sqrt(((q[1] * q[1] + q[2] * q[2]) / q[0]).max())
        c = sound_speed(q[0], self.prop).max()
        return float(factor * self.numerics["CFL"] * min(self.dx, self.dy)
                     / (v + c))

    # -- the step -------------------------------------------------------
    def fill_ghosts(self, q):
        """The four ghost edges in place, x-low, x-high, y-low, y-high:
        periodic, Dirichlet (2 value - adjacent) or Neumann (adjacent)."""
        for i, (kinds, val) in enumerate(self.edges):
            qa = q if i < 2 else q.transpose(1, 2)
            lo = i % 2 == 0
            dst, adj, wrap = (0, 1, -2) if lo else (-1, -2, 1)
            for c in range(3):
                if kinds[c] == "P":
                    qa[c, dst] = qa[c, wrap]
                elif kinds[c] == "D":
                    qa[c, dst] = 2. * val - qa[c, adj]
                else:
                    qa[c, dst] = qa[c, adj]
        return q

    def rhs(self, q, d):
        """``flux_x / dx + flux_y / dy - source`` of one pass; ``d`` = +1
        takes backward differences, -1 forward ones."""
        rho, jx, jy = q[0], q[1], q[2]
        hx, hy, r_h = self.hx, self.hy, self.r_h
        U, V = self.geo["U"], self.geo["V"]
        p = pressure(rho, self.prop)
        # Newtonian wall and gap-averaged stresses at no slip, no bulk
        # viscosity: a = eta / (h rho) factors all of them
        a = self.eta_r_h / rho
        Ur, Vr = U * rho, V * rho
        A, B = hx * jx, hy * jy
        CD = hx * jy + hy * jx
        Uhx, Vhy = Ur * hx, Vr * hy
        t_xx = (4. / 3.) * a * (A - 0.5 * B)
        t_yy = (4. / 3.) * a * (B - 0.5 * A)
        t_xy = a * CD
        top_xx = -8. * a * (Uhx / 3. - Vhy / 6. - A + 0.5 * B)
        top_yy = 8. * a * (Uhx / 6. - Vhy / 3. - 0.5 * A + B)
        top_xy = -2. * a * (Ur * hy + Vr * hx - 3. * CD)
        # top minus bottom wall shear: 2a (U rho - 3 jx) + 2a (2 U rho - 3 jx)
        dxz = 6. * a * (Ur - 2. * jx)
        dyz = 6. * a * (Vr - 2. * jy)
        sxy = t_xy - top_xy
        fx = torch.stack((jx, p + t_xx, t_xy))
        fy = torch.stack((jy, t_xy, p + t_yy))
        src = torch.stack((-(A + B),
                           (t_xx - top_xx) * hx + sxy * hy + dxz,
                           sxy * hx + (t_yy - top_yy) * hy + dyz)) * r_h
        # -d (F(i - d) - F(i)) along x over dx, along y over dy
        out = (fx - torch.roll(fx, d, dims=1)).mul_(d / self.dx)
        out.add_((fy - torch.roll(fy, d, dims=2)).mul_(d / self.dy))
        return out.sub_(src)

    def step(self, q, dt):
        """One MacCormack step of a ghost-inclusive state."""
        q1 = self.fill_ghosts(torch.add(q, self.rhs(q, 1), alpha=-dt))
        q2 = self.fill_ghosts(torch.add(q1, self.rhs(q1, -1), alpha=-dt))
        return self.fill_ghosts(q2.add_(q).mul_(0.5))

    def run(self, q, dt, n):
        """``n`` steps of fixed ``dt`` from ``q`` (any array; copied)."""
        q = self.fill_ghosts(self.tensor(q).clone())
        with torch.no_grad():
            for _ in range(n):
                q = self.step(q, dt)
        return q
