"""Elastic half-space deformation via FFT Green's functions, in torch.

Counterpart of :mod:`gapflow_tpu.elastic` (the reference's
ContactMechanics dependency, GaPFlow/topography.py:327-465):

- periodic:      u_hat(q) = 2 p_hat(q) / (E* |q|), q0-stiffness 0 (zero-mean)
- free:          real-space Love/Boussinesq kernel for uniform pressure on a
                 rectangular cell, zero-padded FFT convolution
- semi-periodic: free kernel summed over periodic images along one axis

Sign convention: positive pressure produces positive deformation (the gap
opens), as the reference composes h = h_undeformed + deformation.

The Green's functions and spectral weights are host numpy constants,
moved to the device once; the per-step work is ``torch.fft.rfft2``, an
elementwise product and ``irfft2``.  cuFFT takes any length, so the JAX
package's mixed-radix escape for grids with a large prime factor
(``ops/specfft.py``) has no counterpart here, and complex128 FFTs run on
the GPU too (the JAX package refuses float64 elastic runs on the TPU).
"""

import warnings
from copy import deepcopy

import numpy as np
import torch

from . import DTYPE


def _love_kernel(dx, dy, X, Y):
    """Surface displacement times E* at offsets (X, Y) due to unit uniform
    pressure on a (dx x dy) rectangle centred at the origin (Love 1929;
    Johnson, Contact Mechanics eq. 3.25); the caller divides by E*."""
    a, b = dx / 2., dy / 2.

    def F(xp, yp):
        # corner antiderivative of the 1/r Boussinesq kernel over a rectangle:
        # F(x, y) = x asinh(y/|x|) + y asinh(x/|y|), with F -> 0 on the axes
        mx = np.abs(xp) > 1e-300
        my = np.abs(yp) > 1e-300
        safe_x = np.where(mx, np.abs(xp), 1.)
        safe_y = np.where(my, np.abs(yp), 1.)
        return (np.where(mx, xp * np.arcsinh(yp / safe_x), 0.)
                + np.where(my, yp * np.arcsinh(xp / safe_y), 0.))

    G = (F(X + a, Y + b) - F(X + a, Y - b)
         - F(X - a, Y + b) + F(X - a, Y - b))
    return G / np.pi


class _Spectral:
    """Real spectral weights in the ``rfft2`` layout of ``shape``, on one
    device, cast to each field's dtype once and kept."""

    def __init__(self, weights, shape, device):
        self._w = torch.as_tensor(weights, device=device)
        self._by_dtype = {}
        self.shape = shape

    def apply(self, p):
        w = self._by_dtype.get(p.dtype)
        if w is None:
            w = self._by_dtype.setdefault(p.dtype, self._w.to(p.dtype))
        return torch.fft.irfft2(torch.fft.rfft2(p) * w, s=self.shape)


class PeriodicHalfSpace:
    """Fully periodic FFT elastic half-space (stiffness_q0 = 0)."""

    def __init__(self, nb_grid_pts, young, physical_sizes, device="cpu"):
        nx, ny = nb_grid_pts
        Lx, Ly = physical_sizes
        qx = 2. * np.pi * np.fft.fftfreq(nx, d=Lx / nx)
        qy = 2. * np.pi * np.fft.rfftfreq(ny, d=Ly / ny)
        q = np.sqrt(qx[:, None] ** 2 + qy[None, :] ** 2)
        with np.errstate(divide="ignore"):
            weights = 2. / (young * q)
        weights[0, 0] = 0.  # stiffness_q0 = 0: zero-mean response
        self.weights = weights
        self._shape = (nx, ny)
        self._spec = _Spectral(weights, self._shape, device)

    def deformation(self, p):
        """Displacement field for pressure field p (positive p opens the
        gap)."""
        return self._spec.apply(p)


class FreeHalfSpace:
    """Non-periodic elastic half-space: padded FFT convolution with the
    real-space Love kernel."""

    def __init__(self, nb_grid_pts, young, physical_sizes, n_images_x=0,
                 n_images_y=0, device="cpu"):
        nx, ny = nb_grid_pts
        Lx, Ly = physical_sizes
        dx, dy = Lx / nx, Ly / ny

        ix = np.fft.fftfreq(2 * nx, d=1. / (2 * nx))  # 0..nx-1, -nx..-1
        iy = np.fft.fftfreq(2 * ny, d=1. / (2 * ny))
        X = ix[:, None] * dx
        Y = iy[None, :] * dy

        G = _love_kernel(dx, dy, X, Y)
        # periodic images along requested axes (semi-periodic half-space)
        for k in range(1, n_images_x + 1):
            G = G + _love_kernel(dx, dy, X + k * Lx, Y) \
                  + _love_kernel(dx, dy, X - k * Lx, Y)
        for k in range(1, n_images_y + 1):
            G = G + _love_kernel(dx, dy, X, Y + k * Ly) \
                  + _love_kernel(dx, dy, X, Y - k * Ly)
        G = G / young

        # G is real and even under index negation on the padded torus, so
        # its spectrum is real: keep the rfft2 half of fft2(G).real
        self.Ghat = np.ascontiguousarray(np.fft.fft2(G).real[:, :ny + 1])
        self._shape = (nx, ny)
        self._padded = (2 * nx, 2 * ny)
        self._spec = _Spectral(self.Ghat, self._padded, device)

    def deformation(self, p):
        nx, ny = self._shape
        ppad = p.new_zeros(self._padded)
        ppad[:nx, :ny] = p
        return self._spec.apply(ppad)[:nx, :ny]


def _pad_axis(u, axis, mode):
    """One ghost cell on each side of ``axis``: periodic wrap or edge
    replication (``jnp.pad(..., mode)``)."""
    n = u.shape[axis]
    lo, hi = ((n - 1, 0) if mode == "wrap" else (0, n - 1))
    return torch.cat([u.narrow(axis, lo, 1), u, u.narrow(axis, hi, 1)],
                     dim=axis)


class ElasticDeformation:
    """Half-space selector + under-relaxed fixed-point deformation update.

    Chooses the periodic/semi-periodic/free kernel from the grid's BC
    periodicity, as reference GaPFlow/topography.py:327-441 does, including
    the semi-periodic 1D line-contact special case.

    ``fft_grid="interior"`` (default): the FFT runs on the Nx x Ny interior
    grid (cell size exactly dx); the ghost ring of the returned
    deformation is filled per axis, periodic wrap on periodic axes, edge
    replication otherwise.  ``fft_grid="ghost"`` (reference parity): the
    ghost-inclusive grid points with the interior physical sizes, the
    reference's own convention (GaPFlow/topography.py:357).  The two
    differ at O(1/N) (see :class:`gapflow_tpu.elastic.ElasticDeformation`).

    The half-space constants live on ``device``; ``u_prev``, the relaxed
    deformation state, is kept in ``dtype`` (:data:`gapflow_torch.DTYPE`
    unless given) there.
    """

    def __init__(self, E, v, alpha_underrelax, grid, n_images,
                 fft_grid="interior", device="cpu", dtype=None):
        self.area_per_cell = grid["dx"] * grid["dy"]
        self.fft_grid = fft_grid
        if fft_grid == "interior":
            nx, ny = grid["Nx"], grid["Ny"]
        else:
            nx, ny = grid["Nx"] + 2, grid["Ny"] + 2
        self.alpha_underrelax = alpha_underrelax
        self.device = torch.device(device)
        self.dtype = dtype or DTYPE
        self.u_prev = torch.zeros((grid["Nx"] + 2, grid["Ny"] + 2),
                                  dtype=self.dtype, device=self.device)

        perX = grid["bc_xE_P"][0]
        perY = grid["bc_yS_P"][0]
        young_effective = E / (1. - v ** 2)

        # semi-periodic 1D: treat as non-periodic line contact w/ unit length
        if (perX != perY) and ((perY and grid["Ny"] == 1) or
                               (perX and grid["Nx"] == 1)):
            warnings.warn(
                "Semi-periodic 1D problem: elastic deformation computed as a "
                "line contact with non-periodic BCs and unit transverse "
                "length.")
            grid = deepcopy(grid)
            if perY:
                grid["Ly"] = 1.0
            else:
                grid["Lx"] = 1.0
            n_images = 0
            perX = perY = False

        sizes = (grid["Lx"], grid["Ly"])
        if perX and perY:
            self.periodicity = "full"
            self._hs = PeriodicHalfSpace((nx, ny), young_effective, sizes,
                                         device=self.device)
        elif perX != perY:
            self.periodicity = "half"
            self._hs = FreeHalfSpace((nx, ny), young_effective, sizes,
                                     n_images_x=n_images if perX else 0,
                                     n_images_y=n_images if perY else 0,
                                     device=self.device)
        else:
            self.periodicity = "none"
            self._hs = FreeHalfSpace((nx, ny), young_effective, sizes,
                                     device=self.device)

        self._pad_modes = ("wrap" if perX else "edge",
                           "wrap" if perY else "edge")

    def deformation_full(self, p):
        """Deformation of a ghost-inclusive pressure tensor (same shape,
        dtype and device).

        ghost mode: the half-space acts on the full (Nx+2, Ny+2) array.
        interior mode: the half-space acts on the interior; the ghost ring
        of the result is wrap- (periodic axis) or edge- (else) filled.
        """
        if self.fft_grid != "interior":
            return self._hs.deformation(p)
        u = self._hs.deformation(p[1:-1, 1:-1])
        mx, my = self._pad_modes
        return _pad_axis(_pad_axis(u, 0, mx), 1, my)

    def get_deformation(self, p):
        """Elastic deformation for pressure p; positive p opens the gap.
        A numpy ``p`` is taken in ``dtype``, a tensor in its own."""
        if not torch.is_tensor(p):
            p = torch.as_tensor(np.asarray(p), dtype=self.dtype)
        return self.deformation_full(p.to(self.device))

    def get_deformation_underrelax(self, p):
        """Under-relaxed update u <- (1-alpha) u_prev + alpha u_new."""
        u_new = self.get_deformation(p)
        u_rel = (1. - self.alpha_underrelax) * self.u_prev \
            + self.alpha_underrelax * u_new
        self.u_prev = u_rel
        return u_rel

    def get_G_real(self):
        """Centred real-space Green's function (introspection helper)."""
        if isinstance(self._hs, FreeHalfSpace):
            G = np.fft.irfft2(self._hs.Ghat, s=self._hs._padded)
        else:
            G = np.fft.irfft2(self._hs.weights, s=self._hs._shape)
        return np.fft.fftshift(G)

    def get_G_real_slices(self):
        G = self.get_G_real()
        return G[:, G.shape[1] // 2], G[G.shape[0] // 2, :]
