"""The inputs of a run, made from ``--seed``: the same seed gives the same
inputs, and every seed the same grid, protocol and amount of work.

Both sides get them: the program through its configuration and its
initial field, the reference through the same numbers.
"""

import math
import os

import numpy as np

from reference.fv import asperity_minima, midpoints


def density(cfg, traffic, seed):
    """The initial density on the ghost-inclusive grid, float64:
    ``rho0 (1 + delta)``, ``delta`` a sum of ``modes`` plane waves of
    integer wave numbers up to ``max_wavenumber`` on each axis (so it is
    periodic on the domain), random phases and weights summing to
    ``amplitude`` (the largest relative deviation)."""
    pert = traffic["perturbation"]
    rng = np.random.default_rng([seed, 1])
    nx, ny = traffic["Nx"], traffic["Ny"]
    lx, ly = cfg["grid"]["Lx"], cfg["grid"]["Ly"]
    x = midpoints(nx, lx)[:, None] / lx
    y = midpoints(ny, ly)[None, :] / ly
    m, kmax = pert["modes"], pert["max_wavenumber"]
    kx = rng.integers(0, kmax + 1, m)
    ky = rng.integers(1, kmax + 1, m)
    phase = rng.uniform(0., 2. * math.pi, m)
    w = rng.uniform(0.5, 1., m)
    w *= pert["amplitude"] / w.sum()
    delta = sum(w[i] * np.cos(2. * math.pi * (kx[i] * x + ky[i] * y)
                              + phase[i]) for i in range(m))
    return cfg["properties"]["rho0"] * (1. + delta)


def geometry_seed(cfg, seed):
    """The surface seed of a seeded geometry (``None`` for the others):
    the first of ``seed, seed + 1, ...`` whose asperity minima all lie
    between the configuration's hmin and hmax, so no seed makes a gap
    below the stated minimum gap."""
    geo = cfg["geometry"]
    if geo["type"] != "asperity" or geo.get("num", 1) == 1:
        return None
    for s in range(seed, seed + 1000):
        draw = asperity_minima(dict(geo, seed=s))
        if draw.min() >= geo["hmin"] and draw.max() <= geo["hmax"]:
            return s
    raise RuntimeError(f"no surface seed from {seed} keeps the gap between "
                       "hmin and hmax")


def database_seed(seed):
    """The seed of the initial training data's sampler (``db.init_seed``),
    drawn from ``--seed``."""
    rng = np.random.default_rng([seed % 2 ** 63, 3])
    return int(rng.integers(0, 2 ** 31))


def sections(cfg, traffic, seed, outdir):
    """The program's input sections for this run: the configuration with
    the traffic's grid and run protocol and the seed's surface; its
    surrogates (``gp``) as they are, and its training data (``db``) kept
    under ``outdir`` and sampled from the seed."""
    geo = dict(cfg["geometry"])
    gseed = geometry_seed(cfg, seed)
    if gseed is not None:
        geo["seed"] = gseed
    grid = dict(cfg["grid"], Nx=traffic["Nx"], Ny=traffic["Ny"])
    numerics = dict(cfg["numerics"], max_it=traffic["max_it"],
                    tol=traffic.get("tol", cfg["numerics"]["tol"]))
    options = {"output": outdir, "use_tstamp": False, "silent": True}
    out = {"options": options, "grid": grid, "geometry": geo,
           "numerics": numerics, "properties": dict(cfg["properties"])}
    if "gp" in cfg:
        out["gp"] = cfg["gp"]
    if "db" in cfg:
        out["db"] = dict(cfg["db"], dtool_path=os.path.join(outdir, "db"),
                         init_seed=database_seed(seed))
    return out
