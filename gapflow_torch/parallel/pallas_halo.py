"""Sharded stepping through the shard kernels (``ops.stencil.shard_sweep``).

Counterpart of :mod:`gapflow_tpu.parallel.pallas_halo`.  The loops are
temporally blocked: once per ``k`` steps each shard's block is extended
by a ``2k``-deep halo (:func:`halo.halo_blocks`: from the mesh
neighbours, or on a shard that holds a domain edge that is not periodic,
that edge's ghost values), and one shard sweep per shard advances it
``k`` steps in one launch with that shard's edge flags: the sweep
refills the ghost ring of the domain edges it holds after every pass and
average, as the serial boundary kernels do, and evolves every other halo
cell exactly as the neighbour evolves its interior.  A run of ``n``
steps is ``n // k`` such sweeps and one of ``n mod k``.  Every cell's
arithmetic is the serial kernels' (K1 on periodic edges, K3 on D/N
edges), so the sharded loops equal the serial ones bit for bit.

The TPU package blocks only its periodic loop (K1 and its temporally
blocked K2 on its wrap layout, 4 steps per 8-deep exchange) and steps
its D/N loop once per 2-deep exchange; here both loops take the sweep,
``k`` = :data:`SHARD_K` steps per exchange (the depth timed fastest per
step on the card, PERF.md).  :func:`ici_bytes_per_step` counts the halo
bytes of either.

Statics are computed once per run from the shards' own ``2k``-deep
blocks of the topography (:func:`pad_blocks2`, or :func:`pad_blocks2_bc`
on D/N edges, whose edge blocks carry the serial ghost topography;
:func:`statics_depth` gives the depth).
"""

import numpy as np
import torch

from ..models.closures_opt import precompute_statics
from ..ops import stencil
from .halo import _block_shape, _np_cat, _torch_cat, halo_blocks

#: Halo cells a side a step of the shard kernels consumes.
HALO = stencil.HALO_SHARD

#: Steps per halo exchange of the sharded loops (one shard sweep).
SHARD_K = 4


def statics_depth(k=None):
    """Halo depth of the statics blocks a sharded loop of ``k`` steps per
    exchange (default :data:`SHARD_K`) takes."""
    return HALO * (k or SHARD_K)


def _tile(wide, px, py, d, cat):
    """(C, Nx+2d, Ny+2d) -> the (C, px*(bx+2d), py*(by+2d)) block
    layout."""
    bx, by = (wide.shape[1] - 2 * d) // px, (wide.shape[2] - 2 * d) // py
    rows = [cat([wide[:, i * bx:i * bx + bx + 2 * d,
                      j * by:j * by + by + 2 * d]
                 for j in range(py)], 2) for i in range(px)]
    return cat(rows, 1)


def _wrap(a, axis, d, cat):
    """``a`` extended by ``d`` cells of its own periodic wrap each side
    along ``axis`` (the wrap repeats where ``d`` exceeds the extent)."""
    n = a.shape[axis]
    idx = [(i - d) % n for i in range(n + 2 * d)]
    if cat is _np_cat:
        return np.take(a, idx, axis=axis)
    return a.index_select(axis, torch.as_tensor(idx, device=a.device))


def _pad_blocks2_impl(g, px, py, cat, d):
    _block_shape(g.shape[1] - 2, g.shape[2] - 2, px, py)
    inter = g[:, 1:-1, 1:-1]
    return _tile(_wrap(_wrap(inter, 1, d, cat), 2, d, cat), px, py, d, cat)


def pad_blocks2(global_with_ghosts, px, py, depth=HALO):
    """Overlapping-block layout with ``depth``-cell halos for static
    fields.

    (C, Nx+2, Ny+2) ghost-inclusive serial field -> (C, px*(bx+2 depth),
    py*(by+2 depth)) whose (i, j) block is that shard's interior plus a
    ``depth``-cell halo (periodic wrap at the global edges); numpy, as the
    JAX package's (``depth`` 2)."""
    return _pad_blocks2_impl(np.asarray(global_with_ghosts), px, py,
                             _np_cat, depth)


def pad_blocks2_torch(global_with_ghosts, px, py, depth=HALO):
    """:func:`pad_blocks2` on a tensor, on its device (the EHL topography,
    rebuilt every deformation)."""
    return _pad_blocks2_impl(global_with_ghosts, px, py, _torch_cat, depth)


def pad_blocks2_bc(global_with_ghosts, px, py, per_x, per_y, depth=HALO):
    """:func:`pad_blocks2` for non-periodic axes: edge blocks carry the
    SERIAL ghost-ring values of the input (repeated to the halo's depth;
    only the innermost is consumed) instead of a periodic wrap."""
    g = np.asarray(global_with_ghosts)
    d = depth
    _block_shape(g.shape[1] - 2, g.shape[2] - 2, px, py)
    inter = g[:, 1:-1, 1:-1]
    if per_x:
        wide = _wrap(inter, 1, d, _np_cat)
    else:
        gE, gW = g[:, :1, 1:-1], g[:, -1:, 1:-1]
        wide = np.concatenate([gE.repeat(d, 1), inter, gW.repeat(d, 1)],
                              axis=1)
    if per_y:
        wide = _wrap(wide, 2, d, _np_cat)
    else:
        # ghost cols aligned with the interior rows; halo rows replicate
        gS = np.concatenate([g[:, :1, :1].repeat(d, 1), g[:, 1:-1, :1],
                             g[:, -1:, :1].repeat(d, 1)], axis=1)
        gN = np.concatenate([g[:, :1, -1:].repeat(d, 1), g[:, 1:-1, -1:],
                             g[:, -1:, -1:].repeat(d, 1)], axis=1)
        wide = np.concatenate([gS.repeat(d, 2), wide, gN.repeat(d, 2)],
                              axis=2)
    return _tile(wide, px, py, d, _np_cat)


def shard_flags(cfg, mesh, ix, iy):
    """K9's edge flags (xe, xw, yn, ys) of shard (ix, iy): it holds the
    x-low, x-high, y-high or y-low domain edge, and that axis is not
    periodic."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    per_x, per_y = all(cfg.bc_edge(0)["P"]), all(cfg.bc_edge(2)["P"])
    return (int(ix == 0 and not per_x), int(ix == px - 1 and not per_x),
            int(iy == py - 1 and not per_y), int(iy == 0 and not per_y))


def _make_loop(cfg, mesh, nx, ny, dtype, sweep_fn, k):
    px, py = mesh.shape["x"], mesh.shape["y"]
    bx, by = _block_shape(nx, ny, px, py)
    sweep_fn = sweep_fn or stencil.shard_sweep
    k = int(k or SHARD_K)
    stencil._check_k(k, stencil.K_MULTI)
    # a 2k-deep halo comes from the neighbours' interiors: thin blocks
    # take shallower sweeps (blocks under 2 x 2 cells are refused by the
    # exchange, as before)
    k = max(1, min(k, min(bx, by) // HALO))
    flags = [[shard_flags(cfg, mesh, i, j) for j in range(py)]
             for i in range(px)]

    def loop(q, topo2, extra2, dt, n_steps):
        q = [[b.to(dtype) for b in row] for row in q]
        # statics once per run: the blocks carry their own halos (at
        # least 2k deep), so the statics of the whole block are exact
        # with no exchange
        st = [[precompute_statics(t[:3].to(dtype), e.to(dtype)).contiguous()
               for t, e in zip(trow, erow)]
              for trow, erow in zip(topo2, extra2)]
        dt = float(dt)
        full, rem = divmod(int(n_steps), k)
        for depth in [k] * full + [rem] * (rem > 0):
            hb = halo_blocks(q, mesh, HALO * depth, cfg)
            q = [[sweep_fn(hb[i][j], st[i][j], dt, cfg, flags[i][j], depth)
                  for j in range(py)] for i in range(px)]
        return q

    loop.k = k
    return loop


def make_sharded_pallas_loop(cfg, mesh, nx, ny, dtype=torch.float32,
                             sweep_fn=None, k=None):
    """``loop(q, topo2, extra2, dt, n_steps) -> q`` over ``mesh`` on fully
    periodic edges: per ``k`` steps (default :data:`SHARD_K`) a ``2k``-deep
    exchange and one shard sweep per shard with every flag zero (K1's
    steps); the remainder ``n_steps mod k`` as one shallower sweep.  A
    block thinner than ``2k`` cells takes the deepest sweep its halo
    allows (``loop.k``).

    ``q``: the sharded interior (3, nx, ny); ``topo2``/``extra2``: the
    sharded :func:`pad_blocks2` layout at depth ``statics_depth(k)`` (or
    deeper).  ``sweep_fn`` replaces :func:`ops.stencil.shard_sweep` (its
    twin, to run the route on the twins in another dtype on the card).
    ``loop.k`` is the depth.
    """
    if not stencil._fully_periodic(cfg):
        raise ValueError("sharded kernel loop covers fully periodic "
                         "problems (others take make_sharded_bc_pallas_loop "
                         "or make_sharded_trajectory)")
    if not stencil.shard_supported(cfg):
        raise ValueError("sharded kernel loop does not cover shear thinning "
                         "or an alternating pass order")
    return _make_loop(cfg, mesh, nx, ny, dtype, sweep_fn, k)


def make_sharded_bc_pallas_loop(cfg, mesh, nx, ny, dtype=torch.float32,
                                sweep_fn=None, k=None):
    """``loop(q, topo2, extra2, dt, n_steps) -> q`` over ``mesh`` on
    per-edge-uniform D/N edges: per ``k`` steps a ``2k``-deep exchange
    whose halo on a domain-edge shard is the serial ghost value, then one
    shard sweep per shard with that shard's flags (:func:`shard_flags`),
    which refills the ghost ring after every pass and average; the
    remainder as one shallower sweep.  ``topo2``/``extra2`` come from
    :func:`pad_blocks2_bc` at depth ``statics_depth(k)``, so edge-shard
    statics carry the serial ghost topography.  Scope:
    :func:`ops.stencil.shard_supported`.  ``sweep_fn`` and ``k`` as for
    :func:`make_sharded_pallas_loop`."""
    if cfg.thinning is not None:
        raise ValueError("sharded bc loop does not cover shear thinning")
    if not stencil.shard_supported(cfg):
        raise ValueError("sharded bc loop covers per-edge-uniform "
                         "static-order configs")
    return _make_loop(cfg, mesh, nx, ny, dtype, sweep_fn, k)


def ici_bytes_per_step(nx, ny, px, py, mode="det", itemsize=4, k=None):
    """Bytes of the halo copies between shards, per shard and step.

    ``mode="det"``: the loops of this module, one ``2k``-deep exchange per
    ``k`` steps (``k`` default :data:`SHARD_K`).  ``mode="step"``: one
    2-deep exchange every step (the loop of the one-step K9, the JAX
    package's count for its D/N and GP loops).  ``mode="tpu_blocked"``:
    an 8-deep exchange per 4 steps, the JAX package's temporally blocked
    periodic loop.  The x halo moves ``depth`` rows of the block's
    columns each way, the y halo ``depth`` columns of the x-extended rows;
    a mesh axis of size 1 wraps onto its own shard and counts nothing.
    """
    bx, by = nx // px, ny // py

    def fluid(depth, every):
        x_bytes = 2 * 3 * depth * by * itemsize if px > 1 else 0
        y_bytes = 2 * 3 * (bx + 2 * depth) * depth * itemsize \
            if py > 1 else 0
        return (x_bytes + y_bytes) / every

    if mode == "det":
        k = int(k or SHARD_K)
        return fluid(HALO * k, k)
    if mode == "step":
        return fluid(HALO, 1)
    if mode == "tpu_blocked":
        return fluid(4 * HALO, stencil.K_MULTI)
    raise ValueError(mode)
