"""Sharded stepping through the shard kernel K9 (``ops.stencil.shard_step``).

Counterpart of :mod:`gapflow_tpu.parallel.pallas_halo`.  Every step each
shard's block is extended by a 2-deep halo (:func:`halo.halo_blocks`:
from the mesh neighbours, or on a shard that holds a domain edge that is
not periodic, that edge's ghost values), and one K9 launch per shard
advances it one step with that shard's edge flags: the kernel refills the
ghost ring of the domain edges it holds between the two passes, as the
serial boundary kernel does; every other ring cell it evolves exactly as
the neighbour evolves its interior (the 2-deep halo).  So every cell's
arithmetic is the serial kernels' (K1 on periodic edges, K3 on D/N
edges) and the sharded loops equal the serial ones bit for bit.

The TPU package runs the periodic scope through K1 and the temporally
blocked K2 on its wrap layout, 4 steps per 8-deep exchange; here the
periodic scope launches the same K9 with every flag zero after a 2-deep
exchange, once per step.  The blocked form is queued (ROADMAP queue 2);
:func:`ici_bytes_per_step` counts both.

Statics are computed once per run from the shards' own 2-deep blocks of
the topography (:func:`pad_blocks2`, or :func:`pad_blocks2_bc` on D/N
edges, whose edge blocks carry the serial ghost topography).
"""

import numpy as np
import torch

from ..models.closures_opt import precompute_statics
from ..ops import stencil
from .halo import _block_shape, _np_cat, _torch_cat, halo_blocks

#: Halo depth of the sharded loops: K9 consumes two cells per step.
HALO = 2


def _tile2(wide, px, py, cat):
    """(C, Nx+4, Ny+4) -> the (C, px*(bx+4), py*(by+4)) block layout."""
    bx, by = (wide.shape[1] - 4) // px, (wide.shape[2] - 4) // py
    rows = [cat([wide[:, i * bx:i * bx + bx + 4, j * by:j * by + by + 4]
                 for j in range(py)], 2) for i in range(px)]
    return cat(rows, 1)


def _pad_blocks2_impl(g, px, py, cat):
    _block_shape(g.shape[1] - 2, g.shape[2] - 2, px, py)
    inter = g[:, 1:-1, 1:-1]
    wide = cat([inter[:, -2:], inter, inter[:, :2]], 1)
    wide = cat([wide[:, :, -2:], wide, wide[:, :, :2]], 2)
    return _tile2(wide, px, py, cat)


def pad_blocks2(global_with_ghosts, px, py):
    """Overlapping-block layout with TWO-cell halos for static fields.

    (C, Nx+2, Ny+2) ghost-inclusive serial field -> (C, px*(bx+4),
    py*(by+4)) whose (i, j) block is that shard's interior plus a 2-cell
    halo (periodic wrap at the global edges); numpy, as the JAX
    package's."""
    return _pad_blocks2_impl(np.asarray(global_with_ghosts), px, py,
                             _np_cat)


def pad_blocks2_torch(global_with_ghosts, px, py):
    """:func:`pad_blocks2` on a tensor, on its device (the EHL topography,
    rebuilt every deformation)."""
    return _pad_blocks2_impl(global_with_ghosts, px, py, _torch_cat)


def pad_blocks2_bc(global_with_ghosts, px, py, per_x, per_y):
    """:func:`pad_blocks2` for non-periodic axes: edge blocks carry the
    SERIAL ghost-ring values of the input (duplicated to the 2-cell halo
    depth; the outer cell is junk depth, never consumed) instead of a
    periodic wrap."""
    g = np.asarray(global_with_ghosts)
    _block_shape(g.shape[1] - 2, g.shape[2] - 2, px, py)
    inter = g[:, 1:-1, 1:-1]
    if per_x:
        top2, bot2 = inter[:, -2:], inter[:, :2]
    else:
        gE, gW = g[:, :1, 1:-1], g[:, -1:, 1:-1]
        top2 = np.concatenate([gE, gE], axis=1)
        bot2 = np.concatenate([gW, gW], axis=1)
    wide = np.concatenate([top2, inter, bot2], axis=1)
    if per_y:
        l2, r2 = wide[:, :, -2:], wide[:, :, :2]
    else:
        # ghost cols aligned with the interior rows; halo rows replicate
        gS = np.concatenate([g[:, :1, :1].repeat(2, 1), g[:, 1:-1, :1],
                             g[:, -1:, :1].repeat(2, 1)], axis=1)
        gN = np.concatenate([g[:, :1, -1:].repeat(2, 1), g[:, 1:-1, -1:],
                             g[:, -1:, -1:].repeat(2, 1)], axis=1)
        l2 = np.concatenate([gS, gS], axis=2)
        r2 = np.concatenate([gN, gN], axis=2)
    wide = np.concatenate([l2, wide, r2], axis=2)
    return _tile2(wide, px, py, _np_cat)


def shard_flags(cfg, mesh, ix, iy):
    """K9's edge flags (xe, xw, yn, ys) of shard (ix, iy): it holds the
    x-low, x-high, y-high or y-low domain edge, and that axis is not
    periodic."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    per_x, per_y = all(cfg.bc_edge(0)["P"]), all(cfg.bc_edge(2)["P"])
    return (int(ix == 0 and not per_x), int(ix == px - 1 and not per_x),
            int(iy == py - 1 and not per_y), int(iy == 0 and not per_y))


def _make_loop(cfg, mesh, nx, ny, dtype, step_fn):
    px, py = mesh.shape["x"], mesh.shape["y"]
    _block_shape(nx, ny, px, py)
    step_fn = step_fn or stencil.shard_step
    flags = [[shard_flags(cfg, mesh, i, j) for j in range(py)]
             for i in range(px)]

    def loop(q, topo2, extra2, dt, n_steps):
        q = [[b.to(dtype) for b in row] for row in q]
        # statics once per run: the blocks carry their own 2-cell halos,
        # so the statics of the whole block are exact with no exchange
        st = [[precompute_statics(t[:3].to(dtype), e.to(dtype)).contiguous()
               for t, e in zip(trow, erow)]
              for trow, erow in zip(topo2, extra2)]
        dt = float(dt)
        for _ in range(n_steps):
            hb = halo_blocks(q, mesh, HALO, cfg)
            q = [[step_fn(hb[i][j], st[i][j], dt, cfg, flags[i][j])
                  for j in range(py)] for i in range(px)]
        return q

    return loop


def make_sharded_pallas_loop(cfg, mesh, nx, ny, dtype=torch.float32,
                             step_fn=None):
    """``loop(q, topo2, extra2, dt, n_steps) -> q`` over ``mesh`` on fully
    periodic edges: per step a 2-deep exchange and one K9 launch per shard
    with every flag zero (K1's step).

    ``q``: the sharded interior (3, nx, ny); ``topo2``/``extra2``: the
    sharded :func:`pad_blocks2` layout.  ``step_fn`` replaces
    :func:`ops.stencil.shard_step` (its twin, to run the route on the
    twins in another dtype on the card).
    """
    if not stencil._fully_periodic(cfg):
        raise ValueError("sharded kernel loop covers fully periodic "
                         "problems (others take make_sharded_bc_pallas_loop "
                         "or make_sharded_trajectory)")
    if not stencil.shard_supported(cfg):
        raise ValueError("sharded kernel loop does not cover shear thinning "
                         "or an alternating pass order")
    return _make_loop(cfg, mesh, nx, ny, dtype, step_fn)


def make_sharded_bc_pallas_loop(cfg, mesh, nx, ny, dtype=torch.float32,
                                step_fn=None):
    """``loop(q, topo2, extra2, dt, n_steps) -> q`` over ``mesh`` on
    per-edge-uniform D/N edges: per step a 2-deep exchange whose halo on a
    domain-edge shard is the serial ghost value, then one K9 launch per
    shard with that shard's flags (:func:`shard_flags`), which refills the
    ghost ring between the passes.  ``topo2``/``extra2`` come from
    :func:`pad_blocks2_bc`, so edge-shard statics carry the serial ghost
    topography.  Scope: :func:`ops.stencil.shard_supported`.
    ``step_fn`` as for :func:`make_sharded_pallas_loop`."""
    if cfg.thinning is not None:
        raise ValueError("sharded bc loop does not cover shear thinning")
    if not stencil.shard_supported(cfg):
        raise ValueError("sharded bc loop covers per-edge-uniform "
                         "static-order configs")
    return _make_loop(cfg, mesh, nx, ny, dtype, step_fn)


def ici_bytes_per_step(nx, ny, px, py, mode="det", itemsize=4):
    """Bytes of the halo copies between shards, per shard and step.

    ``mode="det"``: the loops of this module, one 2-deep exchange per
    step.  ``mode="blocked"``: an 8-deep exchange per 4 steps, the TPU
    package's temporally blocked periodic loop (not ported; ROADMAP queue
    2).  A mesh axis of size 1 wraps onto its own shard and counts
    nothing.
    """
    bx, by = nx // px, ny // py

    def fluid(depth, every):
        x_bytes = 2 * 3 * depth * by * itemsize if px > 1 else 0
        y_bytes = 2 * 3 * (bx + 2 * depth) * depth * itemsize \
            if py > 1 else 0
        return (x_bytes + y_bytes) / every

    if mode == "det":
        return fluid(HALO, 1)
    if mode == "blocked":
        return fluid(4 * HALO, stencil.K_MULTI)
    raise ValueError(mode)
