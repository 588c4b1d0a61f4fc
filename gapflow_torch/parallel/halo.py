"""Spatial domain decomposition with halo exchange, on lists of shards.

Counterpart of :mod:`gapflow_tpu.parallel.halo`.  The interior state
(3, Nx, Ny) is cut into a ``px x py`` mesh of blocks (bx, by), one tensor
per shard on that shard's device (:class:`Mesh`); a sharded array is a
list of ``px`` lists of ``py`` tensors, shard (ix, iy) at ``[ix][iy]``.
Before every MacCormack pass each shard's block is extended by a halo
copied from its four mesh neighbours (:func:`halo_blocks`: the x halo
first, then the y halo over the x-extended rows, so the corners ride
along), a slice of the neighbour's tensor moved with ``copy_`` when the
devices differ; on a shard that holds a domain edge that is not periodic,
the halo takes the edge's ghost value instead.  Periodic edges come from
the ring of neighbours, a mesh axis of size 1 wrapping onto itself.
``ppermute``, ``axis_index`` and ``shard_map`` have no counterpart: a
shard's (ix, iy) is its place in the lists.

Static per-cell data (topography, extra features) is laid out as
overlapping blocks that carry their own halo (:func:`pad_blocks`), built
once from the ghost-inclusive serial field.

With a fixed timestep the sharded step equals the serial step
(``core.step.make_det_step``) bit for bit: every cell's arithmetic is
the serial one.  The adaptive route (:func:`make_sharded_state_step`)
sums and maximises over the shards' owned cells, so its scalars differ
from the serial ones in summation order only.
"""

import numpy as np
import torch

from ..core.integrate import predictor_corrector, source
from ..core.state import SimState
from ..core.step import det_closures, mc_directions
from ..models.eos import eos_sound_velocity, true_div


class Mesh:
    """A ``px x py`` mesh of shards, one ``torch.device`` each.

    ``devices`` lists the shards' devices in row-major order (shard (ix,
    iy) is ``devices[ix * py + iy]``).  A device may repeat: shards that
    share one device are the counterpart of the JAX package's virtual
    devices.  ``shape`` is ``{"x": px, "y": py}``, as a JAX mesh's.
    """

    def __init__(self, devices, shape):
        px, py = shape
        if px * py != len(devices) or px < 1 or py < 1:
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(devices)} devices")
        devices = tuple(torch.device(d) for d in devices)
        if any(d.type == "cuda" for d in devices) \
                and not torch.cuda.is_available():
            raise RuntimeError("a mesh of CUDA devices needs CUDA, and "
                               "torch.cuda.is_available() is False; pass "
                               "devices=['cpu'] * k to run on the CPU")
        self.devices = devices
        self.shape = {"x": px, "y": py}

    def device(self, ix, iy):
        return self.devices[ix * self.shape["y"] + iy]


def grid_mesh(devices=None, shape=None):
    """Build a 2D mesh for spatial decomposition.

    ``devices`` defaults to every visible CUDA device (without CUDA, pass
    ``["cpu"] * k``); ``shape`` to ``(px, n // px)`` with ``px`` the
    largest divisor of ``n`` not above ``sqrt(n)``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("grid_mesh() takes the visible CUDA devices, "
                               "and torch.cuda.is_available() is False; "
                               "pass devices=['cpu'] * k to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if shape is None:
        px = int(np.floor(np.sqrt(n)))
        while n % px:
            px -= 1
        shape = (px, n // px)
    return Mesh(devices, shape)


def _block_shape(nx, ny, px, py):
    if nx % px or ny % py:
        raise ValueError(f"grid {nx} x {ny} must divide the mesh shape "
                         f"({px}, {py})")
    return nx // px, ny // py


def _np_cat(a, axis):
    return np.concatenate(a, axis=axis)


def _torch_cat(a, dim):
    return torch.cat(a, dim)


def _pad_blocks_impl(g, px, py, cat):
    C, nxg, nyg = g.shape
    bx, by = _block_shape(nxg - 2, nyg - 2, px, py)
    rows = [cat([g[:, i * bx:i * bx + bx + 2, j * by:j * by + by + 2]
                 for j in range(py)], 2) for i in range(px)]
    return cat(rows, 1)


def pad_blocks(global_with_ghosts, px, py):
    """Overlapping-block layout for static fields.

    Converts a ghost-inclusive serial field (C, Nx+2, Ny+2) into a (C,
    px*(bx+2), py*(by+2)) array whose (i, j) block is that shard's
    interior plus its one-cell halo (numpy, as the JAX package's)."""
    return _pad_blocks_impl(np.asarray(global_with_ghosts), px, py, _np_cat)


def pad_blocks_torch(g, px, py):
    """:func:`pad_blocks` on a tensor, on its device (for fields rebuilt
    every step, the EHL topography)."""
    return _pad_blocks_impl(g, px, py, _torch_cat)


def split_blocks(arr, mesh, dtype):
    """A block layout (C, px*BX, py*BY) -> the sharded array of its
    (C, BX, BY) blocks, each on its shard's device in ``dtype``."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    t = arr if torch.is_tensor(arr) else torch.as_tensor(np.asarray(arr))
    BX, BY = t.shape[1] // px, t.shape[2] // py
    return [[t[:, i * BX:(i + 1) * BX, j * BY:(j + 1) * BY]
             .to(device=mesh.device(i, j), dtype=dtype).contiguous()
             for j in range(py)] for i in range(px)]


def shard(interior, mesh, dtype):
    """An interior array (C, Nx, Ny) -> its sharded array."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    _block_shape(interior.shape[1], interior.shape[2], px, py)
    return split_blocks(interior, mesh, dtype)


def gather(blocks, device=None):
    """A sharded array -> the global (C, Nx, Ny) tensor on ``device``
    (default: the first shard's)."""
    device = device or blocks[0][0].device
    return torch.cat([torch.cat([b.to(device) for b in row], 2)
                      for row in blocks], 1)


def _edge_values(bc, adj):
    """Ghost values for one edge from its P/D/N masks (midpoint a1 = 0.5):
    Dirichlet ``2 val - adjacent``, otherwise the adjacent value."""
    return torch.stack([2. * bc["val"] - adj[c] if bc["D"][c] else adj[c]
                        for c in range(3)])


def halo_blocks(blocks, mesh, depth, cfg):
    """Each shard's block extended by a ``depth``-deep halo.

    The x halo rows come from the x neighbours' interior rows, then the y
    halo columns from the y neighbours' x-extended columns; a shard that
    holds a domain edge that is not fully periodic takes that edge's
    ghost values (:func:`_edge_values` of its adjacent line, repeated to
    the halo's depth) in place of the neighbour's wrap.  Returns the
    sharded array of (C, bx+2 depth, by+2 depth) blocks."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    d = depth
    C, bx, by = blocks[0][0].shape
    if bx < d or by < d:
        raise ValueError(f"a {d}-deep halo needs blocks of at least {d} x "
                         f"{d} cells, got {bx} x {by}")
    out = [[b.new_empty((C, bx + 2 * d, by + 2 * d)) for b in row]
           for row in blocks]
    for i in range(px):
        for j in range(py):
            out[i][j][:, d:d + bx, d:d + by] = blocks[i][j]

    per_x = all(cfg.bc_edge(0)["P"])
    for i in range(px):
        for j in range(py):
            h = out[i][j]
            if i == 0 and not per_x:
                h[:, :d, d:d + by] = _edge_values(
                    cfg.bc_edge(0), h[:, d, d:d + by])[:, None, :]
            else:
                h[:, :d, d:d + by] = out[(i - 1) % px][j][:, bx:bx + d,
                                                          d:d + by]
            if i == px - 1 and not per_x:
                h[:, bx + d:, d:d + by] = _edge_values(
                    cfg.bc_edge(1), h[:, bx + d - 1, d:d + by])[:, None, :]
            else:
                h[:, bx + d:, d:d + by] = out[(i + 1) % px][j][:, d:2 * d,
                                                               d:d + by]

    per_y = all(cfg.bc_edge(2)["P"])
    for i in range(px):
        for j in range(py):
            h = out[i][j]
            if j == 0 and not per_y:
                h[:, :, :d] = _edge_values(cfg.bc_edge(2),
                                           h[:, :, d])[:, :, None]
            else:
                h[:, :, :d] = out[i][(j - 1) % py][:, :, by:by + d]
            if j == py - 1 and not per_y:
                h[:, :, by + d:] = _edge_values(
                    cfg.bc_edge(3), h[:, :, by + d - 1])[:, :, None]
            else:
                h[:, :, by + d:] = out[i][(j + 1) % py][:, :, d:2 * d]
    return out


def _one_pass_local(cfg, q_pad, topo_pad, extra_pad, dt, d):
    """One MacCormack pass on a halo-padded block; returns the interior.
    The arithmetic of ``core.step.make_det_step``'s pass, cell for cell."""
    p, tau_bulk, s_lo, s_up = det_closures(cfg, q_pad, topo_pad, extra_pad)
    fX, fY = predictor_corrector(q_pad, p, tau_bulk, d)
    src = source(q_pad, topo_pad, tau_bulk, s_lo, s_up)
    q_new = q_pad - dt * (true_div(fX, cfg.dx) + true_div(fY, cfg.dy) - src)
    return q_new[:, 1:-1, 1:-1]


def _local_dt(dt, blocks):
    """``dt`` as a 0-d tensor on each shard's device, in its dtype."""
    return [[torch.as_tensor(dt, dtype=b.dtype).to(b.device) for b in row]
            for row in blocks]


def _passes(cfg, mesh, q, topo, extra, dts, step_idx):
    """The two passes of one step (pass order by ``cfg.MC_order``, or by
    the parity of ``step_idx`` when it is 0) and the average."""
    if cfg.MC_order != 0:
        d0, d1 = mc_directions(cfg.MC_order)
    else:
        d0, d1 = (1, -1) if int(step_idx) % 2 == 0 else (-1, 1)

    def one(qq, dd):
        padded = halo_blocks(qq, mesh, 1, cfg)
        return [[_one_pass_local(cfg, padded[i][j], topo[i][j], extra[i][j],
                                 dts[i][j], dd)
                 for j in range(len(qq[0]))] for i in range(len(qq))]

    q1 = one(one(q, d0), d1)
    return [[(a + b) / 2. for a, b in zip(r1, r0)] for r1, r0 in zip(q1, q)]


def make_sharded_det_step(cfg, mesh):
    """The sharded MacCormack timestep.

    ``step(q, topo_blocks, extra_blocks, dt, step_idx) -> q`` with ``q``
    the sharded interior and the static fields the sharded
    :func:`pad_blocks` layout.
    """
    if cfg.thinning is not None:
        # thinning's per-cell eta reads p at +-1 cells (np.gradient), so
        # the halo cells' tau_bulk would need 2-deep halos to match the
        # serial stencil exactly
        raise NotImplementedError(
            "sharded stepping with shear thinning needs 2-deep halos; "
            "run thinning configs on the serial kernel path")

    def step(q, topo, extra, dt, step_idx):
        return _passes(cfg, mesh, q, topo, extra, _local_dt(dt, q), step_idx)

    return step


def make_sharded_trajectory(cfg, mesh, n):
    """``run(q, topo, extra, dt) -> q``: ``n`` sharded steps, the pass
    order's step index counted from 0 (as the JAX package's scan)."""
    step = make_sharded_det_step(cfg, mesh)

    def run(q, topo, extra, dt):
        for i in range(n):
            q = step(q, topo, extra, dt, i)
        return q

    return run


def _ownership_weights(bx, by, ix, iy, px, py, dtype, device):
    """(bx+2, by+2) mask of the cells shard (ix, iy) contributes to global
    reductions: its interior plus the halo rows and columns that are
    global ghost cells (the serial reductions run over the ghost-inclusive
    array); a halo cell that is a neighbour's interior counts zero."""
    wx = torch.ones(bx + 2, dtype=dtype, device=device)
    wy = torch.ones(by + 2, dtype=dtype, device=device)
    wx[0], wx[-1] = float(ix == 0), float(ix == px - 1)
    wy[0], wy[-1] = float(iy == 0), float(iy == py - 1)
    return wx[:, None] * wy[None, :]


def make_sharded_state_step(cfg, mesh):
    """The full sharded timestep on a :class:`SimState` whose ``q``,
    ``topo`` and ``extra`` are sharded arrays (:func:`shard_problem_state`)
    and whose scalars lie on the first shard's device: adaptive dt,
    residual tracking and the NaN/negative-density rollback.

    The scalar pipeline of ``core.step.make_det_step`` over the shards:
    kinetic energy a sum of the shards' ownership-weighted sums, v_max and
    c_max maxima over the shards' owned cells, so every shard steps with
    the same dt; validity a count of violations over the shards, and on a
    violation every field rolls back uniformly.
    """
    px, py = mesh.shape["x"], mesh.shape["y"]
    prop = cfg.prop
    dev0 = mesh.devices[0]

    def step(state):
        q0 = state.q
        dts = _local_dt(state.dt, q0)
        q = _passes(cfg, mesh, q0, state.topo, state.extra, dts, state.step)

        # ghost-filled padded blocks of the averaged q == serial
        # apply_bcs(q); the global reductions run over owned cells only
        qp = halo_blocks(q, mesh, 1, cfg)
        owned = [(qp[i][j], _ownership_weights(
            q[i][j].shape[1], q[i][j].shape[2], i, j, px, py,
            q[i][j].dtype, q[i][j].device))
            for i in range(px) for j in range(py)]
        bad = torch.stack([torch.sum(w * (torch.isnan(b).any(0)
                                          | (b[0] < 0.))).to(dev0)
                           for b, w in owned]).sum()
        valid = bad == 0.

        ekin, vmax, cmax = [], [], []
        for b, w in owned:
            # guard the scalar pipeline against the invalid branch (NaN or
            # rho <= 0 would poison the reductions; the results are
            # discarded by the rollback below)
            b = torch.where(valid.to(b.device), b, torch.ones_like(b))
            w_inf = torch.zeros_like(w).masked_fill(w == 0., -torch.inf)
            ekin.append(torch.sum(w * (b[1] ** 2 + b[2] ** 2) / b[0] / 2.)
                        .to(dev0))
            vmax.append(torch.max(torch.sqrt((b[1] ** 2 + b[2] ** 2) / b[0])
                                  + w_inf).to(dev0))
            cmax.append(torch.max(eos_sound_velocity(b[0], prop) + w_inf)
                        .to(dev0))
        ekin = torch.stack(ekin).sum()
        vmax = torch.stack(vmax).max()
        cmax = torch.stack(cmax).max()

        dt = state.dt
        dt_crit = min(cfg.dx, cfg.dy) / (vmax + cmax)
        cfl = dt / dt_crit
        residual = (torch.abs(ekin - state.ekin_old)
                    / state.ekin_old.clamp(min=1e-300) / cfl)
        new_dt = cfg.CFL * dt_crit if cfg.adaptive else dt

        def sel(a, b):
            return torch.where(valid, a, b)

        q = [[torch.where(valid.to(a.device), a, b) for a, b in zip(r, r0)]
             for r, r0 in zip(q, q0)]
        return state._replace(
            q=q,
            dt=sel(new_dt, dt),
            step=sel(state.step + 1, state.step),
            simtime=sel(state.simtime + dt, state.simtime),
            ekin_old=sel(ekin, state.ekin_old),
            residual=sel(residual, state.residual),
            residual_buffer=sel(torch.cat([residual[None],
                                           state.residual_buffer[:-1]]),
                                state.residual_buffer),
            valid=valid,
        )

    return step


def make_sharded_state_trajectory(cfg, mesh, n):
    """``run(state) -> state``: ``n`` steps of
    :func:`make_sharded_state_step`."""
    step = make_sharded_state_step(cfg, mesh)

    def run(state):
        for _ in range(n):
            state = step(state)
        return state

    return run


def shard_problem_arrays(problem, mesh, dtype=None):
    """A Problem's state, sharded for the sharded step: ``(q, topo,
    extra)`` with ``q`` the interior (the serial ghost cells stripped) and
    ``topo`` and ``extra`` in the :func:`pad_blocks` layout, each shard on
    its device in ``dtype`` (default: the Problem's)."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    dtype = dtype or problem.dtype
    q = shard(np.asarray(problem.q)[:, 1:-1, 1:-1], mesh, dtype)
    topo = split_blocks(pad_blocks(problem.topo.full, px, py), mesh, dtype)
    extra = split_blocks(pad_blocks(problem.fc.get_real_field("extra").p,
                                    px, py), mesh, dtype)
    return q, topo, extra


def shard_problem_state(problem, mesh):
    """The sharded :class:`SimState` of :func:`make_sharded_state_step`.

    ``q`` is the sharded interior, ``topo`` and ``extra`` the
    :func:`pad_blocks` layout; the scalars lie on the first shard's
    device.  ``ekin_old`` is the ghost-inclusive serial sum
    (``core.state`` semantics)."""
    q, topo, extra = shard_problem_arrays(problem, mesh)
    dtype, dev0 = problem.dtype, mesh.devices[0]
    q_full = torch.as_tensor(problem.q, dtype=dtype, device=dev0)
    ekin = torch.sum((q_full[1] ** 2 + q_full[2] ** 2) / q_full[0] / 2.)
    buf = torch.full((5,), torch.inf, dtype=dtype, device=dev0)
    buf[0] = 1.

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev0)

    return SimState(
        q=q, topo=topo, extra=extra,
        dt=scalar(problem.dt),
        step=torch.tensor(problem.step, dtype=torch.int32, device=dev0),
        simtime=scalar(getattr(problem, "simtime", 0.) or 0.),
        ekin_old=ekin,
        residual=scalar(1.),
        residual_buffer=buf,
        valid=torch.tensor(True, device=dev0),
    )
