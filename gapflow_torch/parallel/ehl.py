"""Sharded elastohydrodynamic (EHL) stepping over a mesh of shards.

Counterpart of :func:`gapflow_tpu.parallel.ehl.make_sharded_ehl_loop`
(the deterministic family; the GP x elastic loop is not ported yet,
ROADMAP queue 1 item 11b).  The fluid runs sharded between deformation
updates (:mod:`.pallas_halo`'s periodic shard-sweep loop, or the plain sharded
step of :mod:`.halo`); for each update the evolved interior is gathered
to the first shard's device, its serial ghost ring rebuilt with
``apply_bcs``, and its pressure deforms the surface through the port's
half-space (``elastic.py``, cuFFT on the card), under-relaxed with the
compounded factor ``1 - (1 - alpha)^K``.  The rebuilt topography is cut
back into each shard's block.  Semantics: ``core.ehl.make_ehl_loop``'s
end-of-step protocol, to floating-point reduction order.
"""

import numpy as np
import torch

from ..core.ehl import _elastic, _topo_from_deformation
from ..core.step import apply_bcs
from ..models.eos import eos_pressure
from ..ops import stencil
from .halo import (gather, make_sharded_det_step, pad_blocks,
                   pad_blocks_torch, split_blocks)
from .pallas_halo import (make_sharded_pallas_loop, pad_blocks2,
                          pad_blocks2_torch, statics_depth)


def make_sharded_ehl_loop(problem, mesh, deform_every=1, use_pallas=None,
                          sweep_fn=None):
    """Build ``loop(q, u_prev, dt, n_steps) -> (q, u)`` over ``mesh``.

    ``q`` is the sharded interior in the Problem's dtype
    (``halo.shard_problem_arrays``); ``u_prev`` the ghost-inclusive
    deformation, kept on the first shard's device in that dtype.
    ``use_pallas=None`` takes the periodic shard-sweep loop where every
    shard is on a CUDA device, the dtype is float32 and the kernel covers
    the configuration (fully periodic, no thinning, a static pass order);
    ``False`` the plain sharded step.  ``sweep_fn`` replaces
    :func:`ops.stencil.shard_sweep` on the kernel route.
    """
    hs_deform, alpha, shift_ref = _elastic(problem)
    cfg = problem._solver_cfg
    dtype = problem.dtype
    dev0 = mesh.devices[0]
    px, py = mesh.shape["x"], mesh.shape["y"]
    nx, ny = problem.grid["Nx"], problem.grid["Ny"]
    if use_pallas is None:
        use_pallas = (all(d.type == "cuda" for d in mesh.devices)
                      and dtype == torch.float32
                      and stencil._periodic_kernel_ok(cfg))

    h_und = torch.as_tensor(problem.topo.h_undeformed, dtype=dtype,
                            device=dev0)
    extra = np.asarray(problem.fc.get_real_field("extra").p)
    K = int(deform_every)
    alpha_K = 1. - (1. - alpha) ** K

    if use_pallas:
        fluid_loop = make_sharded_pallas_loop(cfg, mesh, nx, ny, dtype,
                                              sweep_fn)
        d = statics_depth(fluid_loop.k)
        extra_b = split_blocks(pad_blocks2(extra, px, py, d), mesh, dtype)

        def fluid(q, topo_full, dt, step0):
            topo2 = split_blocks(pad_blocks2_torch(topo_full, px, py, d),
                                 mesh, dtype)
            return fluid_loop(q, topo2, extra_b, dt, K)
    else:
        step = make_sharded_det_step(cfg, mesh)
        extra_b = split_blocks(pad_blocks(extra, px, py), mesh, dtype)

        def fluid(q, topo_full, dt, step0):
            topo_b = split_blocks(pad_blocks_torch(topo_full, px, py), mesh,
                                  dtype)
            for k in range(K):
                q = step(q, topo_b, extra_b, dt, step0 + k)
            return q

    def loop(q, u_prev, dt, n_steps):
        if n_steps % K:
            raise ValueError("n_steps must be divisible by deform_every")
        u = torch.as_tensor(u_prev, device=dev0).to(dtype)
        for i in range(n_steps // K):
            u_eff = u - u[0, 0] if shift_ref else u
            topo_full = _topo_from_deformation(h_und, u_eff, cfg.dx, cfg.dy)
            q = fluid(q, topo_full, dt, i * K)
            # gather the evolved interior, rebuild the serial ghost ring
            # (ghost fills are linear, so the fresh fill equals the
            # step-evolved ghosts), and deform from its pressure
            q_int = gather(q, dev0)
            q_ghost = q_int.new_zeros((3, nx + 2, ny + 2))
            q_ghost[:, 1:-1, 1:-1] = q_int
            p = eos_pressure(apply_bcs(q_ghost, cfg)[0], cfg.prop)
            if shift_ref:
                p = p - p[0, 0]
            u = (1. - alpha_K) * u + alpha_K * hs_deform(p.to(u.dtype))
        return q, u

    return loop
