"""Spatial domain decomposition over a mesh of shards.

Counterpart of :mod:`gapflow_tpu.parallel`: :mod:`.halo` (the mesh, the
block layouts, the halo exchange, the plain sharded step and the
adaptive sharded state step), :mod:`.pallas_halo` (the sharded loops
through the shard sweep) and :mod:`.ehl` (the sharded EHL loop).
Shards may share a device (on one card, a mesh of ``cuda:0`` shards; on
the CPU, ``["cpu"] * k``); meshes across several GPUs are allowed but not
verified.  :meth:`gapflow_torch.Problem.run_steps_sharded` is the entry
point.  Not ported yet (ROADMAP queue 1 item 11): the frozen-GP, GP x
elastic and sharded active-learning families, and meshes across
processes.
"""

from .halo import (Mesh, gather, grid_mesh, make_sharded_det_step,  # noqa: F401
                   make_sharded_state_step, make_sharded_state_trajectory,
                   make_sharded_trajectory, pad_blocks, shard,
                   shard_problem_arrays, shard_problem_state)
