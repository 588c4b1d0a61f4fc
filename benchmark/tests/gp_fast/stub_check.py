"""A stub comparison, for the CPU test of a cell added as files alone: it
reads what the harness hands every comparison and judges nothing of the
physics.

- ``chunk_index``: the index of the chunk the harness kept;
- ``chunk_moved``: the largest change of the state over that chunk;
- ``final_err``: the state the run left on the host against the last
  chunk's output (exact).
"""

import numpy as np

from check import host

NAMES = ("chunk_index", "chunk_moved", "final_err")


def numbers(cfg, traffic, rho0, prog, device="cpu"):
    index, q_in, q_out, dt, n = prog["chunk"]
    final = host(prog["final"])
    return {"chunk_index": float(index),
            "chunk_moved": float(np.max(np.abs(host(q_out) - host(q_in)))),
            "final_err": float(np.max(np.abs(final - host(prog["last"]))))}
