"""The simulation state: a named tuple of tensors on one device."""

from typing import NamedTuple

import numpy as np
import torch


class SimState(NamedTuple):
    """Everything the deterministic step reads and writes.

    Field order and meaning follow :class:`gapflow_tpu.core.state.SimState`.
    Scalars are 0-d tensors on the state's device, so a step never has to
    synchronise with the host to update them.
    """

    q: torch.Tensor          # (3, Nx+2, Ny+2)  conserved variables
    topo: torch.Tensor       # (4, Nx+2, Ny+2)  h, dh/dx, dh/dy, deformation
    extra: torch.Tensor      # (n_extra, Nx+2, Ny+2)  e.g. slip length
    dt: torch.Tensor         # ()   current timestep
    step: torch.Tensor       # ()   int32 step counter
    simtime: torch.Tensor    # ()   physical time
    ekin_old: torch.Tensor   # ()   kinetic energy of previous step
    residual: torch.Tensor   # ()   latest convergence residual
    residual_buffer: torch.Tensor  # (5,) trailing residuals
    valid: torch.Tensor      # ()   bool: no NaN / negative density

    @classmethod
    def from_numpy(cls, mapping, device, dtype):
        """Build a state from a mapping of field name -> numpy array.

        ``mapping`` holds every field of the tuple (for example the JAX
        package's ``SimState._asdict()`` converted with ``np.asarray``).
        Float fields are cast to ``dtype``; ``step`` becomes int32 and
        ``valid`` bool.
        """
        def conv(name, value):
            if name == "step":
                return torch.as_tensor(np.array(value), dtype=torch.int32,
                                       device=device)
            if name == "valid":
                return torch.as_tensor(np.array(value), dtype=torch.bool,
                                       device=device)
            return torch.as_tensor(np.array(value), dtype=dtype,
                                   device=device)

        return cls(**{name: conv(name, mapping[name]) for name in cls._fields})

    def to_numpy(self):
        """The state as a dict of numpy arrays (host copies)."""
        return {name: getattr(self, name).detach().cpu().numpy()
                for name in self._fields}

