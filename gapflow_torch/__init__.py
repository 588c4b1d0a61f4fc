"""gapflow-torch: gap-averaged lubrication flow on PyTorch, with CUDA kernels.

The PyTorch counterpart of :mod:`gapflow_tpu`: a 2D finite-volume
MacCormack solver for the compressible, gap-averaged Navier-Stokes
(lubrication) equations, closed by analytic constitutive laws.  Module
names follow the JAX package, so each module's counterpart is found under
the same name there.

This package covers the deterministic path: YAML configuration,
topography, the plain torch step (:mod:`gapflow_torch.core.step`) and, on
an NVIDIA Hopper GPU, the fused MacCormack stencil kernels of
:mod:`gapflow_torch.ops.stencil` (CUDA C++ in ``csrc/stencil.cu``).

Precision: float64 by default; set the environment variable
``GAPFLOW_X64=0`` before import to run in float32 (the production setting
on the GPU).  The choice is held in :data:`DTYPE` and passed down
explicitly; the package never calls ``torch.set_default_dtype``.
"""

import os

import torch

#: Working float type of every Problem that is not given one.
DTYPE = torch.float32 if os.environ.get("GAPFLOW_X64", "1") == "0" \
    else torch.float64

__version__ = "0.1.0"

from .problem import Problem  # noqa: F401, E402
