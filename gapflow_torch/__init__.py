"""gapflow-torch: gap-averaged lubrication flow on PyTorch, with CUDA kernels.

The PyTorch counterpart of :mod:`gapflow_tpu`: a 2D finite-volume
MacCormack solver for the compressible, gap-averaged Navier-Stokes
(lubrication) equations, closed by analytic constitutive laws or by
Gaussian-process surrogates trained from (mock) MD data through active
learning.  Module names follow the JAX package, so each module's
counterpart is found under the same name there.

This package covers the deterministic path (YAML configuration,
topography, the plain torch step :mod:`gapflow_torch.core.step`), the GP
path (:mod:`gapflow_torch.db`, :mod:`.models.gp`, :mod:`.core.al_chunked`
for silent runs, the per-step host loop of :class:`Problem` for
non-silent ones), the elastic / EHL slice (:mod:`gapflow_torch.elastic`,
:mod:`.core.ehl`), the differentiable blocked Cholesky and triangular
solve (:mod:`gapflow_torch.ops.cholesky`) and the sharded deterministic
and elastic runs over a mesh of shards (:mod:`gapflow_torch.parallel`);
on an NVIDIA Hopper GPU they run through the CUDA kernels of
:mod:`gapflow_torch.ops` (``csrc/*.cu``).

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

from .db import Database  # noqa: F401, E402
from .problem import Problem  # noqa: F401, E402
