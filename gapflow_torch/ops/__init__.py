"""Hand-written GPU kernels and their drivers."""

from .stencil import make_pallas_step, make_pallas_loop, pallas_supported  # noqa: F401
