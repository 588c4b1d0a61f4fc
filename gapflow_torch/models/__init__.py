"""Constitutive models: EOS, viscosity, stress closures and field models."""

from .stress import Pressure, WallStress, BulkStress  # noqa: F401
