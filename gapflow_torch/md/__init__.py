"""MD oracles of the GP training database.

Only the mock oracle is ported; the native and LAMMPS engines
(``md: system: lj`` / ``mol``) are ROADMAP queue 1, item 10.
"""

from .mock import Mock  # noqa: F401
