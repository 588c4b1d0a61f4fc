"""Named field registry over plain arrays (µGrid GlobalFieldCollection stand-in).

The reference keeps all grid fields in a C++ µGrid ``GlobalFieldCollection``
(reference GaPFlow/problem.py:124-141).  Here a field is just a numpy array of
shape ``(*components, Nx+2, Ny+2)`` held in a host-side registry; the jitted
solver consumes/produces jnp pytrees built from these arrays, and host code
(GP plumbing, I/O, viz) reads and writes them in place through ``.p``.
"""

import numpy as np


class Field:
    """A named array with in-place access through ``.p`` (µGrid.Field parity)."""

    def __init__(self, name, array):
        self.name = name
        self._array = array

    @property
    def p(self):
        return self._array

    @p.setter
    def p(self, value):
        self._array[...] = value

    @property
    def shape(self):
        return self._array.shape


class FieldCollection:
    """Registry of named fields on an ``(Nx+2, Ny+2)`` ghost-padded grid."""

    def __init__(self, nb_grid_pts, dtype=np.float64):
        self.nb_grid_pts = tuple(int(n) for n in nb_grid_pts)
        self.dtype = dtype
        self._fields = {}

    def real_field(self, name, components=()):
        """Create (or return existing) field with the given component shape."""
        if name in self._fields:
            return self._fields[name]
        if isinstance(components, int):
            components = (components,)
        arr = np.zeros(tuple(components) + self.nb_grid_pts, dtype=self.dtype)
        field = Field(name, arr)
        self._fields[name] = field
        return field

    # µGrid-compatible aliases
    register_real_field = real_field

    def get_real_field(self, name):
        return self._fields[name]

    def __contains__(self, name):
        return name in self._fields

    def field_names(self):
        return list(self._fields)

    def asdict(self):
        """Snapshot of all field arrays (for pytree construction)."""
        return {k: v.p for k, v in self._fields.items()}


def wrap_field(field):
    """Identity shim for reference-API parity (µGrid.Field.wrap_field)."""
    return field
