"""Frame-appending NetCDF output for grid fields.

Replaces the reference's µGrid ``FileIONetCDF`` (reference
GaPFlow/problem.py:185-205), which writes NetCDF-4/HDF5.  Two backends:

- **NETCDF4** (default when :mod:`h5py` is available): HDF5 with the
  netcdf-c dimension-scale conventions (CLASS/NAME attrs,
  ``_Netcdf4Dimid``), so files open in netCDF4-python and reference-
  produced ``sol.nc``/``topo.nc`` files open here.  No 2 GiB record
  limit — required for 4096² production frames.
- **NETCDF3** (fallback): ``scipy.io.netcdf_file`` classic format.

Layout (both backends): each registered field becomes a variable with
dimensions ``(frame, [components,] nx, ny)`` where frame is the unlimited
record dimension.  The viz/CLI layer and the tests read files through
:class:`NCReader`, which sniffs the on-disk format from the magic bytes.
"""

import numpy as np
from scipy.io import netcdf_file

try:
    import h5py
except ImportError:          # pragma: no cover - h5py is normally present
    h5py = None

#: netcdf-c marker for a dimension that has no coordinate variable
#: (libsrc4/nc4hdf.c): NAME = this string + "%10d" % len.
_DIM_WITHOUT_VARIABLE = ("This is a netCDF dimension but"
                         " not a netCDF variable.")


def _default_format():
    return "NETCDF4" if h5py is not None else "NETCDF3"


class NCWriter:
    """Append-per-frame NetCDF writer for a set of named fields."""

    def __init__(self, fname, field_collection=None, field_names=None,
                 format=None):
        format = format or _default_format()
        if format == "NETCDF4":
            if h5py is None:
                raise RuntimeError("NETCDF4 output requires h5py")
            self._impl = _H5Writer(fname)
        elif format == "NETCDF3":
            self._impl = _ScipyWriter(fname)
        else:
            raise ValueError(f"unknown NetCDF format {format!r}")

        self._fname = fname
        self._fc = None
        self._names = []
        self._nframes = 0
        if field_collection is not None:
            self.register_field_collection(field_collection, field_names)

    def register_field_collection(self, fc, field_names=None):
        self._fc = fc
        names = field_names if field_names is not None else fc.field_names()
        nx, ny = fc.nb_grid_pts
        self._impl.ensure_dim("frame", None)
        self._impl.ensure_dim("grid_x", nx)
        self._impl.ensure_dim("grid_y", ny)
        for name in names:
            field = fc.get_real_field(name)
            comp_shape = field.p.shape[:-2]
            dims = ["frame"]
            for c in comp_shape:
                dim_name = f"comp_{c}"
                self._impl.ensure_dim(dim_name, c)
                dims.append(dim_name)
            dims += ["grid_x", "grid_y"]
            self._impl.create_variable(name, tuple(dims))
            self._names.append(name)

    def append_frame(self):
        """Stage a new frame; call ``.write()`` on the result to commit."""
        return _Frame(self)

    def _write_frame(self):
        i = self._nframes
        for name in self._names:
            arr = np.asarray(self._fc.get_real_field(name).p,
                             dtype=np.float64)
            self._impl.write_record(name, i, arr)
        self._nframes += 1
        self._impl.flush()

    def close(self):
        self._impl.close()


class _ScipyWriter:
    """NetCDF-3 classic backend (64-bit offset)."""

    def __init__(self, fname):
        self._nc = netcdf_file(fname, "w", version=2)
        self._dims = {}
        self._vars = {}

    def ensure_dim(self, name, size):
        if name not in self._dims:
            self._nc.createDimension(name, size)
            self._dims[name] = size

    def create_variable(self, name, dims):
        self._vars[name] = self._nc.createVariable(name, "d", dims)

    def write_record(self, name, frame, arr):
        self._vars[name][frame, ...] = arr

    def flush(self):
        self._nc.flush()

    def close(self):
        if self._nc is not None:
            self._nc.close()
            self._nc = None


class _H5Writer:
    """NetCDF-4 backend: HDF5 + netcdf-c dimension-scale conventions."""

    def __init__(self, fname):
        self._h5 = h5py.File(fname, "w")
        self._dims = {}          # name -> (dataset, size or None)
        self._vars = {}
        self._ndims = 0

    def ensure_dim(self, name, size):
        if name in self._dims:
            return
        if size is None:         # unlimited (record) dimension
            ds = self._h5.create_dataset(name, shape=(0,), maxshape=(None,),
                                         dtype="f4")
        else:
            ds = self._h5.create_dataset(name, shape=(size,), dtype="f4")
        ds.make_scale(_DIM_WITHOUT_VARIABLE + "%10d" % (size or 0))
        ds.attrs["_Netcdf4Dimid"] = np.int32(self._ndims)
        self._dims[name] = (ds, size)
        self._ndims += 1

    def create_variable(self, name, dims):
        shape = tuple(self._dims[d][1] or 0 for d in dims)
        maxshape = tuple(self._dims[d][1] for d in dims)
        chunks = tuple(max(s, 1) for s in shape)
        ds = self._h5.create_dataset(name, shape=shape, maxshape=maxshape,
                                     chunks=chunks, dtype="f8")
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self._dims[d][0])
        ds.attrs["_Netcdf4Coordinates"] = np.array(
            [self._dims[d][0].attrs["_Netcdf4Dimid"] for d in dims],
            dtype=np.int32)
        self._vars[name] = (ds, dims)

    def write_record(self, name, frame, arr):
        ds, dims = self._vars[name]
        if ds.shape[0] <= frame:
            ds.resize(frame + 1, axis=0)
        ds[frame, ...] = arr
        # keep the record dim scale in step with the data
        rec = self._dims[dims[0]][0]
        if rec.maxshape[0] is None and rec.shape[0] <= frame:
            rec.resize((frame + 1,))

    def flush(self):
        self._h5.flush()

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None


class _Frame:
    def __init__(self, writer):
        self._writer = writer

    def write(self):
        self._writer._write_frame()


def _is_hdf5(fname):
    with open(fname, "rb") as fh:
        return fh.read(8) == b"\x89HDF\r\n\x1a\n"


class NCReader:
    """Read NetCDF-3 or NetCDF-4 frame files (context-manager friendly)."""

    def __init__(self, fname):
        if _is_hdf5(fname):
            if h5py is None:
                raise RuntimeError(f"{fname} is NetCDF-4/HDF5 but h5py is "
                                   "not available")
            self._impl = _H5Reader(fname)
        else:
            self._impl = _ScipyReader(fname)

    @property
    def variables(self):
        return self._impl.variables

    def field(self, name, frame=None):
        return self._impl.field(name, frame)

    def num_frames(self, name=None):
        if name is None:
            name = next(iter(self.variables))
        return self._impl.num_frames(name)

    def close(self):
        self._impl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ScipyReader:
    def __init__(self, fname):
        self._nc = netcdf_file(fname, "r", mmap=False)

    @property
    def variables(self):
        return self._nc.variables

    def field(self, name, frame=None):
        data = self._nc.variables[name].data
        if frame is None:
            return np.array(data)
        return np.array(data[frame])

    def num_frames(self, name):
        return self._nc.variables[name].shape[0]

    def close(self):
        self._nc.close()


class _H5Reader:
    """NetCDF-4 files are HDF5: variables = non-dimension-scale datasets
    (plus coordinate variables, i.e. scales holding real data)."""

    def __init__(self, fname):
        self._h5 = h5py.File(fname, "r")
        self._vars = {}
        for name, ds in self._h5.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            scale_name = ds.attrs.get("NAME")
            if scale_name is not None:
                if isinstance(scale_name, bytes):
                    scale_name = scale_name.decode(errors="replace")
                if str(scale_name).startswith(_DIM_WITHOUT_VARIABLE):
                    continue     # bare dimension, not a variable
            self._vars[name] = ds

    @property
    def variables(self):
        return self._vars

    def field(self, name, frame=None):
        ds = self._vars[name]
        if frame is None:
            return np.asarray(ds[...], dtype=np.float64)
        return np.asarray(ds[frame], dtype=np.float64)

    def num_frames(self, name):
        return self._vars[name].shape[0]

    def close(self):
        self._h5.close()
