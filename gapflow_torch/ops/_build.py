"""Build and bind the CUDA kernels of ``gapflow_torch/csrc``.

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface, under ``build/gapflow_torch/`` at the repository
root, and loaded with :mod:`ctypes`.  The library name carries a hash of
the source, so an edited source is rebuilt and a current build is reused.
There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "stencil.cu"
BUILD_DIR = _PKG.parent / "build" / "gapflow_torch"

# --fmad=false: no contraction of a*b + c into one rounding, so the kernel
# rounds op for op like its plain torch twin; differences between the two
# then stay at the ulp level even where float32 evaluation of a model is
# ill-conditioned (the BWR polynomial, DH's r - 1).  The kernel is bound by
# memory bytes, not by arithmetic.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, st, out, nx, ny, d0, emit_delta, iprm, fprm, dt, stream
    "gf_fused_step": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _F, _P],
    # q, lo, st, q_out, lo_out, nx, ny, d0, iprm, fprm, dt, stream
    "gf_comp_step": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _P],
}


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, /usr/local/cuda/bin, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgapflow_stencil_{digest}.so"


def build():
    """Compile the kernel library if it is not built yet; return its path."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load():
    """The loaded kernel library, with argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gf_error_string.argtypes = [ctypes.c_int]
    lib.gf_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, code, what):
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({lib.gf_error_string(code).decode()})")
