"""Build and bind the CUDA kernels of ``gapflow_torch/csrc``.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` (one process
per source, all started together) and the objects are linked into one
shared library with a plain C interface, under ``build/gapflow_torch/``
at the repository root, loaded with :mod:`ctypes`.  The library name
carries a hash of every source and header and of the flags, so an edited
source is rebuilt and a current build is reused.  ``ptxas`` reports each
kernel's registers, shared memory and spills into ``<library>.log``.
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gapflow_torch"

# --fmad=false: no contraction of a*b + c into one rounding, so the kernel
# rounds op for op like its plain torch twin; differences between the two
# then stay at the ulp level even where float32 evaluation of a model is
# ill-conditioned (the BWR polynomial, DH's r - 1).  The stencil kernels
# are bound by memory bytes, the GP kernels by sqrt and exp, neither by
# the separate multiply and add.  The Cholesky and solve kernels are bound
# by multiply-adds, which this flag issues as two operations each; their
# products keep the separate multiply and add so that they equal their
# twins bit for bit, and gain their speed from a shorter critical path (the
# diagonal tile's sub-blocked factorization and inverse, overlapped with
# the trailing update on a second stream) and from output tiles that fill
# the card, not from the arithmetic rate.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, st, out, nx, ny, d0, iprm, fprm, dt, stream
    "gf_fused_step": [_P, _P, _P, _I, _I, _I, _P, _P, _F, _P],
    # q, lo, st, q_out, lo_out, nx, ny, d0, iprm, fprm, dt, stream
    "gf_comp_step": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _P],
    # q, lo, st, A, B, nx, ny, n, k, d0, iprm, fprm, dt, stream
    "gf_comp_sweeps": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _F,
                       _P],
    # q, st, out, nx, ny, k, d0, iprm, fprm, dt, stream
    "gf_plain_steps": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _F, _P],
    # q, st, A, B, nx, ny, n, k, d0, iprm, fprm, dt, stream
    "gf_plain_sweeps": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _F, _P],
    # q, st, A, B, nx, ny, n, k, d0, iprm, fprm, bprm, bfprm, dt, stream
    "gf_plain_sweeps_bc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P, _F, _P],
    # q, st, A, B, nx, ny, n, d0, iprm, fprm, dt, blocks, stream
    "gf_plain_run": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _F, _I, _P],
    # q, st, out, nx, ny, k, d0, iprm, fprm, bprm, bfprm, dt, stream
    "gf_plain_steps_bc": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _F,
                          _P],
    # q, st, out, nx, ny, d0, iprm, fprm, bprm, bfprm, dt, stream
    "gf_fused_step_bc": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _F, _P],
    # q, lo, st, q_out, lo_out, nx, ny, d0, iprm, fprm, bprm, bfprm, dt,
    # stream
    "gf_comp_step_bc": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _F,
                        _P],
    # q, lo, st, A, B, nx, ny, n, k, d0, iprm, fprm, bprm, bfprm, dt,
    # stream
    "gf_comp_sweeps_bc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                          _P, _F, _P],
    # qg, st, gx, gy, out, nx, ny, d0, emit_delta, iprm, fprm, bprm, bfprm,
    # dt, stream
    "gf_mixed_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                      _F, _P],
    # q, st, out, p_out, scratch, nx, ny, st_ghosted, d0, iprm, fprm,
    # bprm, bfprm, meta, coef, data, dt, stream
    "gf_gp_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                   _P, _P, _F, _P],
    # q, st, buf0, buf1, scratch, nx, ny, n, d0, iprm, fprm, bprm, bfprm,
    # meta, coef, data, dt, stream
    "gf_gp_steps": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                    _P, _P, _F, _P],
    # q, st, out, nx, ny, meta, coef, data, stream
    "gf_gp_fields": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    # x, fast, ref, n, stream
    "gf_sqrt_pair": [_P, _P, _P, _I, _P],
    # q, hu, u, ls, out, nx, ny, shift, d0, emit_delta, iprm, fprm, rdx2,
    # rdy2, dt, stream
    "gf_ehl_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _F, _F,
                    _F, _P],
    # q, lo, hu, u, ls, q_out, lo_out, nx, ny, shift, d0, iprm, fprm, rdx2,
    # rdy2, dt, stream
    "gf_ehl_comp_step": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                         _F, _F, _F, _P],
    # q, st, out, bx, by, d0, iprm, fprm, bprm, bfprm, xe, xw, yn, ys, dt,
    # stream
    "gf_shard_step": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                      _F, _P],
    # q, st, out, bx, by, k, hq, hs, d0, iprm, fprm, bprm, bfprm, xe, xw,
    # yn, ys, dt, stream
    "gf_shard_sweep": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                       _I, _I, _I, _I, _F, _P],
    # A, L, W, n, stream, side stream
    "gf_cholesky": [_P, _P, _P, _I, _P, _P],
    # L, B, X, W, Y, n, m, stream
    "gf_tril_solve": [_P, _P, _P, _P, _P, _I, _I, _P],
}


def sources():
    return sorted(CSRC.glob("*.cu"))


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libgapflow_stencil_{h.hexdigest()[:16]}.so"


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def build():
    """Compile the kernel library if it is not built yet; return its path."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                str(src)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), src)
             for src, obj in zip(sources(), objs)]
    log, failed = [], []
    for proc, src in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.tmp"
    log.append(_run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                     *map(str, objs)]))
    for obj in objs:
        obj.unlink()
    lib.with_suffix(".log").write_text("\n".join(log))
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
