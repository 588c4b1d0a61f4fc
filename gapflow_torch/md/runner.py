"""Process layer for MD engine runs.

Parity: reference GaPFlow/md/runner.py:30-79.  The reference spawns
``nworker`` MPI ranks that form ONE LAMMPS world (domain decomposition).
The bundled native engine parallelizes a single simulation with OpenMP
threads instead, so ``run_parallel`` here means "one simulation, nworker
threads" — never N duplicate runs racing on the same output files.
"""

import shutil
import subprocess
import sys

#: Capability flag: the native engine supports intra-run parallelism
#: (OpenMP threads).  The reference's flag means "mpi4py importable".
PARALLEL = True

#: Candidate external LAMMPS executables, most-capable first.
_LAMMPS_BINARIES = ("lmp", "lmp_mpi", "lmp_serial")


def find_lammps():
    """Path of an external LAMMPS binary on PATH, or None."""
    for name in _LAMMPS_BINARIES:
        path = shutil.which(name)
        if path:
            return path
    return None


def run_lammps(fname, nworker=1):
    """Run an external LAMMPS binary on ``fname``.

    This is the execution side of the ``engine: lammps`` escape hatch
    (moltemplate-generated decks): one LAMMPS world of ``nworker`` MPI
    ranks when ``mpirun`` is available (the reference's cooperative
    decomposition, GaPFlow/md/runner.py:50-65), else a serial run.
    """
    lmp = find_lammps()
    if lmp is None:
        raise RuntimeError(
            "engine: lammps requires an external LAMMPS binary "
            f"({'/'.join(_LAMMPS_BINARIES)}) on PATH; none found. "
            "Use engine: native for the bundled nanomd engine.")

    mpirun = shutil.which("mpirun") or shutil.which("mpiexec")
    if int(nworker) > 1 and mpirun:
        cmd = [mpirun, "-np", str(int(nworker)), lmp, "-in", fname]
    else:
        cmd = [lmp, "-in", fname]
    subprocess.run(cmd, check=True)


def run_parallel(fname, nworker):
    """Run ONE simulation on ``nworker`` OpenMP threads.

    Reference analogue: GaPFlow/md/runner.py:50-65 spawns an MPI world of
    ``nworker`` ranks cooperating on one simulation.  The native engine's
    cooperative axis is threads, so this delegates to :func:`run_serial`
    with ``nthreads=nworker`` — exactly one set of output files is written.
    """
    run_serial(fname, nthreads=max(int(nworker), 1))


def run_serial(fname, nthreads=1):
    """Run the native engine in-process on the given input deck.

    The native engine's binding (``md/_engine.py``) is not ported yet
    (ROADMAP queue 1, item 10); only the mock oracle runs."""
    raise NotImplementedError(
        "the native MD engine is not ported to gapflow_torch yet (ROADMAP "
        "queue 1, item 10); use the mock oracle (no md: section)")


def run_subprocess(fname, nworker=1):
    """Run the engine in a child process (isolation without MPI)."""
    code = ("from gapflow_torch.md.runner import run_serial; "
            f"run_serial({fname!r}, nthreads={nworker})")
    subprocess.run([sys.executable, "-c", code], check=True)
