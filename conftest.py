"""Settings for every test run from this directory: the test processes'
environment, and a time limit on each test.

pytest loads this file before `tests/conftest.py`, which builds the
virtual 8-device CPU mesh.
"""

import faulthandler
import hashlib
import os
import sys
import tempfile

import pytest

# The packages read GAPFLOW_X64 unset as "1" (float64). `bench.py` sets it
# to "0" with setdefault when imported (`tests/test_bench_protocol.py` does
# so); set here first, that has no effect, so a test's dtype, and that of
# the subprocesses it starts, does not depend on which files its process
# collected before it. Tests that want float32 set it themselves.
os.environ.setdefault("GAPFLOW_X64", "1")

# XLA's CPU client runs device programs on a pool of PJRT_NPROC threads
# (the process's cores when unset, at least one per device). Interpret-mode
# Pallas on a mesh parks one pool thread per device at a threading.Barrier
# (jax `interpret_pallas_call._barrier`) while the other devices' callbacks
# wait for a free pool thread to read their operands: with no more threads
# than the 8 virtual devices of tests/conftest.py, that deadlocks. Eight
# threads over the cores leave one for each device.
os.environ.setdefault("PJRT_NPROC", str(len(os.sched_getaffinity(0)) + 8))

# Seconds a test may take, setup and teardown included: about 3x the
# slowest test measured (191 s, test_multiscale_e2e's native MD oracle
# under 6 xdist workers). A test past it dumps every thread's stack and
# ends its process: a test hung in C (a deadlocked barrier) never returns
# to Python, so no signal handler or exception could end it.
LIMIT = 600
_STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    # pytest captures fd 2 while a test runs, and that capture dies with
    # the process: dump to a copy of the stderr the session started with
    config.stash[_STDERR] = os.dup(sys.stderr.fileno())


def _mark(item):
    """Path of the file that says `item` has started in this xdist run,
    or None outside xdist.

    When a worker dies, xdist hands its file's unfinished tests, the one
    that killed it included, to a new worker. The mark makes that rerun
    fail at once, so that the rest of the file runs.
    """
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return None
    where = os.path.join(tempfile.gettempdir(), "gapflow-pytest-" + run)
    os.makedirs(where, exist_ok=True)
    return os.path.join(where, hashlib.md5(item.nodeid.encode()).hexdigest())


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    mark = _mark(item)
    if mark is None:
        return
    if os.path.exists(mark):
        pytest.fail(f"ended its xdist worker in an earlier try (ran past "
                    f"{LIMIT} s, or crashed); see that worker's stack dump",
                    pytrace=False)
    open(mark, "w").close()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    faulthandler.dump_traceback_later(LIMIT, exit=True,
                                      file=item.config.stash[_STDERR])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    mark = _mark(item)
    if mark is not None and os.path.exists(mark):
        os.remove(mark)
