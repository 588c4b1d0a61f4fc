"""The per-test time limit of the repo's root conftest.py ends a test hung
in C, and under `--dist loadfile` the rest of its file still runs."""

import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"

HUNG_FILE = """
import threading


def test_quick_before():
    pass


def test_hang():
    lock = threading.Lock()
    lock.acquire()
    lock.acquire()


def test_quick_after():
    pass
"""


def test_limit_ends_hung_test_once(tmp_path):
    text, n = re.subn(r"^LIMIT = \d+$", "LIMIT = 3", CONFTEST.read_text(),
                      flags=re.M)
    assert n == 1
    (tmp_path / "conftest.py").write_text(text)
    (tmp_path / "test_hung.py").write_text(HUNG_FILE)
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    junit = tmp_path / "junit.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["TMPDIR"] = str(tmp_path)

    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "2", "--dist", "loadfile",
         f"--junitxml={junit}", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    wall = time.monotonic() - t0
    out = run.stdout + run.stderr

    assert wall < 60, out
    assert "Thread 0x" in out, out
    assert out.count("node down") == 1, out
    outcomes = {}
    for case in ET.parse(junit).iter("testcase"):
        bad = [c.tag for c in case if c.tag in ("failure", "error")]
        outcomes.setdefault(case.get("name"), []).append(
            bad[0] if bad else "passed")
    assert outcomes["test_quick_before"] == ["passed"], outcomes
    assert outcomes["test_quick_after"] == ["passed"], outcomes
    assert 1 <= len(outcomes["test_hang"]) <= 2, outcomes
    assert "passed" not in outcomes["test_hang"], outcomes
