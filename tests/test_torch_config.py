"""The port's framework-free layer agrees with the JAX package.

Every example YAML parses to the same sanitized dict in both packages, the
generated closures are the same file, and ``gapflow_torch`` imports with
``jax`` blocked.
"""

import glob
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gapflow_tpu.config import read_yaml_input as read_jax
from gapflow_torch.config import read_yaml_input as read_torch

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "examples" / "config" / "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_example_configs_parse_equal(path):
    with open(path) as fh:
        a = read_jax(fh)
    with open(path) as fh:
        b = read_torch(fh)
    assert a == b


def test_closures_are_the_jax_copy():
    a = (ROOT / "gapflow_tpu" / "models" / "_closures.py").read_bytes()
    b = (ROOT / "gapflow_torch" / "models" / "_closures.py").read_bytes()
    assert a == b


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gapflow_tpu'] = None; "
            "import gapflow_torch, gapflow_torch.ops.stencil, "
            "gapflow_torch.validate; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules if sys.modules[m] is not None)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_port_sources():
    for path in (ROOT / "gapflow_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or "gapflow_tpu" in s and s.startswith(
                            ("import", "from"))), f"{path}: {line}"
