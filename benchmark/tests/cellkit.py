"""A scratch checkout holding the benchmark's files and a tiny cell added
as files only (a traffic file, a limits file, a workload entry), for the
CPU tests of the harness."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def make_root(tmp, n=32, check_chunks=1):
    """Copy ``BENCHMARK.json`` and ``benchmark/`` into ``tmp`` and add the
    traffic ``t<n>`` (the n2048 protocol on an ``n x (3n/4)`` grid) with
    one cell on it per configuration, ``<config>.t<n>``, whose limits are
    those of ``<config>.n2048``."""
    tmp = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((BENCH / "traffic" / "n2048.json").read_text())
    traffic.update(Nx=n, Ny=3 * n // 4, check_chunks=check_chunks)
    name = f"t{n}"
    (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(
        json.dumps(traffic))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    for conf in spec["configs"]:
        cell = f"{conf['name']}.{name}"
        spec["workloads"].append({"name": cell, "config": conf["name"],
                                  "traffic": name, "chips": 1,
                                  "why": "a tiny grid for the CPU tests"})
        shutil.copy(BENCH / "limits"
                    / f"{conf['name']}.n2048.json",
                    tmp / "benchmark" / "limits" / f"{cell}.json")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def cpu_route(monkeypatch):
    """Let a CPU Problem take ``run_compiled_fast`` (the kernels' CPU
    twins), the route the card takes."""
    from gapflow_torch.problem import Problem
    monkeypatch.setattr(Problem, "_fast_run_eligible", lambda self: True)
