"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port; names are compared whole
(``gapflow_torch`` begins with ``gapflow_t``)."""

import json
import subprocess
import sys

import cellkit
import harness


def loaded_after(code):
    prog = (f"import sys; sys.path[:0] = [{str(cellkit.BENCH)!r}, "
            f"{str(cellkit.REPO)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["gapflow_torch", "gapflow_torch.ops", "jaxtyping", "flax_x"]) == []
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "gapflow_tpu.core", "flax", "jaxlib.xla"]) == \
        ["flax", "gapflow_tpu.core", "jax", "jax.numpy", "jaxlib.xla"]


def test_benchmark_loads_no_jax():
    mods = loaded_after(
        "import harness, check, control, devtrace, inputs, run\n"
        "import gapflow_torch.problem\n"
        "import json\n"
        "spec = json.load(open(harness.ROOT / 'BENCHMARK.json'))\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.reader(m['name'])")
    assert "gapflow_torch" in mods
    assert harness.forbidden_modules(mods) == []


def test_reference_loads_nothing_of_the_port():
    mods = loaded_after("import check, inputs, reference.fv")
    assert not [m for m in mods if m.split(".")[0] in
                ("gapflow_torch", "jax", "jaxlib", "flax", "gapflow_tpu")]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(cellkit.BENCH / "run.py"), "--workload",
         "journal-dh.n2048", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=cellkit.REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
