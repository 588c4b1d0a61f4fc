"""The whole command on the card at a small size, untraced and traced
(needs a CUDA device and nvcc; skipped without a card)."""

import json
import subprocess
import sys

import pytest

import cellkit


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_on_the_card(tmp_path, card, trace):
    root = cellkit.make_root(tmp_path, n=256, check_chunks=2)
    (root / "gapflow_torch").symlink_to(cellkit.REPO / "gapflow_torch")
    out = subprocess.run(
        [sys.executable, str(root / "benchmark" / "run.py"), "--workload",
         "journal-dh.t256", "--seed", "3", "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, cwd=root,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["final_err"]["value"] == 0.
    if trace:
        assert set(res["metrics"]) == {
            "problem_init_s", "driver_gap_ms_per_chunk", "chunk_ms",
            "finish_s", "sweep_us_per_step", "sweep_roofline",
            "device_idle_share"}
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["sweep_roofline"]["value"] < 100
    else:
        assert set(res["metrics"]) == {"cell_updates_per_s", "setup_s"}
