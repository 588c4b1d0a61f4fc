"""A cell added as files alone runs through the harness (CPU, tiny grid,
the kernels' CPU twins behind the same route), and its result line has
the contract's keys."""

import json

import pytest

import cellkit
import check
import harness


def test_cell_added_as_files_is_listed(tmp_path):
    root = cellkit.make_root(tmp_path)
    cell = harness.Cell("journal-dh.t32", root)
    assert cell.traffic["Nx"] == 32 and cell.chips == 1
    assert [m["name"] for m in cell.end_to_end] == ["cell_updates_per_s",
                                                    "setup_s"]
    assert "sweep_roofline" in [m["name"] for m in cell.per_layer]
    with pytest.raises(KeyError):
        harness.Cell("journal-dh.t33", root)


@pytest.mark.parametrize("config", ["journal-dh", "asperity-bwr"])
def test_tiny_cell_runs_end_to_end(tmp_path, monkeypatch, config):
    root = cellkit.make_root(tmp_path)
    cellkit.cpu_route(monkeypatch)
    res = harness.run_cell(f"{config}.t32", 20231, 0.5, 0, device="cpu",
                           root=root)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert list(res["checks"]) == list(check.NAMES)
    assert set(res["metrics"]) == {"cell_updates_per_s", "setup_s"}
    assert res["metrics"]["cell_updates_per_s"]["value"] > 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["start_err"]["value"] < 1e-12
    assert res["checks"]["final_err"]["value"] == 0.
    assert res["checks"]["chunk_err"]["value"] < 0.5
    json.dumps(res)
