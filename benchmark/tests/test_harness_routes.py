"""A cell of another route is added as files and entries alone, and a run
that does not take its configuration's route is refused (CPU).

The added cell is the flagship rough EHL contact with GP surrogates
(``examples/config/asperity_2d_ehl_gp.yaml``) at 24 x 24 with active
learning off on both surrogates, so that ``Problem.run()`` takes the
frozen-surrogate route ``gp_fast``; its route file and a stub comparison
are the test's own (``tests/gp_fast/``)."""

import json
import shutil

import pytest
import yaml

import cellkit
import harness

GP_FAST = cellkit.BENCH / "tests" / "gp_fast"
EXAMPLE = cellkit.REPO / "examples" / "config" / "asperity_2d_ehl_gp.yaml"
SEED = 20231            # draws chunk 0 of 0-1: the warm-up chunk


def add_gp_cell(root, n=24):
    """Add to the scratch checkout ``root`` the configuration
    ``asperity-ehl-gp`` (route ``gp_fast``, the stub comparison), the
    traffic ``g<n>`` (the n2048 protocol at ``n x n``, a warm-up of 8
    steps, the check drawn from chunks 0-1) and the cell
    ``asperity-ehl-gp.g<n>``, as files and entries alone."""
    bench = root / "benchmark"
    src = yaml.safe_load(EXAMPLE.read_text())
    cfg = {k: src[k] for k in ("grid", "geometry", "numerics",
                               "properties", "gp", "db")}
    for key in ("Nx", "Ny"):
        del cfg["grid"][key]
    del cfg["numerics"]["max_it"]
    for surrogate in cfg["gp"].values():
        surrogate["active_learning"] = False
    cfg.update(reference="benchmark/reference/stub.py", route="gp_fast")
    (bench / "configs" / "asperity-ehl-gp.json").write_text(json.dumps(cfg))
    shutil.copy(GP_FAST / "route.py", bench / "routes" / "gp_fast.py")
    shutil.copy(GP_FAST / "stub_check.py",
                bench / "reference" / "stub_check.py")
    traffic = json.loads((bench / "traffic" / "n2048.json").read_text())
    traffic.update(Nx=n, Ny=n, warmup_steps=8, check_chunks=2)
    (bench / "traffic" / f"g{n}.json").write_text(json.dumps(traffic))
    cell = f"asperity-ehl-gp.g{n}"
    (bench / "limits" / f"{cell}.json").write_text(json.dumps({"limits": {
        "chunk_index": 1., "chunk_moved": 1., "final_err": 0.}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "asperity-ehl-gp", "source": str(EXAMPLE),
        "file": "benchmark/configs/asperity-ehl-gp.json", "reduced": [],
        "why": "rough EHL contact, frozen GP surrogates"})
    spec["workloads"].append({"name": cell, "config": "asperity-ehl-gp",
                              "traffic": f"g{n}", "chips": 1,
                              "why": "a tiny grid for the CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


def test_cell_of_another_route_added_as_files(tmp_path):
    root = cellkit.make_root(tmp_path)
    name = add_gp_cell(root)
    cell = harness.Cell(name, root)
    assert harness.draw_chunk(SEED, cell.traffic) == 0
    # the kernels' metrics read only the cells of run_compiled_fast
    assert "sweep_roofline" not in [m["name"] for m in cell.per_layer]
    assert "chunk_ms" in [m["name"] for m in cell.per_layer]

    res = harness.run_cell(name, SEED, 0.5, 0, device="cpu", root=root)
    counters = res["counters"]
    # the route's chunks counted: 512 steps each in the window
    assert counters["chunks"] >= 1 and res["attempted"] == counters["chunks"]
    assert counters["steps"] == 512 * counters["chunks"]
    assert res["failed"] == 0
    assert res["metrics"]["cell_updates_per_s"]["value"] > 0
    # the stub's names, in the limits' order; the kept chunk is the drawn
    # one (the warm-up, not the run's last), and it moved the state
    assert list(res["checks"]) == ["chunk_index", "chunk_moved",
                                   "final_err"]
    assert res["checks"]["chunk_index"]["value"] == 0.
    assert 0. < res["checks"]["chunk_moved"]["value"] < 1.
    assert res["checks"]["final_err"]["value"] == 0.
    assert res["correct"] is True
    json.dumps(res)


@pytest.mark.parametrize("case", ["other route file", "cpu route"])
def test_run_off_its_route_is_refused(tmp_path, monkeypatch, case):
    """The tiny journal takes ``run_compiled_fast``, which its
    configuration does not name (``gp_fast``); or, without the CPU
    twins behind that route, it takes ``run_compiled``."""
    import gapflow_torch.problem as gp_problem
    root = cellkit.make_root(tmp_path)
    if case == "other route file":
        add_gp_cell(root)
        cellkit.cpu_route(monkeypatch)
        conf = root / "benchmark" / "configs" / "journal-dh.json"
        conf.write_text(json.dumps(dict(json.loads(conf.read_text()),
                                        route="gp_fast")))
    took = "run_compiled_fast" if case == "other route file" \
        else "run_compiled"
    real = (gp_problem.make_pallas_loop, gp_problem.make_gp_ehl_loop)
    with pytest.raises(RuntimeError, match=f"the route '{took}', not"):
        harness.run_cell("journal-dh.t32", 5, 0.5, 0, device="cpu",
                         root=root)
    # the route's observation is taken away again
    assert (gp_problem.make_pallas_loop, gp_problem.make_gp_ehl_loop) == \
        real


def test_verdict_holds_the_names_the_limits_list():
    import check
    limits = {"b": 1., "a": 0.}
    ok, checks = check.verdict({"a": 0., "b": 0.5}, limits)
    assert ok and list(checks) == ["b", "a"]
    # a number the comparison did not give is no pass
    ok, checks = check.verdict({"b": 0.5}, limits)
    assert not ok and checks["a"]["value"] != checks["a"]["value"]
    # a number without a limit is an error of the cell's files
    with pytest.raises(KeyError, match="no limit for c"):
        check.verdict({"a": 0., "b": 0., "c": 0.}, limits)
