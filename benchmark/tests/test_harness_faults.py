"""The check fails a run whose timed path is broken underneath, and the
control (the reference in bfloat16 in the program's place) fails it too
(CPU, tiny grid; the chip readings are in PERF.md)."""

import pytest
import torch

import cellkit
import check
import control
import harness


def broken_loops(kind):
    """The run loop's factory with one fault planted in every chunk."""
    import gapflow_torch.problem as gp_problem
    real = gp_problem.make_pallas_loop

    def make(*args, **kwargs):
        loop = real(*args, **kwargs)

        def chunk(q, topo, extra, dt, n, *rest):
            out = loop(q, topo, extra, dt, n, *rest)
            if kind == "unchanged":         # the state returned as it was
                return q.clone()
            out = out.clone()
            if kind == "half":              # half the grid left out
                half = out.shape[1] // 2
                out[:, :half] = q[:, :half]
            elif kind == "altered":         # one answer altered
                out[0, 5, 5] += (out[0] - q[0]).abs().max()
            return out

        return chunk

    return make


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, kind):
    import gapflow_torch.problem as gp_problem
    root = cellkit.make_root(tmp_path)
    cellkit.cpu_route(monkeypatch)
    monkeypatch.setattr(gp_problem, "make_pallas_loop", broken_loops(kind))
    res = harness.run_cell("journal-dh.t32", 7, 0.5, 0, device="cpu",
                           root=root)
    assert res["correct"] is False
    assert res["checks"]["chunk_err"]["value"] >= 0.5


@pytest.mark.parametrize("config", ["journal-dh", "asperity-bwr"])
def test_bf16_control_is_not_correct(tmp_path, config):
    root = cellkit.make_root(tmp_path)
    cell = harness.Cell(f"{config}.t32", root)
    cfg_run, rho0, prog = control.reference_prog(cell, 11, "cpu",
                                                  torch.bfloat16)
    values = check.numbers(cfg_run, cell.traffic, rho0, prog)
    correct, checks = check.verdict(values, cell.limits)
    assert correct is False
    assert values["start_err"] > 1e-3
