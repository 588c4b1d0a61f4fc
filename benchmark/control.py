"""The control of a cell's check, and the readings its limits are set
from (not part of a benchmark run).

    python benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--variant bf16|f32|chunks|plain|residual] [--seconds 4]

``bf16`` (the control): the reference put in the program's place and
computed in bfloat16, the precision below the float32 the port runs in:
its gap, initial state, time step, the warm-up chunk (chunk 0) from its
own start, the final state and pressure; ``f32``: the same in float32.
Each line is one seed's compared numbers as the benchmark computes them
against the float64 reference; the control must fail at least one.

``chunks``: the program, a run of ``--seconds`` through the harness,
every chunk the check can draw compared (the lower readings).
``plain``: the same, the drawn chunk, with ``Problem.run()``'s loop
built without the Kahan carry (``make_pallas_loop(compensated=False)``),
the step a later change could be tempted by (it reads as the program
does: in these cells no compared number tells the two apart).
``residual``: a run of ``--seconds``, ``end_residual`` from the output
of each chunk in ``--chunks`` (as a shorter or slower run would end),
with the program's loop as it is, or without the Kahan carry with
``--plain``.

Prints one JSON line per seed and chunk, and last the smallest reading
of each number.
"""

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import check  # noqa: E402
import harness  # noqa: E402
import inputs  # noqa: E402
from reference.fv import Solver, pressure  # noqa: E402


def reference_prog(cell, seed, device, dtype):
    """What the reference in ``dtype`` gives in the program's place."""
    cfg, traffic = cell.config, cell.traffic
    sections = inputs.sections(cfg, traffic, seed, "unused")
    cfg_run = dict(cfg, **{k: sections[k] for k in
                           ("grid", "geometry", "numerics")})
    rho0 = inputs.density(cfg, traffic, seed)
    low = Solver(cfg_run, traffic["Nx"], traffic["Ny"], dtype=dtype,
                 device=device)
    import torch
    topo = torch.stack([low.tensor(a) for a in low.gap()])
    low.set_gap(topo)
    q0 = low.tensor(low.initial_state(rho0))
    dt0 = low.dt(q0)
    q1 = low.run(q0, dt0, traffic["warmup_steps"])
    prog = {"topo": topo, "q0": q0, "dt0": dt0,
            "chunk": (0, q0, q1, dt0, traffic["warmup_steps"]),
            "final": q1, "last": q1,
            "pressure": pressure(q1[0], cfg["properties"])}
    return cfg_run, rho0, prog


def program_run(cell, seed, seconds, device, keep=(), plain=False):
    """A run of the program through the harness, keeping the chunks in
    ``keep`` (the drawn one without it); ``plain`` builds its loop
    without the Kahan carry.  Returns what :func:`harness.measure`
    does but the result line."""
    import gapflow_torch.problem as gp_problem
    real = gp_problem.make_pallas_loop

    def uncompensated(*a, **kw):
        return real(*a, **dict(kw, compensated=False))

    if plain:
        gp_problem.make_pallas_loop = uncompensated
    try:
        rec = harness.Recorder(harness.draw_chunk(seed, cell.traffic), keep)
        return harness.measure(cell, seed, seconds, 0, rec, device)[1:]
    finally:
        gp_problem.make_pallas_loop = real


def program_values(cell, seed, seconds, device, keep=(), plain=False):
    """The compared numbers of a run of the program for each chunk in
    ``keep`` (the drawn one without it)."""
    progs, cfg_run, rho0 = program_run(cell, seed, seconds, device, keep,
                                       plain)
    return {i: check.numbers(cfg_run, cell.traffic, rho0, prog,
                             device=device)
            for i, prog in sorted(progs.items())}


def residuals(cell, seed, seconds, device, chunks, plain=False):
    """``end_residual`` from the output of each chunk in ``chunks``, and
    of the run's end ("end")."""
    progs, cfg_run, _ = program_run(cell, seed, seconds, device, chunks,
                                    plain)
    ref = Solver(cfg_run, cell.traffic["Nx"], cell.traffic["Ny"],
                 device=device)
    ref.set_gap()
    steps = cell.traffic["residual_steps"]
    out = {i: check.residual(ref, prog["chunk"][2], steps)
           for i, prog in sorted(progs.items())}
    prog = next(iter(progs.values()))
    out["end"] = check.residual(ref, prog["final"], steps)
    return out


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", default="bf16", choices=(
        "bf16", "f32", "plain", "chunks", "residual"))
    ap.add_argument("--chunks", type=int, nargs="*", default=())
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--seconds", type=float, default=4.)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = harness.Cell(args.workload)
    low = {}
    for seed in args.seeds:
        if args.variant == "residual":
            print(json.dumps({"seed": seed, "plain": args.plain,
                              "end_residual": residuals(
                                  cell, seed, args.seconds, args.device,
                                  args.chunks, args.plain)}), flush=True)
            continue
        if args.variant in ("bf16", "f32"):
            dtype = {"bf16": torch.bfloat16, "f32": torch.float32}
            cfg_run, rho0, prog = reference_prog(cell, seed, args.device,
                                                 dtype[args.variant])
            runs = {0: check.numbers(cfg_run, cell.traffic, rho0, prog,
                                     device=args.device)}
        else:
            keep = range(cell.traffic["check_chunks"]) \
                if args.variant == "chunks" else ()
            runs = program_values(cell, seed, args.seconds, args.device,
                                  keep, plain=args.variant == "plain")
        for index, values in runs.items():
            correct, _ = check.verdict(values, cell.limits)
            print(json.dumps({"seed": seed, "variant": args.variant,
                              "chunk": index, "correct": correct,
                              "values": values}), flush=True)
            for k, v in values.items():
                if not math.isnan(v):
                    low[k] = min(low.get(k, float("inf")), v)
    print(json.dumps({"variant": args.variant, "smallest": low}))


if __name__ == "__main__":
    main()
