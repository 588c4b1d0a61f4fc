"""Whether torch.profiler keeps a short region's kernels as a process
ages (not a test; needs nvcc and a CUDA device).

    python tests/profiler_drift.py [--minutes 8] [--pad 0.5]

torch.profiler keeps only the device events whose times, converted to
the host's clock, fall inside its capture window.  This script keeps the
card busy with 1024² ``gp_step`` calls (the perturbed journal and the
synthetic surrogates of ``tests/gp_step_bench.py``) and about once a
minute profiles five steps (20 kernels) twice: as they are, and between
``--pad`` seconds of idle host time on each side.  Each line gives the
process's age, the kernels the profile kept, and the first kernel's
start less the first launch's, in microseconds.
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ["GAPFLOW_X64"] = "0"
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=8.)
    ap.add_argument("--pad", type=float, default=0.5)
    args = ap.parse_args()
    t0 = time.time()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profiler_drift: no CUDA device")
    import gp_step_bench as B
    from gapflow_torch.ops import _build
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import gp_kernel_inputs
    print(f"card: {B.smi()}")
    _build.load()
    p = B.problem(tempfile.mkdtemp(prefix="profiler_drift_"), 1024,
                  "periodic")
    cfg = p._solver_cfg
    q, st, dt, ops, _ = gp_kernel_inputs(p, B.CAP, db_scales=True)

    def step():
        G.gp_step(q, st, dt, cfg, ops, need_p=False)

    def session(pad, reps=5):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
            time.sleep(pad)
        ev = prof.events()
        kern = [e for e in ev if "gp_" in e.name and "kernel" in e.name]
        launch = [e for e in ev if e.name == "cudaLaunchKernel"]
        off = (min(e.time_range.start for e in kern)
               - min(e.time_range.start for e in launch)
               if kern and launch else None)
        want = reps * G.kernel_launches(ops)
        print(f"age {time.time() - t0:7.1f} s, pad {pad} s: kept "
              f"{len(kern)}/{want} kernels, first kernel - first launch "
              f"{off} us", flush=True)

    session(0.)
    session(args.pad)
    while time.time() - t0 < args.minutes * 60:
        t = time.time()
        while time.time() - t < 55:
            for _ in range(200):
                step()
            torch.cuda.synchronize()
        session(0.)
        session(args.pad)


if __name__ == "__main__":
    main()
