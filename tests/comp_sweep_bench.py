"""The compensated sweeps K2c/K3c on the card (not a test; needs nvcc and a
CUDA device).

    python tests/comp_sweep_bench.py [--root DIR] [--save FILE]
    python tests/comp_sweep_bench.py --compare FILE_A FILE_B
    python tests/comp_sweep_bench.py --variant NAME DIR

Imports ``gapflow_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout), so that one script times two trees (unpack the other
with ``git archive``) on the same card in turns: parent, change, change,
parent.  Prints:

- the card's name and power limit, and ``ptxas``'s report (registers,
  stack frame, spills, shared memory) for every instance of the k-step
  body (``multi_step_kernel<BC, THIN, COMP>``) and the one-step
  compensated kernels;
- at 1024², on the inputs of ``chip_smoke.py`` phase 5 (the journal,
  the inclined slider, the Eyring asperity; perturbed by 0.01, seed 0):
  events around one ``comp_steps`` / ``comp_steps_bc`` call of 1024
  steps, the tree's compensated route, per step, and (in a tree with
  the sweeps' C entries) the same at every sweep depth k; and around 256
  launches of the one-step compensated kernel, per step;
- whether ``comp_steps`` over 2 KMAX + 1 steps (KMAX = ``_k_steps``, 4
  or 2 with thinning, the same in every tree) from a nonzero carry
  equals as many launches of the one-step kernel bit for bit, ``q`` and
  ``q_lo``;
- ``Problem.run()`` on the configurations of ``chip_smoke.py`` phases 3,
  3b, 3c and 3k, and on ``examples/config/journal_1d_dowson-higginson.yaml``
  made silent (the README's 1D example, 100 x 1 cells, adaptive dt, on
  the compensated route; phase "1d"), a warm-up run each, then the timed
  run: wall, steps, launches.

``--save`` writes those runs' final states and the sweeps' outputs to
FILE; ``--compare`` prints, per output, whether two such files hold the
same values bit for bit.  ``--variant NAME DIR`` writes a copy of the
tree (``gapflow_torch``, ``chip_smoke.py``) into DIR whose compensated
sweeps take another tile, to be timed with ``--root DIR``: ``comp16``,
16 x 32 tiles on 256 threads (in place of 32 x 32 on 512), with and
without thinning.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

os.environ["GAPFLOW_X64"] = "0"
HERE = Path(__file__).resolve().parents[1]

N = 1024
SWEEP_STEPS = 1024       # one chunk of run_compiled_fast
ONCE_STEPS = 256


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def ptxas_report(build):
    log = build.library_path().with_suffix(".log")
    if not log.is_file():
        print("ptxas: no build log (library built earlier)")
        return
    for src in ("stencil.cu", "stencil_bc.cu", "stencil_plain.cu"):
        text = log.read_text().split(f"== {src}")[-1].split("\n== ")[0]
        name = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            elif name and re.search("multi_step|comp_step|bc_step", name) \
                    and ("stack frame" in line or "Used" in line):
                print(f"ptxas {src} {name}: "
                      + line.split("ptxas info    : ")[-1].strip())


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the MultiGeo lines each variant rewrites
VARIANTS = {
    "comp16": (("TX = THIN && !COMP ? 16 : 32;",
                "TX = THIN || COMP ? 16 : 32;"),
               ("THREADS = THIN && !COMP ? 256 : 512;",
                "THREADS = THIN || COMP ? 256 : 512;")),
}


def tile_variant(name, dest):
    """Copy the tree into ``dest`` with the compensated sweeps' tile of
    variant ``name``."""
    dest = Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(HERE / "gapflow_torch", dest / "gapflow_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dest / "chip_smoke.py")
    geo = dest / "gapflow_torch" / "csrc" / "stencil_multi.cuh"
    text = geo.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"tile variant: {old!r} not found once")
        text = text.replace(old, new)
    geo.write_text(text)
    print(f"tile variant {name} written to {dest}")


def sweeps_and_witness(S, label, q, st, dt, cfg, bc, saved):
    """Times the tree's compensated route and the one-step kernel; checks
    and saves 2 KMAX + 1 steps from a nonzero carry."""
    import torch
    steps = S.comp_steps_bc if bc else S.comp_steps
    once = getattr(S, "comp_step_bc_once" if bc else "comp_step_once", None)
    if once is None:        # a tree without sweeps: comp_steps is the loop
        def once(q, lo, st, dt, cfg):
            return steps(q, lo, st, dt, cfg, 1)
    k = getattr(S, "_comp_k_steps", S._k_steps)(cfg)
    g = torch.Generator(device=q.device).manual_seed(1)
    lo = (torch.rand(q.shape, generator=g, device=q.device) - 0.5) \
        * q.abs() * 2. ** -24
    n = 2 * S._k_steps(cfg) + 1
    qs, ls = steps(q, lo, st, dt, cfg, n)
    qo, lo1 = q, lo
    for _ in range(n):
        qo, lo1 = once(qo, lo1, st, dt, cfg)
    torch.cuda.synchronize()
    print(f"equal {label} comp_steps n={n} vs {n} one-step launches: q "
          f"{torch.equal(qs, qo)}, q_lo {torch.equal(ls, lo1)} (max abs "
          f"{float((qs - qo).abs().max()):.3e}, "
          f"{float((ls - lo1).abs().max()):.3e})")
    saved[f"{label} sweeps q"], saved[f"{label} sweeps q_lo"] = qs, ls
    ms = time_ms(lambda: steps(q, lo, st, dt, cfg, SWEEP_STEPS), 3) \
        / SWEEP_STEPS

    def loop():
        a, b = q, lo
        for _ in range(ONCE_STEPS):
            a, b = once(a, b, st, dt, cfg)
    once_ms = time_ms(loop, 2) / ONCE_STEPS
    print(f"time {label} (k = {k}): comp_steps {ms:.4f} ms/step, one-step "
          f"kernel {once_ms:.4f} ms/step")
    sweeps = getattr(S, "_comp_sweeps", None)
    if sweeps is not None:
        entry, key = (("gf_comp_sweeps_bc", "comp_sweep_bc") if bc
                      else ("gf_comp_sweeps", "comp_sweep"))
        extra = S._bc_params(cfg) if bc else ()
        for kk in range(1, S._k_steps(cfg) + 1):
            ms = time_ms(lambda: sweeps(entry, key, q, lo, st, dt, cfg,
                                        SWEEP_STEPS, kk, *extra), 3) \
                / SWEEP_STEPS
            print(f"time {label} sweeps of k = {kk}: {ms:.4f} ms/step")


def example_1d():
    """The README's 1D example configuration, made silent."""
    import yaml
    cfg = yaml.safe_load((HERE / "examples" / "config"
                          / "journal_1d_dowson-higginson.yaml").read_text())
    cfg["options"]["silent"] = True
    return yaml.safe_dump(cfg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--variant", nargs=2, metavar=("NAME", "DIR"))
    args = ap.parse_args()
    if args.variant:
        tile_variant(*args.variant)
        return
    import torch
    if args.compare:
        a, b = (torch.load(f) for f in args.compare)
        for k in a:
            same = k in b and torch.equal(a[k], b[k])
            err = float((a[k] - b[k]).abs().max()) if k in b else None
            print(f"compare {k}: {'bit for bit' if same else 'DIFFERENT'}"
                  f" (max abs diff {err})")
        return
    if not torch.cuda.is_available():
        raise SystemExit("comp_sweep_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as CS
    from gapflow_torch.ops import _build
    from gapflow_torch.ops import stencil as S
    print(f"card: {smi()}")
    print(f"tree: {args.root}")
    t0 = time.perf_counter()
    _build.load()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    ptxas_report(_build)
    saved = {}

    for label, make, bc in (
            ("journal", lambda: CS.journal(N, N, dt=1e-11), False),
            ("inclined slider", lambda: CS.problem(CS.inclined_yaml(
                N, CS.MAX_IT)), True),
            ("asperity Eyring", lambda: CS.problem(CS.asperity_yaml(
                N, CS.MAX_IT)), True)):
        p = make()
        q, st, dt = CS.kernel_inputs(p, amp=0.01, ghosted=bc)
        sweeps_and_witness(S, label, q, st, dt, p._solver_cfg, bc, saved)

    for phase, make in (
            ("3", lambda: CS.journal(N, N, dt=1e-11, max_it=CS.MAX_IT)),
            ("3b", lambda: CS.problem(CS.inclined_yaml(N, CS.MAX_IT))),
            ("3c", lambda: CS.problem(CS.asperity_yaml(N, 1026))),
            ("3k", lambda: CS.ehl_journal(N, max_it=CS.EHL_RUN_IT)),
            ("1d", lambda: CS.problem(example_1d()))):
        make().run()                                   # warm-up
        p = make()
        CS.reset_all()
        t0 = time.perf_counter()
        p.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"run {phase}: route {p._route}, steps {p.step}, wall "
              f"{wall:.4f} s, launches {CS.launched()}")
        saved[f"phase {phase} q"] = torch.as_tensor(p.q)

    if args.save:
        torch.save({k: v.cpu() for k, v in saved.items()}, args.save)
        print(f"saved {len(saved)} outputs to {args.save}")


if __name__ == "__main__":
    main()
