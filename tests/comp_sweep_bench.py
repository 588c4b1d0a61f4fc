"""The temporally blocked sweeps on the card: the compensated K2c/K3c and
the plain K2p/Ke/K3p (not a test; needs nvcc and a CUDA device).

    python tests/comp_sweep_bench.py [--root DIR] [--save FILE] [--sass]
        [--only plain|comp|sass]
    python tests/comp_sweep_bench.py --compare FILE_A FILE_B
    python tests/comp_sweep_bench.py --variant NAME DIR

Imports ``gapflow_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout), so that one script times two trees (unpack the other
with ``git archive``) on the same card in turns: parent, change, change,
parent.  Prints:

- the card's name and power limit, and ``ptxas``'s report (registers,
  stack frame, spills, shared memory) for every instance of the sweep
  kernels (the compensated ``comp_sweep_kernel``, the plain
  ``sweep_kernel``; in an older tree the shared-memory
  ``multi_step_kernel``) and the one-step kernels;
- with ``--sass``, the SASS of the plain sweep body (whichever the tree
  has) compiled for each phase-5 input's models (the journal: DH, no
  piezoviscosity; the slider: PL; the Eyring asperity: BWR and Eyring
  thinning), those switches fixed at compile time so that each loop
  holds the path that runs: every innermost loop's instructions per
  class (FP32, MUFU, LDS/STS, SHFL, LDG/STG, BAR, branch, integer and
  other; ``gp_step_bench.sass_report``);
- at 1024², on the inputs of ``chip_smoke.py`` phase 5 (the journal,
  the inclined slider, the Eyring asperity; perturbed by 0.01, seed 0),
  and at 2048² on the journal, the asperity without thinning (the
  benchmark cells' BWR contact), the slider and the Eyring asperity:
  events around one ``comp_steps`` /
  ``comp_steps_bc`` call of 1024 steps, the tree's compensated route,
  per step, and (in a tree with the sweeps' C entries) the same at every
  sweep depth k; and around 256 launches of the one-step compensated
  kernel, per step;
- whether ``comp_steps`` over 2 KMAX + 1 steps (KMAX = ``_k_steps``, 4
  or 2 with thinning, the same in every tree) from a nonzero carry
  equals as many launches of the one-step kernel bit for bit, ``q`` and
  ``q_lo``;
- the plain route at 1024² on the same inputs: whether ``_plain_loop``
  over 2 KMAX + 1 steps equals as many launches of K1 or K3 bit for bit;
  events around one ``_plain_loop`` call of 1024 steps (the tree's plain
  route: sweeps, and in a tree without the one-call route a Python loop
  of them), per step, with its launches; each sweep depth k alone
  (``plain_steps`` / ``plain_steps_bc``, per step); in a tree with the
  C sweep entries, a whole call at every depth;
- ``chip_smoke.py`` phase 3o's run, ``run_steps_fast(5000,
  compensated=False)`` on the journal at 512² (Kv), 1024² and 2048² (a
  warm-up and
  the median of 3): cell-updates/s, and the device-busy share, the
  plain route's events time for the same steps over the host wall;
- ``Problem.run()`` on the configurations of ``chip_smoke.py`` phases 3,
  3b, 3c and 3k, and on ``examples/config/journal_1d_dowson-higginson.yaml``
  made silent (the README's 1D example, 100 x 1 cells, adaptive dt, on
  the compensated route; phase "1d"), a warm-up run each, then the timed
  run: wall, steps, launches.

``--only plain`` skips the compensated sweeps and the ``Problem.run()``
walls; ``--only comp`` times the compensated sweeps alone (no plain
route, no runs); ``--only sass`` stops after the ``ptxas`` and SASS
reports.  ``--save`` writes those runs' final states and the sweeps'
outputs to FILE; ``--compare`` prints, per output, whether two such
files hold the same values bit for bit.  ``--variant NAME DIR`` writes a
copy of the tree (``gapflow_torch``, ``chip_smoke.py``) into DIR whose
register sweeps (plain and compensated) take another tile, to be timed
with ``--root DIR``: ``r4w8`` and ``r4w16``, threads that own 4 window
rows in blocks of 8 or 16 warps (in place of 2 rows and 16 warps), the
second compiled for one block a SM; ``b1``, the sweeps compiled for one
block a SM (128 registers a thread, in place of two blocks and 64).
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
N_CELL = 2048            # the benchmark cells' grid
SWEEP_STEPS = 1024       # one chunk of run_compiled_fast
ONCE_STEPS = 256
FV_STEPS = 5000          # chip_smoke.py phase 3o


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
            elif name and re.search("multi_step|sweep_kernel|comp_step|"
                                    "bc_step|fused_step", name) \
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


# the lines of csrc/ each variant rewrites: (file, old, new)
VARIANTS = {
    "r4w8": (("stencil_sweep.cuh", "int R = 2;", "int R = 4;"),
             ("stencil_sweep.cuh", "int WARPS = 16;", "int WARPS = 8;")),
    "r4w16": (("stencil_sweep.cuh", "int R = 2;", "int R = 4;"),
              ("stencil_sweep.cuh", "int MIN_BLOCKS = 2;",
               "int MIN_BLOCKS = 1;")),
    "b1": (("stencil_sweep.cuh", "int MIN_BLOCKS = 2;",
            "int MIN_BLOCKS = 1;"),),
}

# the model switches each SASS probe fixes: EOS, piezoviscosity, thinning
# (stencil_common.cuh's codes), the source holding the plain sweep, and
# the mangled template arguments of the instance it runs:
# multi_step_kernel<BC, THIN, COMP = false> in a tree with the
# shared-memory body, sweep_kernel<BC, PX, PY, THIN> in one with the
# register body
PROBES = {"journal": (0, 0, 0, "stencil_plain.cu", "ILb0ELb0ELb0EE",
                      "ILb0ELb1ELb1ELb0EE"),
          "inclined slider": (1, 0, 0, "stencil_bc.cu", "ILb1ELb0ELb0EE",
                              "ILb1ELb0ELb1ELb0EE"),
          "asperity Eyring": (5, 0, 1, "stencil_bc.cu", "ILb1ELb1ELb0EE",
                              "ILb1ELb0ELb0ELb1EE")}


def tile_variant(name, dest):
    """Copy the tree into ``dest`` with the sweeps' tile of variant
    ``name``."""
    dest = Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(HERE / "gapflow_torch", dest / "gapflow_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dest / "chip_smoke.py")
    for src, old, new in VARIANTS[name]:
        geo = dest / "gapflow_torch" / "csrc" / src
        text = geo.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"tile variant: {old!r} not found once")
        geo.write_text(text.replace(old, new))
    print(f"tile variant {name} written to {dest}")


def sass_probes(root, build):
    """Compile the tree's plain sweep sources with each PROBES entry's
    model switches fixed and print the sweep body's loops per class."""
    import tempfile
    sys.path.insert(0, str(HERE / "tests"))
    from gp_step_bench import sass_report
    tmp = Path(tempfile.mkdtemp(prefix="sweep_sass_"))
    csrc = tmp / "csrc"
    shutil.copytree(Path(root) / "gapflow_torch" / "csrc", csrc)
    common = csrc / "stencil_common.cuh"
    text = common.read_text()
    for old, new in (("switch (P.eos) {", "switch (GF_PROBE_EOS) {"),
                     ("switch (P.piezo) {", "switch (GF_PROBE_PIEZO) {"),
                     ("if (T.model == 1) {", "if (GF_PROBE_THIN == 1) {")):
        if text.count(old) != 1:
            raise SystemExit(f"sass probe: {old!r} not found once")
        text = text.replace(old, new)
    common.write_text(text)
    nvcc = build.find_nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    procs = {}
    for label, (eos, piezo, thin, src, multi, sweep) in PROBES.items():
        cubin = tmp / f"{label.replace(' ', '_')}.cubin"
        procs[label] = (cubin, (multi, sweep), subprocess.Popen(
            [nvcc, *flags, "-cubin", "-o", str(cubin),
             f"-DGF_PROBE_EOS={eos}", f"-DGF_PROBE_PIEZO={piezo}",
             f"-DGF_PROBE_THIN={thin}", str(csrc / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for label, (cubin, (multi, sweep), proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"sass probe {label}: nvcc failed\n{out}")
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                print(f"sass probe {label} ptxas: "
                      + line.split("ptxas info    : ")[-1].strip())
        print(f"sass probe {label}:")
        sass_report(cubin, select=lambda n: (
            f"multi_step_kernel{multi}" in n or f"sweep_kernel{sweep}" in n),
            loop=lambda body: len(body) >= 16, classes=True)
    shutil.rmtree(tmp, ignore_errors=True)


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


def plain_route(S, CS, label, q, st, dt, cfg, bc, saved):
    """The plain route on one input: bit equality of 2 KMAX + 1 steps with
    K1 or K3 launched once per step, the route's time per step over 1024
    steps with its launches, and each sweep depth alone.  Returns the
    route's ms per step."""
    import torch
    once = S.fused_step_bc if bc else S.fused_step
    one_sweep = S.plain_steps_bc if bc else S.plain_steps
    kmax = S._k_steps(cfg)
    n = 2 * kmax + 1
    ref = q
    for _ in range(n):
        ref = once(ref, st, dt, cfg)
    CS.reset_all()
    out = S._plain_loop(cfg, q, st, dt, n)
    torch.cuda.synchronize()
    print(f"equal {label} plain route n={n} ({CS.launched()}) vs {n} "
          f"one-step launches: {torch.equal(out, ref)} (max abs "
          f"{float((out - ref).abs().max()):.3e})")
    saved[f"{label} plain n={n}"] = out
    CS.reset_all()
    S._plain_loop(cfg, q, st, dt, SWEEP_STEPS)
    torch.cuda.synchronize()
    launches = CS.launched()
    ms = time_ms(lambda: S._plain_loop(cfg, q, st, dt, SWEEP_STEPS), 3) \
        / SWEEP_STEPS
    print(f"time {label} plain route: {ms:.4f} ms/step ({SWEEP_STEPS} "
          f"steps a call, launches {launches})")
    for k in range(1, kmax + 1):
        one = time_ms(lambda: one_sweep(q, st, dt, cfg, k), 50) / k
        line = f"time {label} plain sweep of k = {k}: {one:.4f} ms/step"
        if hasattr(S, "_plain_sweeps"):
            whole = time_ms(lambda: S._plain_sweeps(q, st, dt, cfg,
                                                    SWEEP_STEPS, k), 3)
            line += f", whole call {whole / SWEEP_STEPS:.4f} ms/step"
        print(line)
    return ms


def fv_runs(S, CS):
    """chip_smoke.py phase 3o's plain run at 512² (Kv), 1024² and 2048²: a
    warm-up, then the median of 3 walls of run_steps_fast(FV_STEPS,
    compensated=False); cell-updates/s and the device-busy share."""
    import torch
    for n in (512, 1024, 2048):
        p = CS.journal(n, n, dt=1e-11)
        p._pre_run()
        cfg = p._solver_cfg
        q, st, dt = CS.kernel_inputs(p, amp=0.)
        kernel = time_ms(lambda: S._plain_loop(cfg, q, st, dt, SWEEP_STEPS),
                         2) / SWEEP_STEPS
        p.run_steps_fast(FV_STEPS, compensated=False)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            p.run_steps_fast(FV_STEPS, compensated=False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        print(f"3o {n}x{n}: walls {', '.join(f'{w:.4f}' for w in walls)} s, "
              f"{n * n * FV_STEPS / wall:.4e} cell-updates/s, route "
              f"{kernel:.4f} ms/step, device busy "
              f"{kernel * FV_STEPS / 1e3 / wall:.3f}")


def example_1d():
    """The README's 1D example configuration, made silent."""
    import yaml
    cfg = yaml.safe_load((HERE / "examples" / "config"
                          / "journal_1d_dowson-higginson.yaml").read_text())
    cfg["options"]["silent"] = True
    return yaml.safe_dump(cfg)


def asperity_bwr_yaml(CS, n):
    """``chip_smoke.py``'s asperity without its Eyring thinning: the BWR
    contact on four D/N edges of the benchmark cell ``asperity-bwr``."""
    text, hits = re.subn(r",\s*thinning: \{[^}]*\}", "",
                         CS.asperity_yaml(n, CS.MAX_IT))
    if hits != 1:
        raise SystemExit("asperity_bwr_yaml: no thinning section found")
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--variant", nargs=2, metavar=("NAME", "DIR"))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only", choices=("plain", "comp", "sass"))
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
    if args.sass:
        sass_probes(args.root, _build)
    if args.only == "sass":
        return
    saved = {}

    for label, make, bc in (
            ("journal", lambda: CS.journal(N, N, dt=1e-11), False),
            ("inclined slider", lambda: CS.problem(CS.inclined_yaml(
                N, CS.MAX_IT)), True),
            ("asperity Eyring", lambda: CS.problem(CS.asperity_yaml(
                N, CS.MAX_IT)), True)):
        p = make()
        q, st, dt = CS.kernel_inputs(p, amp=0.01, ghosted=bc)
        if args.only != "comp":
            plain_route(S, CS, label, q, st, dt, p._solver_cfg, bc, saved)
        if args.only != "plain":
            sweeps_and_witness(S, label, q, st, dt, p._solver_cfg, bc,
                               saved)
    for label, make, bc in (() if args.only == "plain" else (
            (f"journal {N_CELL}", lambda: CS.journal(N_CELL, N_CELL,
                                                     dt=1e-11), False),
            (f"asperity BWR {N_CELL}", lambda: CS.problem(
                asperity_bwr_yaml(CS, N_CELL)), True),
            (f"inclined slider {N_CELL}", lambda: CS.problem(
                CS.inclined_yaml(N_CELL, CS.MAX_IT)), True),
            (f"asperity Eyring {N_CELL}", lambda: CS.problem(
                CS.asperity_yaml(N_CELL, CS.MAX_IT)), True))):
        p = make()
        q, st, dt = CS.kernel_inputs(p, amp=0.01, ghosted=bc)
        sweeps_and_witness(S, label, q, st, dt, p._solver_cfg, bc, saved)
        del p, q, st
    if args.only != "comp":
        fv_runs(S, CS)

    for phase, make in (() if args.only in ("plain", "comp") else (
            ("3", lambda: CS.journal(N, N, dt=1e-11, max_it=CS.MAX_IT)),
            ("3b", lambda: CS.problem(CS.inclined_yaml(N, CS.MAX_IT))),
            ("3c", lambda: CS.problem(CS.asperity_yaml(N, 1026))),
            ("3k", lambda: CS.ehl_journal(N, max_it=CS.EHL_RUN_IT)),
            ("1d", lambda: CS.problem(example_1d())))):
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
