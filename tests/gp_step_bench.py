"""The GP-closed step kernels K5/K6/K7 on the card (not a test; needs nvcc
and a CUDA device).

    python tests/gp_step_bench.py [--root DIR] [--save FILE] [--sass]
    python tests/gp_step_bench.py --compare FILE_A FILE_B

Imports ``gapflow_torch`` from ``--root`` (default: this checkout), so
that one script times two trees (unpack the other with ``git archive``)
on the same card in turns: parent, change, change, parent.  Prints:

- the card's name and power limit, and ``ptxas``'s report (registers,
  stack frame, spills, shared memory) for every kernel of
  ``csrc/stencil_gp.cu``;
- with ``--sass``, from ``cuobjdump -sass`` of the built library, per GP
  kernel the innermost loops that hold a ``MUFU`` (the training-point
  loops): their instructions, ``MUFU``, ``LDS`` and the local loads and
  stores (``LDL``/``STL``);
- at 1024² (a perturbed journal, synthetic surrogates of 64 points for
  the pressure and both wall stresses, scaled like the database's):
  events around whole wrapper calls, per step, of ``gp_step`` without
  and with the pressure, ``gp_step`` without surrogates (EOS pressure,
  analytic wall stresses), ``gp_step`` at 256 points, ``gp_step_bc`` on
  four D/N edges without and with the pressure, and ``gp_steps`` (20
  steps a call); K6 on the GP asperity of
  ``examples/config/asperity_2d_lj_gp.yaml`` at 1024² against its twin;
  on small grids, where launches weigh most, ``gp_step_bc`` with the
  pressure at 200 x 1 (D/N x edges) and 256² (four D/N edges) and
  ``gp_step`` without surrogates at 256 x 1;
- ``torch.profiler``'s device time per kernel name over one ``gp_step``
  at 1024² (where the profiler records none, it says so);
- at 128², for every edge layout, surrogate set and capacity of the GPU
  tests, whether each kernel equals its plain twin bit for bit (q, and
  the pressure).

``--save`` writes every kernel output of the run (its inputs are made
from fixed seeds) to FILE; ``--compare`` prints, per output, whether two
such files hold the same values bit for bit.
"""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

os.environ["GAPFLOW_X64"] = "0"
HERE = Path(__file__).resolve().parents[1]

N = 1024
CAP = 64
CHECK_N = 128
CHECK_CAPS = (16, 48, 128, 200)
GRIDS = ("periodic", "dn_x", "dn_all_asymmetric")


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def ptxas_report(build):
    log = build.library_path().with_suffix(".log")
    if not log.is_file():
        print("ptxas: no build log (library built earlier)")
        return
    text = log.read_text().split("== stencil_gp.cu")[-1].split("\n== ")[0]
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("stack frame" in line or "Used" in line):
            print(f"ptxas {name}: "
                  + line.split("ptxas info    : ")[-1].strip())


# instruction classes of a SASS count: opcode prefixes, first match wins
SASS_CLASSES = (
    ("MUFU", ("MUFU",)),
    ("FP32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET",
              "FCHK", "FRND", "FSWZADD")),
    ("LDS/STS", ("LDS", "STS")),
    ("SHFL", ("SHFL",)),
    ("LDG/STG", ("LDG", "STG", "LD.", "ST.")),
    ("LDL/STL", ("LDL", "STL")),
    ("BAR", ("BAR",)),
    ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BREAK",
                "WARPSYNC", "BMOV")),
)


def sass_class(text):
    """The class of one SASS instruction (predicate stripped): a
    SASS_CLASSES name, else "int/other" (integer, address, conversion,
    move, vote, predicate logic)."""
    op = text.split()[1] if text.startswith("@") else text.split()[0]
    for name, prefixes in SASS_CLASSES:
        if op.startswith(prefixes):
            return name
    return "int/other"


def sass_report(lib_path, select=lambda name: "gp" in name, loop=None,
                classes=False):
    """Innermost loops of each selected function in the SASS of
    ``lib_path`` (a shared library or a cubin): by default the GP kernels'
    loops that hold a MUFU (the training-point loops), with their
    instructions, MUFU, LDS and the local loads and stores; ``loop``
    selects loops by their instruction list instead, and ``classes``
    prints every loop's count per SASS_CLASSES class."""
    if loop is None:
        def loop(body):
            return any("MUFU" in t for t in body)
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if not select(name):
            continue
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn):
            ins.append((int(m.group(1), 16), m.group(2).strip()))
        loops = []
        for addr, text in ins:
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if b and int(b.group(1), 16) <= addr:
                body = [t for a, t in ins if int(b.group(1), 16) <= a <= addr]
                if loop(body):
                    loops.append((int(b.group(1), 16), addr, body))
        inner = [lp for lp in loops
                 if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                            for o in loops)]

        def count(body, op):
            return sum(1 for t in body if re.search(rf"\b{op}\b", t))
        print(f"sass {name}: {len(ins)} instructions, "
              f"LDL {count([t for _, t in ins], 'LDL')}, "
              f"STL {count([t for _, t in ins], 'STL')}")
        for a, b, body in inner:
            if classes:
                n = {}
                for t in body:
                    n[sass_class(t)] = n.get(sass_class(t), 0) + 1
                print(f"  loop {a:#06x}-{b:#06x}: {len(body)} instructions: "
                      + ", ".join(f"{k} {v}" for k, v in sorted(n.items())))
                continue
            print(f"  loop {a:#06x}-{b:#06x}: {len(body)} instructions, "
                  f"MUFU {count(body, 'MUFU')}, "
                  f"LDS {count(body, 'LDS')}, LDL {count(body, 'LDL')}, "
                  f"STL {count(body, 'STL')}, "
                  f"BRA {count(body, 'BRA')}")


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


def problem(tmp, n, grid, gp="all", ny=None):
    import torch
    from gapflow_torch import Problem
    from gapflow_torch.validate import BC_CASES, GP_CASES, gp_yaml
    edges = "" if grid == "periodic" else BC_CASES[grid][0]
    ny = n if ny is None else ny
    p = Problem.from_string(
        gp_yaml(n, ny, gp=GP_CASES[gp], grid=edges, out=f"{tmp}/o",
                dtool_path=f"{tmp}/train_{grid}_{gp}_{n}_{ny}"),
        device="cuda", dtype=torch.float32)
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        p._pre_run()
    return p


def profile_split(fn):
    """torch.profiler's device time per kernel name over one call of
    ``fn``.  The call sits between 0.5 s of idle host time on each side:
    the profiler keeps only device events inside its window on the host's
    clock, from which the card's clock drifts as the process ages."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.5)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.5)
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0)
        if dev and "gp" in e.key:
            rows.append((e.key, e.count, dev / 1e3))
    if not rows:
        print("  profiler: no device time recorded")
    for key, count, ms in rows:
        print(f"  profiler: {key[:60]} x{count}: {ms:.4f} ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--save")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
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
        raise SystemExit("gp_step_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import tempfile
    from gapflow_torch.ops import _build
    from gapflow_torch.ops import stencil_gp as G
    from gapflow_torch.validate import gp_kernel_inputs
    print(f"card: {smi()}")
    print(f"tree: {args.root}")
    _build.load()
    ptxas_report(_build)
    if args.sass:
        sass_report(_build.library_path())
    tmp = tempfile.mkdtemp(prefix="gp_bench_")
    saved = {}

    pj = problem(tmp, N, "periodic")
    cfg = pj._solver_cfg
    q, st, dt, ops, state = gp_kernel_inputs(pj, CAP, db_scales=True)
    none = G.prep_gp_ops({"Xscale": state["Xscale"]}, (None,) * 3,
                         (False,) * 3)
    q256, st256, _, ops256, _ = gp_kernel_inputs(pj, 256, db_scales=True)
    saved["K5 1024"], saved["K5 1024 p"] = G.gp_step(q, st, dt, cfg, ops)
    saved["K5 1024 none"] = G.gp_step(q, st, dt, cfg, none, False)[0]
    saved["K7 1024 x8"] = G.gp_steps(q, st, dt, cfg, ops, 8)
    ref = G.gp_step_ref(q, st, dt, cfg, ops)
    print(f"K5 1024² vs twin: q {torch.equal(saved['K5 1024'], ref[0])}, "
          f"p {torch.equal(saved['K5 1024 p'], ref[1])}")
    ref7 = G.gp_steps_ref(q, st, dt, cfg, ops, 8)
    print(f"K7 1024² x8 vs twin: {torch.equal(saved['K7 1024 x8'], ref7)}")
    rows = [
        ("K5 gp_step need_p=False", lambda: G.gp_step(q, st, dt, cfg, ops,
                                                      False), 20),
        ("K5 gp_step need_p=True", lambda: G.gp_step(q, st, dt, cfg, ops),
         20),
        ("K5 gp_step no surrogates", lambda: G.gp_step(q, st, dt, cfg, none,
                                                       False), 50),
        ("K5 gp_step need_p=False, 256 points",
         lambda: G.gp_step(q256, st256, dt, cfg, ops256, False), 10),
        ("K7 gp_steps (per step, 20 a call)",
         lambda: G.gp_steps(q, st, dt, cfg, ops, 20), 1),
    ]
    pa = problem(tmp, N, "dn_all_asymmetric")
    cfga = pa._solver_cfg
    qa, sta, dta, opsa, _ = gp_kernel_inputs(pa, CAP, ghosted=True,
                                             db_scales=True)
    saved["K6 1024"], saved["K6 1024 p"] = G.gp_step_bc(qa, sta, dta, cfga,
                                                        opsa, True)
    ref = G.gp_step_bc_ref(qa, sta, dta, cfga, opsa, True)
    print(f"K6 1024² vs twin: q {torch.equal(saved['K6 1024'], ref[0])}, "
          f"p {torch.equal(saved['K6 1024 p'], ref[1])}")
    rows += [
        ("K6 gp_step_bc need_p=False",
         lambda: G.gp_step_bc(qa, sta, dta, cfga, opsa), 20),
        ("K6 gp_step_bc need_p=True",
         lambda: G.gp_step_bc(qa, sta, dta, cfga, opsa, True), 20),
    ]
    # the GP asperity of examples/config/asperity_2d_lj_gp.yaml (BWR, D/N
    # on four edges, LJ units) at N², asperities from seed 0
    import yaml
    from gapflow_torch import Problem
    with open(HERE / "examples" / "config" / "asperity_2d_lj_gp.yaml") as fh:
        d = yaml.safe_load(fh)
    d["options"].update(silent=True, output=f"{tmp}/o")
    d["grid"].update(Nx=N, Ny=N)
    d["geometry"]["seed"] = 0
    d["db"]["dtool_path"] = f"{tmp}/train_asperity"
    pb = Problem.from_string(yaml.safe_dump(d), device="cuda",
                             dtype=torch.float32)
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        pb._pre_run()
    qb, stb, dtb, opsb, _ = gp_kernel_inputs(pb, CAP, ghosted=True,
                                             db_scales=True)
    cfgb = pb._solver_cfg
    saved["K6 asperity"], saved["K6 asperity p"] = G.gp_step_bc(
        qb, stb, dtb, cfgb, opsb, True)
    ref = G.gp_step_bc_ref(qb, stb, dtb, cfgb, opsb, True)
    print(f"K6 asperity 1024² vs twin: q "
          f"{torch.equal(saved['K6 asperity'], ref[0])} (max abs "
          f"{float((saved['K6 asperity'] - ref[0]).abs().max()):.3e}), p "
          f"{torch.equal(saved['K6 asperity p'], ref[1])}")
    # small grids, where a step's four launches cost the most: the shapes
    # of parabolic_1d_lj_gp's fused step (200 x 1, D/N x edges), of the
    # flagship at 256² (four D/N edges) and of the pass-2 EHL route on
    # parabolic_1d_elastic (256 x 1, periodic, no surrogates)
    for n, ny, grid, need_p, surrogates in ((200, 1, "dn_x", True, True),
                                            (256, 256, "dn_all_asymmetric",
                                             True, True),
                                            (256, 1, "periodic", False,
                                             False)):
        ps = problem(tmp, n, grid, ny=ny)
        qs, sts, dts, opss, sts_ = gp_kernel_inputs(
            ps, CAP, ghosted=grid != "periodic", db_scales=True)
        if not surrogates:
            opss = G.prep_gp_ops({"Xscale": sts_["Xscale"]}, (None,) * 3,
                                 (False,) * 3)
        cfgs = ps._solver_cfg
        if grid == "periodic":
            fn = (lambda q=qs, st=sts, dt=dts, c=cfgs, o=opss, p=need_p:
                  G.gp_step(q, st, dt, c, o, p))
        else:
            fn = (lambda q=qs, st=sts, dt=dts, c=cfgs, o=opss, p=need_p:
                  G.gp_step_bc(q, st, dt, c, o, p))
        what = f"{CAP} points x {len(opss.models)}" if surrogates \
            else "no surrogates"
        rows.append((f"small grid {n}x{ny} {grid}, {what}, need_p={need_p}",
                     fn, 200))
    for label, fn, reps in rows:
        ms = time_ms(fn, reps)
        if "per step" in label:
            ms /= 20
        print(f"time {label}: {ms:.4f} ms")
    print("profile of one gp_step need_p=False at 1024²:")
    profile_split(lambda: G.gp_step(q, st, dt, cfg, ops, False))

    for grid in GRIDS:
        for gp in ("pressure", "all"):
            p = problem(tmp, CHECK_N, grid, gp)
            cfg = p._solver_cfg
            for cap in CHECK_CAPS:
                periodic = grid == "periodic"
                q, st, dt, ops, _ = gp_kernel_inputs(
                    p, cap, ghosted=not periodic, db_scales=True)
                tag = f"{grid} {gp} cap {cap}"
                if periodic:
                    qk, pk = G.gp_step(q, st, dt, cfg, ops)
                    qr, pr = G.gp_step_ref(q, st, dt, cfg, ops)
                    qs = G.gp_steps(q, st, dt, cfg, ops, 3)
                    s_eq = torch.equal(qs, G.gp_steps_ref(q, st, dt, cfg,
                                                          ops, 3))
                    saved[f"{tag} steps"] = qs
                else:
                    qk, pk = G.gp_step_bc(q, st, dt, cfg, ops, True)
                    qr, pr = G.gp_step_bc_ref(q, st, dt, cfg, ops, True)
                    s_eq = None
                saved[tag], saved[f"{tag} p"] = qk, pk
                print(f"equal {tag}: q {torch.equal(qk, qr)} (max abs "
                      f"{float((qk - qr).abs().max()):.3e}), p "
                      f"{torch.equal(pk, pr)} (max abs "
                      f"{float((pk - pr).abs().max()):.3e}), steps {s_eq}")
    if args.save:
        torch.save({k: v.cpu() for k, v in saved.items()}, args.save)
        print(f"saved {len(saved)} outputs to {args.save}")


if __name__ == "__main__":
    main()
