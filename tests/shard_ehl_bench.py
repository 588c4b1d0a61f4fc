"""The shard kernels and the EHL kernel K8 on the card, in one tree or
two (not a test; needs nvcc and a CUDA device).

    python tests/shard_ehl_bench.py [--root DIR] [--save FILE]
        [--only ehl|shard|plain] [--depths 2 3 4]
    python tests/shard_ehl_bench.py --compare FILE_A FILE_B
    python tests/shard_ehl_bench.py --variant reform|eb1|sb2 DIR

Imports ``gapflow_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout), so that one script times two trees on the same card in
turns (unpack the other with ``git archive``): parent, change, change,
parent.  It uses only entry points both trees have (``Problem``,
``run_steps_ehl``, ``run_steps_sharded``, the wrappers of
``ops.stencil``) and reads kernel times by name from ``torch.profiler``
(``chip_smoke.device_times``, padded).  Prints:

- the card's name and power limit, and ``ptxas``'s report for the shard
  and EHL kernels;
- ``ehl``: ``chip_smoke.py`` phase 3j, ``run_steps_ehl(500)`` on the
  1024² EHL journal after a warm-up run: wall per step, launches, the
  profiler's device time per step of K8 and of the other kernels (the
  deformation's FFTs, the EOS, the relaxation, and in the parent the
  gap and patches), the rest idle (host); then K8 alone on the run's
  final state and deformation: events around 200 launches of each form
  queued behind a spin kernel (device time), and around 200 as they
  come (which time the wrapper's host work where it exceeds the
  kernel's);
- ``shard``: ``chip_smoke.py`` phase 3s, ``run_steps_sharded(200)`` on
  the perturbed four-edge D/N journal at 1024² on 1 x 1, 2 x 2 and 2 x 4
  cuda:0 meshes and the periodic journal on 2 x 2 (a warm-up run each):
  wall per step, launches, and on 2 x 2 the profiler's split of 50 steps
  into the shard kernels, the other kernels (halo copies, statics) and
  idle; in a tree with the shard sweep, at every depth of ``--depths``
  (``parallel.pallas_halo.SHARD_K`` set for the run);
- ``plain``: the plain sweeps at 1024² (``plain_sweeps``, 1024 steps on
  the journal; ``plain_sweeps_bc`` on the inclined slider), whose body
  the shard and EHL kernels now share: ms per step.

``--save`` writes the runs' final states (3j's q and deformation, every
sharded run's q, the plain sweeps' outputs) to FILE; ``--compare``
prints, per output, whether two such files hold the same values bit for
bit.  ``--variant NAME DIR`` writes a copy of the tree with another
build of a kernel: ``reform``, the EHL kernel forming each cell's
statics in each pass in place of once into shared memory
(``EHL_KEEP``); ``eb1``, the EHL kernel compiled for one block a SM
(128 registers) in place of two; ``sb2``, the shard sweep's instances
that hold a domain edge compiled for two blocks a SM (64 registers,
spilling) in place of one.
"""

import argparse
import inspect
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
EHL_STEPS = 500          # chip_smoke.py phase 3j
SHARD_STEPS = 200        # chip_smoke.py phase 3s
SPLIT_STEPS = 50
PLAIN_STEPS = 1024
MESHES = ((1, 1), (2, 2), (2, 4))
VARIANTS = {"reform": (("stencil_ehl.cu", "constexpr bool EHL_KEEP = true;",
                        "constexpr bool EHL_KEEP = false;"),),
            "eb1": (("stencil_ehl.cu", "int EHL_BLOCKS_PER_SM = 2;",
                     "int EHL_BLOCKS_PER_SM = 1;"),),
            "sb2": (("stencil_shard.cu", "return PX && PY ? 2 : 1;",
                     "return 2;"),)}


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def variant(name, dest):
    dest = Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(HERE / "gapflow_torch", dest / "gapflow_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", dest / "chip_smoke.py")
    for src, old, new in VARIANTS[name]:
        f = dest / "gapflow_torch" / "csrc" / src
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} not found once")
        f.write_text(text.replace(old, new))
    print(f"variant {name} written to {dest}")


def ptxas(build):
    log = build.library_path().with_suffix(".log")
    if not log.is_file():
        print("ptxas: no build log (library built earlier)")
        return
    name = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and re.search("shard|ehl", name) \
                and ("stack frame" in line or "Used" in line):
            short = re.search(r"(\w+_kernel\w*?)(I|E|v)", name)
            print(f"ptxas {short.group(1) if short else name} "
                  f"{name[-40:]}: "
                  + line.split("ptxas info    : ")[-1].strip())


def queued_ms(fn, reps, spin_s=0.2):
    """Device time per call of ``fn``: events around ``reps`` calls
    enqueued behind a spin kernel, so that the card runs them back to
    back however long each launch takes the host (chip_smoke.py's, here
    for trees whose smoke lacks it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 1.98e9))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host >= spin_s / 2:
        raise RuntimeError(f"queued_ms: enqueueing took {host:.3f} s")
    return start.elapsed_time(end) / reps


def kernel_ms(cs, fn, key, reps):
    """torch.profiler's device time per call of ``fn`` of the kernels
    whose name holds ``key``, and of every other kernel."""
    dev = cs.device_times(fn, reps)
    mine = sum(v for k, v in dev.items() if key in k)
    return mine, sum(dev.values()) - mine


def ehl_phase(cs, S, saved):
    import numpy as np
    import torch
    new_api = "h_und" in inspect.signature(S.ehl_step).parameters
    warm = cs.ehl_journal(N)
    warm._pre_run()
    warm.run_steps_ehl(20)
    p = cs.ehl_journal(N)
    p._pre_run()
    cs.reset_all()
    t0 = time.perf_counter()
    p.run_steps_ehl(EHL_STEPS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / EHL_STEPS * 1e3
    print(f"ehl 3j: run_steps_ehl({EHL_STEPS}) at {N}²: {wall:.4f} ms per "
          f"step (host wall), launches {cs.launched()}")
    saved["3j q"] = torch.as_tensor(p.q).clone()
    saved["3j deformation"] = torch.as_tensor(p.topo.deformation).clone()
    ps = cs.ehl_journal(N)
    ps._pre_run()
    k8, other = kernel_ms(cs, lambda: ps.run_steps_ehl(SPLIT_STEPS),
                          "ehl", 1)
    k8, other = k8 / SPLIT_STEPS, other / SPLIT_STEPS
    print(f"ehl 3j split (torch.profiler, {SPLIT_STEPS} steps): K8 "
          f"{k8:.4f} ms + other kernels {other:.4f} ms + idle "
          f"{wall - k8 - other:.4f} ms = {wall:.4f} ms; idle share "
          f"{(wall - k8 - other) / wall:.3f}")

    f32 = torch.float32
    cfg = p._solver_cfg
    ed = p.topo.ElasticDeformation
    q = p._tensor(p.q).to(f32)[:, 1:-1, 1:-1].contiguous()
    lo = torch.zeros_like(q)
    hu = p._tensor(p.topo.h_undeformed).to(f32).contiguous()
    u = ed.u_prev.to(f32).contiguous()
    ls = p._tensor(p.fc.get_real_field("extra").p[0, 1:-1, 1:-1]) \
        .to(f32).contiguous()
    dt = float(np.float32(p.dt))
    shift = ed.periodicity in ("half", "none")
    if new_api:
        plain = lambda: S.ehl_step(q, hu, u, ls, dt, cfg, shift_ref=shift)
        comp = lambda: S.ehl_comp_step(q, lo, hu, u, ls, dt, cfg, shift)
    else:
        h_full = hu + (u - u[0, 0] if shift else u)
        px, py = S.ehl_patches(h_full, cfg)
        h_int = h_full[1:-1, 1:-1].contiguous()
        plain = lambda: S.ehl_step(q, h_int, ls, px, py, dt, cfg)
        comp = lambda: S.ehl_comp_step(q, lo, h_int, ls, px, py, dt, cfg)
    saved["K8 ehl_step"] = plain().clone()
    saved["K8 ehl_comp_step"] = torch.cat(comp()).clone()
    # a launch lasts about as long as its wrapper's host work: events
    # around launches as they come time the host, queued ones the kernel
    print(f"ehl K8 alone at {N}² on 3j's final state: ehl_step "
          f"{queued_ms(plain, 200):.4f} ms, ehl_comp_step "
          f"{queued_ms(comp, 200):.4f} ms (200 launches queued behind a "
          f"spin kernel); events around 200 launches as they come "
          f"{cs.time_ms(plain, 200):.4f}, {cs.time_ms(comp, 200):.4f} ms")


def shard_phase(cs, S, saved, depths):
    import torch
    from gapflow_torch.parallel import pallas_halo as PH
    blocked = hasattr(PH, "SHARD_K")
    key = "shard_sweep_kernel" if blocked else "shard_step_kernel"
    default = getattr(PH, "SHARD_K", None)
    for depth in (depths if blocked else [None]):
        if blocked:
            PH.SHARD_K = depth
        tag = f"k = {depth}" if blocked else "one step a launch"
        for case, shapes in ((cs.SHARD_CASE, MESHES), (None, ((2, 2),))):
            for shape in shapes:
                warm = cs.shard_problem(N, case)
                warm.run_steps_sharded(4, cs.cuda_mesh(shape))
                p = cs.shard_problem(N, case)
                cs.reset_all()
                t0 = time.perf_counter()
                p.run_steps_sharded(SHARD_STEPS, cs.cuda_mesh(shape))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / SHARD_STEPS * 1e3
                label = f"{case or 'periodic'} {shape[0]} x {shape[1]}"
                print(f"shard {tag}: {label} at {N}², {SHARD_STEPS} steps: "
                      f"{wall:.4f} ms per step (host wall), launches "
                      f"{cs.launched()}", flush=True)
                saved[f"3s {label}" + ("" if depth == default
                                        else f" {tag}")] = \
                    torch.as_tensor(p.q).clone()
                if shape == (2, 2):
                    ps = cs.shard_problem(N, case)
                    mesh = cs.cuda_mesh(shape)
                    ps.run_steps_sharded(2, mesh)
                    t0 = time.perf_counter()
                    ps.run_steps_sharded(SPLIT_STEPS, mesh)
                    torch.cuda.synchronize()
                    w = (time.perf_counter() - t0) / SPLIT_STEPS * 1e3
                    k9, other = kernel_ms(
                        cs, lambda: ps.run_steps_sharded(SPLIT_STEPS, mesh),
                        key, 1)
                    k9, other = k9 / SPLIT_STEPS, other / SPLIT_STEPS
                    print(f"  split of a {label} step ({SPLIT_STEPS} steps, "
                          f"torch.profiler): {w:.4f} ms = shard kernels "
                          f"{k9:.4f} + other kernels {other:.4f} + idle "
                          f"{w - k9 - other:.4f}; idle share "
                          f"{(w - k9 - other) / w:.3f}", flush=True)


def plain_phase(cs, S, saved):
    import torch
    for label, case in (("journal", None), ("slider", "slider")):
        p = cs.problem(cs.inclined_yaml(N, 10, adaptive=0)) if case \
            else cs.journal(N, N)
        p._pre_run()
        cfg = p._solver_cfg
        q, st, dt = cs.kernel_inputs(p, amp=0.01, ghosted=bool(case))
        fn = S.plain_sweeps_bc if case else S.plain_sweeps
        out = fn(q, st, dt, cfg, PLAIN_STEPS)
        saved[f"plain {label}"] = out.clone()
        ms = cs.time_ms(lambda: fn(q, st, dt, cfg, PLAIN_STEPS), 3)
        print(f"plain {label} at {N}²: {ms / PLAIN_STEPS:.4f} ms per step "
              f"(events around calls of {PLAIN_STEPS} steps)", flush=True)
    # the serial boundary sweeps on the sharded runs' four-edge D/N
    # journal, at its size and a shard's, at every depth
    for n in (N, N // 2):
        p = cs.shard_problem(n, cs.SHARD_CASE)
        cfg = p._solver_cfg
        q, st, dt = cs.kernel_inputs(p, amp=0.01, ghosted=True)
        ms = [cs.time_ms(lambda: S._plain_sweeps(q, st, dt, cfg,
                                                 PLAIN_STEPS, k), 3)
              / PLAIN_STEPS for k in (1, 2, 3, 4)]
        print(f"plain four-edge D/N journal at {n}² by depth k = 1..4: "
              + ", ".join(f"{m:.4f}" for m in ms) + " ms per step",
              flush=True)


def compare(a, b):
    import torch
    A, B = torch.load(a), torch.load(b)
    for k in sorted(set(A) | set(B)):
        if k not in A or k not in B:
            print(f"{k}: only in {'ab'[k in B]}")
            continue
        same = torch.equal(A[k], B[k])
        print(f"{k}: {'equal bit for bit' if same else 'DIFFERENT'}"
              + ("" if same else
                 f" (max abs {float((A[k] - B[k]).abs().max()):.3e})"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--variant", nargs=2)
    ap.add_argument("--only", choices=("ehl", "shard", "plain"))
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 3, 4])
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.variant:
        return variant(*args.variant)
    if args.save:
        args.save = os.path.abspath(args.save)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from gapflow_torch.ops import _build
    from gapflow_torch.ops import stencil as S
    print(f"card: {smi()}; tree {root}")
    t0 = time.perf_counter()
    _build.load()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    ptxas(_build)
    saved = {}
    if args.only in (None, "ehl"):
        ehl_phase(cs, S, saved)
    if args.only in (None, "shard"):
        shard_phase(cs, S, saved, args.depths)
    if args.only in (None, "plain"):
        plain_phase(cs, S, saved)
    if args.save:
        torch.save({k: v.cpu() for k, v in saved.items()}, args.save)
        print(f"saved {len(saved)} outputs to {args.save}")


if __name__ == "__main__":
    main()
