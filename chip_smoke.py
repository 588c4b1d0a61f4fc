"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of gapflow_torch from this checkout, checks each
against its plain torch twin on the card, drives the main path (a silent
float32 journal-bearing run at 1024 x 1024 through ``Problem.run()``),
checks the physics against the analytic Sommerfeld solution, and times the
kernels and their twins.  Any failed phase raises, which exits non-zero
before the result line.  Without CUDA, or without the package beside it,
the script fails the same way.

Output: one line per measurement, then a JSON line with the kernels,
the ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

os.environ["GAPFLOW_X64"] = "0"          # float32 production precision
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TOL = 1e-5            # component-scaled max error, kernel vs plain twin
SOMMERFELD_TOL = 0.02

_JOURNAL = """
options: {{output: data/smoke, write_freq: 100000, silent: True}}
grid: {{dx: {dx}, dy: {dx}, Nx: {nx}, Ny: {ny}}}
geometry: {{type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.}}
numerics: {{CFL: 0.5, adaptive: 0, tol: 1e-30, dt: {dt}, max_it: {max_it}}}
properties: {{shear: 0.0794, bulk: 0., {props}}}
"""
_DH = "EOS: DH, P0: 101325., rho0: 877.7007, C1: 3.5e10, C2: 1.23"
_BAYADA = ("EOS: Bayada, rho0: 850., rho_l: 850., rho_v: 0.019, "
           "c_l: 1600., c_v: 352.")
# every EOS and piezoviscosity model the kernel gate admits, one step each
# at 64 x 128.  The perturbation (amplitude 0.01, as in phase 2) keeps the
# state's gradients well above float32 rounding of the EOS (DH's r - 1
# cancellation makes two correct f32 evaluations differ by more than the
# tolerance at smaller amplitudes); the piezoviscous DH cases use the
# softer C1 = 3.5e8 so that Roelands' (1 + p/p_ref)^z stays real.
_DH_SOFT = "EOS: DH, P0: 101325., rho0: 877.7007, C1: 3.5e8, C2: 1.23"
_MODEL_CASES = [
    ("DH", _DH),
    ("PL", "EOS: PL, rho0: 1.1853, P0: 101325., alpha: 0."),
    ("vdW", "EOS: vdW, rho0: 1."),
    ("MT", "EOS: MT, rho0: 700."),
    ("cubic", "EOS: cubic, rho0: 1."),
    ("BWR", "EOS: BWR, rho0: 0.7, T: 2."),
    ("Bayada", _BAYADA),
    ("DH+Barus", _DH_SOFT + ", piezo: {name: Barus}"),
    ("DH+Roelands", _DH_SOFT + ", piezo: {name: Roelands}"),
    ("Bayada+Dukler", _BAYADA + ", piezo: {name: Dukler}"),
    ("Bayada+McAdams", _BAYADA + ", piezo: {name: McAdams}"),
]


def journal(nx, ny, dx=2e-5, dt=5e-11, max_it=1000000, props=_DH):
    from gapflow_torch import Problem
    return Problem.from_string(_JOURNAL.format(
        nx=nx, ny=ny, dx=dx, dt=dt, max_it=max_it, props=props),
        device="cuda")


def kernel_inputs(problem, amp, seed=0):
    """Interior (q, statics, dt) of a perturbed state on the card."""
    from gapflow_torch.ops.stencil import interior_statics
    from gapflow_torch.validate import perturbed_state
    problem._pre_run()
    st = perturbed_state(problem, seed=seed, amp=amp)
    q = st.q[:, 1:-1, 1:-1].contiguous()
    return q, interior_statics(st.topo, st.extra, torch.float32,
                               q.device), problem.dt


def check(label, out, ref):
    from gapflow_torch.validate import kernel_vs_plain_err
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise RuntimeError(f"{label}: non-finite values")
    err = kernel_vs_plain_err(out, ref)
    abs_err = float((out - ref).abs().max())
    print(f"  {label}: max scaled err {err:.3e}, max abs err {abs_err:.3e}")
    if not err < TOL:
        raise RuntimeError(f"{label}: scaled err {err} >= {TOL}")
    return abs_err


def time_ms(fn, reps):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from gapflow_torch.ops import _build
    from gapflow_torch.ops import stencil as S

    # -- phase 1: card, versions, build -----------------------------------
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ({_build.library_path().name})")

    # -- phase 2: kernels vs plain twins, float32 on the card --------------
    print("phase 2: kernel vs plain twin (256 x 256 perturbed journal)")
    p = journal(256, 256)
    cfg = p._solver_cfg
    q, st, dt = kernel_inputs(p, amp=0.01)
    err = {}
    err["fused_step"] = max(
        check(f"K1 fused_step emit_delta={d}",
              S.fused_step(q, st, dt, cfg, emit_delta=d),
              S.fused_step_ref(q, st, dt, cfg, emit_delta=d))
        for d in (False, True))
    lo = torch.zeros_like(q)
    qk, lk = S.comp_steps(q, lo, st, dt, cfg, 8)
    qr, lr = S.comp_steps_ref(q, lo, st, dt, cfg, 8)
    err["comp_step"] = check("K2 comp_steps x8 (q)", qk, qr)
    if not torch.isfinite(lk).all():
        raise RuntimeError("K2: non-finite Kahan carry")
    print("phase 2b: one K1 step per EOS / piezo model (64 x 128)")
    for label, props in _MODEL_CASES:
        pm = journal(64, 128, props=props)
        if not S.pallas_supported(pm._solver_cfg):
            raise RuntimeError(f"{label}: kernel gate refuses the model")
        qm, stm, dtm = kernel_inputs(pm, amp=0.01)
        check(label, S.fused_step(qm, stm, dtm, pm._solver_cfg),
              S.fused_step_ref(qm, stm, dtm, pm._solver_cfg))

    # -- phase 3: the main path -------------------------------------------
    n = 1024
    max_it = 4098   # 4096 steps of full sweeps + 2 remainder steps
    print(f"phase 3: Problem.run(), silent float32 journal {n} x {n}, "
          f"max_it {max_it}")
    main_p = journal(n, n, dt=1e-11, max_it=max_it)
    torch.cuda.synchronize()
    S.reset_launches()
    t0 = time.perf_counter()
    main_p.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(S.LAUNCHES)
    print(f"  route {main_p._route}, steps {main_p.step}, launches "
          f"{launches}, wall {wall:.3f} s, "
          f"{n * n * main_p.step / wall:.4e} cell-updates/s")
    if main_p._route != "run_compiled_fast":
        raise RuntimeError(f"main path took {main_p._route}")
    if main_p.step != max_it:
        raise RuntimeError(f"main path stopped at step {main_p.step}")
    if launches["comp_step"] < 4096 or launches["fused_step"] < 1:
        raise RuntimeError(f"main path missed a kernel: {launches}")
    if not (np.isfinite(main_p.q).all() and (main_p.q[0] > 0).all()):
        raise RuntimeError("main path: non-finite q or rho <= 0")

    # -- phase 4: physics ---------------------------------------------------
    from gapflow_torch.validate import sommerfeld_l2
    t0 = time.perf_counter()
    l2 = sommerfeld_l2(device="cuda")
    print(f"phase 4: Sommerfeld rel-L2 {l2:.5f} (256 x 128, 20000 "
          f"compensated f32 steps, {time.perf_counter() - t0:.1f} s)")
    if not l2 < SOMMERFELD_TOL:
        raise RuntimeError(f"Sommerfeld rel-L2 {l2} >= {SOMMERFELD_TOL}")

    # -- phase 5: timing at 1024^2 --------------------------------------------
    tp = journal(n, n, dt=1e-11)
    cfg = tp._solver_cfg
    q, st, dt = kernel_inputs(tp, amp=0.01)
    lo = torch.zeros_like(q)
    reps = 200
    times = {
        "fused_step": (time_ms(lambda: S.fused_step(q, st, dt, cfg), reps),
                       time_ms(lambda: S.fused_step_ref(q, st, dt, cfg), 20)),
        "comp_step": (time_ms(lambda: S.comp_steps(q, lo, st, dt, cfg, reps),
                              1) / reps,
                      time_ms(lambda: S.comp_steps_ref(q, lo, st, dt, cfg, 1),
                              20)),
    }
    for k, (ms, plain) in times.items():
        print(f"phase 5: {k} {n}x{n}: kernel {ms:.4f} ms/step, plain twin "
              f"{plain:.4f} ms/step")

    replaces = {"fused_step": "gapflow_tpu/ops/stencil.py:897",
                "comp_step": "gapflow_tpu/ops/stencil.py:681"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": "gapflow_torch/csrc/stencil.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": err[k], "ms": times[k][0], "plain_ms": times[k][1]}
        for k in ("fused_step", "comp_step")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
