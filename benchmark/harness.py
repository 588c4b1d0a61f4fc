"""One run of one cell: set-up, the measured window, the traced chunks,
the metrics and the check against the reference.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` or the
configuration gives it: ``configs/<config>.json`` (through the entry's
``file``), ``traffic/<traffic>.json``, ``limits/<workload>.json``,
``metrics/<metric>.py``, ``routes/<route>.py`` (the configuration's
``route``) and the comparison beside its ``reference`` (:mod:`check`).
A cell is added by adding files and entries.

The run, in the order it happens:

1. set-up: the program's input sections from the configuration, the
   traffic and the seed; ``Problem`` built from them, the seed's initial
   density written into it, ``Problem._pre_run()`` (the span
   ``problem_init``); then one warm-up chunk through ``Problem.run()``
   with ``max_it`` at one chunk, which loads the kernel library (built on
   the first run in a checkout) and runs every kernel and statistic the
   window runs;
2. the window: ``Problem.run()`` resumed with the traffic's ``max_it``;
   the process sends itself SIGTERM after ``--seconds``, and the program
   stops after the chunk it is in, copies the state to the host and
   refreshes its fields, as a user's run ends;
3. with ``--trace 1``, torch.profiler over a few chunks of the window
   (:mod:`devtrace`);
4. after the window: the device's peak memory, then the program's state
   freed and the reference run (:mod:`check`).

The run must take the route (``Problem._route``) its configuration
names.  That route's file observes its chunk calls: ``install(rec)``
makes each chunk of the runs that follow pass through
:meth:`Recorder.call`, and returns the uninstaller.  The recorder counts
the chunks and their steps, and keeps the input and output of the chunk
the check draws from the seed.
"""

import gc
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

import check
import devtrace
import inputs

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gapflow_tpu")


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and metrics."""

    def __init__(self, name, root=ROOT):
        spec = load_json(root / "BENCHMARK.json")
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.work = work[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.work["config"]]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(root / "benchmark" / "traffic"
                                 / f"{self.work['traffic']}.json")
        self.limits = load_json(root / "benchmark" / "limits"
                                / f"{name}.json")["limits"]
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]
        self.chips = self.work["chips"]

    def _has(self, metric):
        # BENCHMARK.json's format lets a metric name the cells it is read
        # in (its "workloads" key); a metric without the key belongs to
        # every cell
        return "workloads" not in metric or self.name in metric["workloads"]


def load_module(path, name):
    """The Python file ``path``, loaded as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name, root=ROOT):
    """``read(run)`` of ``metrics/<name>.py``."""
    return load_module(root / "benchmark" / "metrics" / f"{name}.py",
                       f"metric_{name}").read


def route(name, root=ROOT):
    """``routes/<name>.py``: the observation of the route's chunks."""
    return load_module(root / "benchmark" / "routes" / f"{name}.py",
                       f"route_{name}")


class Recorder:
    """Sees every chunk call of the run (:meth:`call`): counts the chunks
    and their steps, keeps the input and output of the chunks it is asked
    to keep (``sample``, the one the check draws, and any in ``keep``) and
    of the last chunk, and opens and closes the profile (``profile``, set
    for a traced run) around the ``traced`` chunks."""

    def __init__(self, sample, keep=()):
        self.sample = sample
        self.keep = set(keep) | {sample}
        self.profile = None
        self.traced = []
        self.closed = threading.Event()
        self.steps = []
        self.calls = []
        self.kept = {}
        self.last = None

    def call(self, chunk, q, dt, n, state=None):
        """One chunk call, ``chunk()``, of ``n`` steps at ``dt`` from the
        state ``q``; returns what it returns.  ``state`` picks the end
        state out of that (the whole of it without)."""
        i = len(self.steps)
        self.calls.append(time.perf_counter())
        if self.traced and i == self.traced[0]:
            self.profile.start()
        if self.profile is not None and self.profile.active:
            from torch.profiler import record_function
            with record_function(devtrace.CHUNK):
                out = chunk()
        else:
            out = chunk()
        self.steps.append(int(n))
        self.last = (i, q, out if state is None else state(out), float(dt),
                     int(n))
        if i in self.keep:
            self.kept[i] = self.last
        if self.traced and i == self.traced[-1]:
            self.close()
        return out

    def close(self):
        """Stop an open profile; its trace learns the traced chunks'
        steps."""
        if self.profile is not None and self.profile.active:
            self.profile.stop()
            self.profile.trace.chunk_steps = self.steps[self.traced[0]:]
        self.closed.set()


class Run:
    """What the metric readers read: ``spans`` (seconds on the host's
    clock), ``calls`` (the host clock at each chunk call of the window,
    from its start), ``counters``, ``trace`` (a :class:`devtrace.Trace` or
    None), the cell's ``config`` and ``traffic``, and ``peaks``."""

    def __init__(self, cell):
        self.config = cell.config
        self.traffic = cell.traffic
        self.peaks = load_json(HERE / "peaks.json")
        self.spans = {}
        self.calls = []
        self.counters = {}
        self.trace = None
        self.device_kind = ""


def process_start(fallback):
    """The host clock (``time.time``) at which this process started;
    ``fallback`` where /proc does not say."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return fallback


def draw_chunk(seed, traffic):
    """The chunk the check compares: 0 (the warm-up chunk) to
    ``check_chunks - 1``, drawn from the seed."""
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    return int(rng.integers(0, traffic["check_chunks"]))


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None,
             root=ROOT):
    """One run; returns the result line (a dict)."""
    cell = Cell(name, root)
    rec = Recorder(draw_chunk(seed, cell.traffic))
    result, prog, cfg_run, rho0 = measure(cell, seed, seconds, trace, rec,
                                          device, t_start, root)
    t0 = time.perf_counter()
    values = check.numbers(cfg_run, cell.traffic, rho0, prog[rec.sample],
                           device=device, root=root)
    print(f"benchmark: check {time.perf_counter() - t0:.1f} s")
    result["correct"], checks = check.verdict(values, cell.limits)
    result["checks"] = checks      # last in the line
    return result


def measure(cell, seed, seconds, trace, rec, device="cuda", t_start=None,
            root=ROOT):
    """Set-up, window and metrics of one run.  Returns the result line
    without its check, what the program produced for each chunk ``rec``
    kept (``{index: prog}``, see :func:`check.numbers`), the run's
    configuration and the initial density."""
    t_start = time.time() if t_start is None else t_start
    run = Run(cell)
    traffic = cell.traffic
    import torch
    import yaml
    from gapflow_torch import Problem

    t_imports = time.time() - t_start
    outdir = tempfile.mkdtemp(prefix="gapflow_bench_")
    os.rmdir(outdir)        # a silent run creates no output directory
    t0 = time.perf_counter()
    sections = inputs.sections(cell.config, traffic, seed, outdir)
    rho0 = inputs.density(cell.config, traffic, seed)
    p = Problem.from_string(yaml.safe_dump(sections), device=device,
                            dtype=torch.float32)
    p.q[0][...] = rho0
    p._pre_run()
    run.spans["problem_init"] = time.perf_counter() - t0
    start = {"topo": p.topo.full[:3].copy(), "q0": p.q.copy(),
             "dt0": float(p.dt)}

    if trace:
        prof = traffic["profile"]
        rec.profile = devtrace.Profile(torch, prof["pad_s"])
        rec.profile.warm()
        first = 1 + prof["skip_chunks"]
        rec.traced = list(range(first, first + prof["chunks"]))
    else:
        rec.closed.set()
    if torch.device(device).type == "cuda":
        # the kernel library: built here on a checkout's first run, and
        # only loaded on later ones; its seconds are reported apart
        from gapflow_torch.ops import _build
        run.counters["built"] = int(not _build.library_path().is_file())
        t0 = time.perf_counter()
        _build.load()
        run.spans["library"] = time.perf_counter() - t0
    want = cell.config["route"]
    uninstall = route(want, root).install(rec)
    try:
        # the warm-up chunk: the route, library and kernels the window
        # runs, and the program's handler of termination signals
        p.max_it = traffic["warmup_steps"]
        t_warm = time.perf_counter()
        p.run()
        if p._route != want:
            raise RuntimeError(f"the run took the route {p._route!r}, not "
                               f"{want}")
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t_warm = time.perf_counter() - t_warm
        p.max_it = traffic["max_it"]
        run.spans["setup"] = time.time() - t_start

        step0, chunk0 = p.step, len(rec.steps)
        fired, done = threading.Event(), threading.Event()

        def stop():
            # SIGTERM after the window's seconds, and not before a traced
            # run's profile has closed
            if done.wait(seconds):
                return
            rec.closed.wait(300)
            if not done.is_set():
                fired.set()
                os.kill(os.getpid(), signal.SIGTERM)

        stopper = threading.Thread(target=stop)
        w0 = time.perf_counter()
        stopper.start()
        p.run()
        w1 = time.perf_counter()
        done.set()
        stopper.join()
        rec.close()
    finally:
        uninstall()
    run.spans["window"] = w1 - w0
    run.calls = [t - w0 for t in rec.calls[chunk0:]]
    gaps = np.diff(run.calls)
    if len(gaps):
        print(f"benchmark: chunk calls every {np.median(gaps) * 1e3:.2f} ms "
              f"(median; {gaps.min() * 1e3:.2f}-{gaps.max() * 1e3:.2f}); "
              f"first call {run.calls[0] * 1e3:.1f} ms in, last "
              f"{(run.spans['window'] - run.calls[-1]) * 1e3:.1f} ms before "
              "the end")
    print(f"benchmark: set-up {run.spans['setup']:.2f} s (to the imports "
          f"{t_imports:.2f}, problem_init {run.spans['problem_init']:.2f}, "
          f"kernel library {run.spans.get('library', 0.):.2f}, built "
          f"{run.counters.get('built', 0)}, warm-up chunk {t_warm:.2f}), "
          f"window {run.spans['window']:.2f} s")
    run.counters.update(
        cells=traffic["Nx"] * traffic["Ny"], steps=p.step - step0,
        chunks=len(rec.steps) - chunk0, converged=int(p.converged))
    # the program stops early on its own only on an invalid state or at
    # convergence
    run.counters["invalid"] = int(not fired.is_set()
                                  and not run.counters["converged"])
    run.trace = rec.profile.trace if rec.profile is not None else None
    run.device_kind = device_name(torch, device)

    result = {"correct": False, "attempted": run.counters["chunks"],
              "failed": run.counters["invalid"]}
    metrics = cell.per_layer if trace else cell.end_to_end
    result["metrics"] = {}
    for m in metrics:
        value = reader(m["name"], root)(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = device_info(torch, device, cell.chips)
    if run.trace is not None and run.trace.window() is not None:
        t_a, t_b = run.trace.window()
        result["device"]["busy_s"] = run.trace.busy(t_a, t_b) * 1e-6
        result["device"]["window_s"] = (t_b - t_a) * 1e-6
        result["breakdown"] = run.trace.breakdown()
    if trace:
        result["card"] = card()
    result["counters"] = run.counters
    # the kernel library's build and load, inside setup_s: a checkout's
    # first run builds it (counters' "built" is 1), later runs load it
    result["library_s"] = run.spans.get("library", 0.)

    # the program's outputs to the host and its device memory freed, once
    # the window has closed and the peak is read
    final = p.q.copy()
    pressure = p.fc.get_real_field("pressure").p.copy()
    last = rec.last[2].cpu()
    if rec.sample not in rec.kept:      # the run ended before the drawn chunk
        rec.sample = rec.last[0]
        rec.kept[rec.sample] = rec.last
    progs = {i: dict(start, chunk=(i, q_in.cpu(), q_out.cpu(), dt, n),
                     final=final, last=last, pressure=pressure)
             for i, (_, q_in, q_out, dt, n) in rec.kept.items()}
    rec.kept.clear()
    rec.last = None
    del p
    gc.collect()
    if os.path.isdir(outdir):           # a database's training data
        shutil.rmtree(outdir)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cfg_run = dict(cell.config, **{k: sections[k] for k in
                                   ("grid", "geometry", "numerics")})
    return result, progs, cfg_run, rho0


def device_name(torch, device):
    if torch.device(device).type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(torch.device(device))


def device_info(torch, device, chips):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": device_name(torch, device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                torch.device(device)))}


def card():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return (res.stdout or res.stderr).strip()


def forbidden_modules(modules):
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
