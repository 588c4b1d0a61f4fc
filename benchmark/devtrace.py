"""The device trace of a traced run: torch.profiler over a few chunks of
the window, padded with idle host time, read back from its Chrome trace.

torch.profiler keeps only the device events whose times, put on the
host's clock, fall inside its capture window, and the card's clock drifts
from the host's as a process ages: a few minutes in, a short unpadded
profile keeps no kernel.  So the profile opens ``pad_s`` seconds before
its first launch and closes ``pad_s`` seconds after the device finished
(as ``chip_smoke.profiled`` does; ``tests/profiler_drift.py`` shows the
loss and the cure).  The pads are idle by construction and lie outside
the traced window, which runs from the first to the last kernel of the
port in the profiled chunks.

Each traced chunk call runs inside a host range named ``chunk``
(``record_function``); a kernel belongs to the chunk whose range holds
the host call that launched it, matched by the profiler's correlation id.
"""

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CHUNK = "chunk"

# Kernels of PyTorch and of the CUDA libraries carry their namespaces in
# their names; every other kernel is the port's own (compiled from
# gapflow_torch/csrc), whatever a later change names it.
LIBRARY_MARKS = ("at::", "at_cuda_detail", "c10::", "cub::", "thrust::",
                 "cublas", "cudnn", "cutlass", "regular_fft", "vector_fft",
                 "nccl")


def is_port_kernel(op):
    return op["cat"] == "kernel" and not any(
        m in op["name"] for m in LIBRARY_MARKS)


class Profile:
    """``start()`` and ``stop()`` around a region of the run; ``trace``
    is then the :class:`Trace` of that region."""

    def __init__(self, torch, pad_s):
        self.torch, self.pad_s = torch, pad_s
        self.prof = None
        self.trace = None

    @property
    def active(self):
        return self.prof is not None

    def warm(self):
        """One empty profile: the first one in a process initialises the
        tracer, which takes seconds; let that be set-up."""
        self.start(pad=False)
        self.torch.zeros(1, device="cuda").sum()
        self.stop(pad=False)
        self.trace = None

    def start(self, pad=True):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(self.pad_s if pad else 0.)

    def stop(self, pad=True):
        self.torch.cuda.synchronize()
        time.sleep(self.pad_s if pad else 0.)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)
        finally:
            os.unlink(path)
        self.prof = None
        self.trace = Trace(events)


class Trace:
    """Device and host events (times in microseconds) of one profile."""

    def __init__(self, chrome):
        events = chrome["traceEvents"] if isinstance(chrome, dict) \
            else chrome
        self.device, self.host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            op = {"name": e.get("name", ""), "cat": e.get("cat", ""),
                  "ts": float(e["ts"]), "dur": float(e["dur"]),
                  "corr": (e.get("args") or {}).get("correlation")}
            if op["cat"] in DEVICE_CATS:
                self.device.append(op)
            elif op["cat"] in HOST_CATS:
                self.host.append(op)
        self.device.sort(key=lambda op: op["ts"])
        #: steps of each chunk profiled, in order (set by the harness)
        self.chunk_steps = []

    def complete(self):
        """Whether the trace holds the port's kernels of every traced
        chunk, each chunk a group of its own."""
        return bool(self.chunk_steps) and \
            len(self.chunks()) == len(self.chunk_steps)

    def window(self):
        """(start, end) of the traced window: the first to the last port
        kernel of the traced chunks; None without one."""
        port = self.chunk_kernels()
        if not port:
            return None
        return port[0]["ts"], max(op["ts"] + op["dur"] for op in port)

    def busy(self, t0, t1):
        """Microseconds in ``[t0, t1]`` in which a device op ran (the
        union of their intervals)."""
        total, end = 0., t0
        for op in self.device:
            a, b = max(op["ts"], end), min(op["ts"] + op["dur"], t1)
            if b > a:
                total += b - a
                end = b
        return total

    def chunks(self):
        """The port's kernels of each traced chunk that has any, in
        order: those whose launch lies in the chunk's host range."""
        spans = sorted((op["ts"], op["ts"] + op["dur"]) for op in self.host
                       if op["cat"] == "user_annotation"
                       and op["name"] == CHUNK)
        launched = {op["corr"]: op["ts"] for op in self.host
                    if op["cat"] in LAUNCH_CATS and op["corr"] is not None}
        groups = [[] for _ in spans]
        for op in filter(is_port_kernel, self.device):
            t = launched.get(op["corr"])
            for group, (a, b) in zip(groups, spans):
                if t is not None and a <= t <= b:
                    group.append(op)
                    break
        return [g for g in groups if g]

    def chunk_kernels(self):
        """The port's kernels of the traced chunks, in order."""
        return [op for group in self.chunks() for op in group]

    def gaps(self):
        """``(start, end)`` between one chunk's last port kernel and the
        next chunk's first."""
        groups = self.chunks()
        return [(max(op["ts"] + op["dur"] for op in a), b[0]["ts"])
                for a, b in zip(groups, groups[1:])]

    def idle_gaps(self):
        """``(start, end)`` of every interval of the traced window in
        which no device op ran."""
        win = self.window()
        if win is None:
            return []
        out, end = [], win[0]
        for op in self.device:
            if op["ts"] > end and op["ts"] < win[1]:
                out.append((end, op["ts"]))
            end = max(end, op["ts"] + op["dur"])
        return out

    def host_label(self, t0, t1):
        """What the host was doing in ``[t0, t1]``: the host event that
        overlaps it most (the shortest of equals); a chunk's range, which
        holds all the chunk call does, only where no other event does."""
        best, key = "host idle", (False, 0., 0.)
        for op in self.host:
            a, b = max(op["ts"], t0), min(op["ts"] + op["dur"], t1)
            inner = op["name"] != CHUNK or op["cat"] != "user_annotation"
            if b > a and (inner, b - a, -op["dur"]) > key:
                best, key = op["name"], (inner, b - a, -op["dur"])
        return best

    def breakdown(self, top=10):
        """The device ops that took most time and the longest idle gaps of
        the traced window, by name, in seconds."""
        win = self.window()
        if win is None:
            return None
        sums = {}
        for op in self.device:
            if win[0] <= op["ts"] <= win[1]:
                sums[op["name"]] = sums.get(op["name"], 0.) + op["dur"]
        ops = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s * 1e-6] for n, s in ops],
                "idle_gaps": [[self.host_label(a, b), (b - a) * 1e-6]
                              for a, b in gaps]}
