"""Device time of the port's own kernels per step over the traced
chunks, in microseconds (the kernels are told apart by
``devtrace.is_port_kernel``; PyTorch's reductions for the chunk
statistics and its copies are not counted)."""


def read(run):
    t = run.trace
    if t is None or not t.complete():
        return None
    return sum(op["dur"] for op in t.chunk_kernels()) / sum(t.chunk_steps)
