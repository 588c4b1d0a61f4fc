"""From the start of the process to the first timed step: imports, the
CUDA context, the kernel library (built on a checkout's first run), the
Problem and one warm-up chunk."""


def read(run):
    return run.spans["setup"]
