"""The run's end after its last chunk, in seconds: from the last chunk
call to the return of ``Problem.run()``, less one median chunk interval
(the last chunk's own work): the statistics of the last chunk, the copy
of the state to the host and ``_refresh_det_fields``."""

import statistics


def read(run):
    if len(run.calls) < 3:
        return None
    chunk = statistics.median(b - a for a, b in zip(run.calls, run.calls[1:]))
    return run.spans["window"] - run.calls[-1] - chunk
