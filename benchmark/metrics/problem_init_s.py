"""The harness's host span around the configuration's parsing, the
construction of ``Problem``, the initial density written into it and
``Problem._pre_run()`` (with its first copy to the device)."""


def read(run):
    return run.spans["problem_init"]
