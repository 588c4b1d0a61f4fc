"""The benchmark of gapflow_torch: one run of one cell of BENCHMARK.json.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA devices
as the cell asks for.  Prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown``
(``--trace 1``) and, last, ``checks``: every compared number with its
limit, which also close standard error.  Everything the program prints
goes to standard error.  Exits non-zero, printing no result, without
enough CUDA devices, or where JAX or the JAX package was loaded.
"""

import argparse
import contextlib
import json
import sys
import time

T_START = time.time()

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  args.trace,
                                  t_start=harness.process_start(T_START))
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
