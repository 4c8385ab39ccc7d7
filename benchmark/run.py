"""Run one cell of the benchmark of ``diffdrr_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on two of the machine's cores. The last line
of standard output is the result, one JSON object; the numbers that
decided ``correct`` are its last key (``checks``) and the last lines of
standard error. Exits non-zero, with
no result, without a card (or fewer than the cell asks for), without the
program beside the benchmark, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def pin() -> None:
    """Keep the process on two cores of those it may use, the same two in
    every run: its host-paced loops then spread less between processes."""
    cores = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else []
    if len(cores) >= 4:
        os.sched_setaffinity(0, cores[2:4])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, flush=True)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, log=log)
    found = harness.banned_modules()
    if found:
        print(f"loaded modules that must not be: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    pin()
    sys.exit(main())
