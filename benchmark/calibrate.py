"""Readings that the limits of a cell are set from, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 --control 3 \\
        --faults half --seconds 2 --out chiprun_out/cal_<name>.json

runs the cell's program (on ``--traffic``'s mix, when given; with
``--metric-float64`` its image metric in float64, a witness) on ``--seeds`` seeds (the lower readings), its
control on ``--control`` seeds (the program with its bf16 density copy,
``storage="bf16"``: the nearest precision below the float32 the
configuration states) and each ``--faults`` entry (``faults.py``) on three
seeds, each run as ``run.py`` runs it at ``--seconds`` (the kernels built
once for all). It prints each run's compared numbers and the lowest and
highest of each over the program, the control and each fault, and writes
them as JSON to ``--out``. No run of the benchmark runs this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    from benchmark import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_100_000_000)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--traffic", default=None,
                    help="run the cell on this traffic file's mix instead of its own")
    ap.add_argument("--metric-float64", action="store_true",
                    help="the witness: the program's image metrics computed in float64")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    if args.traffic:
        cell.traffic = harness.load_json(cell.root / "traffic" / f"{args.traffic}.json")
    if args.metric_float64:
        from diffdrr_tpu_torch import metrics

        ncc = metrics.MultiscaleNormalizedCrossCorrelation2d.__call__
        metrics.MultiscaleNormalizedCrossCorrelation2d.__call__ = (
            lambda self, x1, x2: ncc(self, x1.double(), x2.double()).float())
    plan = [("program", None, None, args.first_seed + i) for i in range(args.seeds)]
    plan += [("control", "bf16", None, args.first_seed + 1000 + i) for i in range(args.control)]
    for f in filter(None, args.faults.split(",")):
        plan += [(f"fault:{f}", None, f, args.first_seed + 2000 + i) for i in range(3)]
    runs = []
    for what, storage, fault, seed in plan:
        t0 = time.perf_counter()
        with faults.planted(fault):
            r = harness.run_cell(cell, seed, args.seconds, False, storage=storage,
                                 log=lambda m: None)
        checks = {k: v["value"] for k, v in r["checks"].items()}
        metrics = {k: v["value"] for k, v in r["metrics"].items()}
        runs.append(dict(what=what, seed=seed, checks=checks, metrics=metrics,
                         correct=r["correct"], seconds=time.perf_counter() - t0))
        print(json.dumps(runs[-1]), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for what in dict.fromkeys(r["what"] for r in runs):
        rs = [r for r in runs if r["what"] == what]
        summary[what] = {k: [min(r["checks"][k] for r in rs), max(r["checks"][k] for r in rs)]
                         for k in rs[0]["checks"]}
    print(json.dumps({"summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "runs": runs,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
