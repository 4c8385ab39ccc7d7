"""Animate a logged registration run: a CSV trace of poses -> a GIF.

Counterpart of ``experiments/gif.py`` (the JAX package's CLI), with its
arguments and defaults on ``argparse``. The CSV must carry the pose columns
r1 r2 r3 tx ty tz (as a registration trace that logs its poses writes);
a run without them cannot be animated. The CSV is read with the ``csv``
module, the example CT of ``--volume-size`` is rendered with the trilinear
renderer at each row's pose (``viz.animate``), and the frames are written
with imageio (matplotlib draws them). It runs on the CUDA card unless
``--cpu``. ``main(argv)`` returns the path it wrote.

    python -m diffdrr_tpu_torch.experiments.gif trace.csv run.gif
    python -m diffdrr_tpu_torch.experiments.gif --cpu --volume-size 32 --height 16 \\
        trace.csv run.gif
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import List, Optional, Sequence

from ..data import load_example_ct
from ..drr import DRR
from ..viz import animate

POSE_COLUMNS = ("r1", "r2", "r3", "tx", "ty", "tz")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action=argparse.BooleanOptionalAction, default=False,
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("csv_path")
    p.add_argument("out_path")
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--volume-size", type=int, default=256)
    return p.parse_args(argv)


def read_trace(csv_path) -> List[dict]:
    """The trace's rows as ``csv.DictReader`` gives them; raises
    ``ValueError`` (the JAX CLI's message) without the pose columns."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        columns = set(reader.fieldnames or ())
    required = set(POSE_COLUMNS)
    if not required.issubset(columns):
        raise ValueError(f"{csv_path} lacks pose columns {sorted(required)}; "
                         "log poses during registration to animate them.")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    rows = read_trace(args.csv_path)
    vs = args.volume_size
    subject = load_example_ct(shape=(vs, vs, max(16, vs // 4)), device=device)
    drr = DRR(subject, sdd=1020.0, height=args.height, delx=2.0, renderer="trilinear",
              device=device)
    out = animate(args.out_path, rows, drr)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
