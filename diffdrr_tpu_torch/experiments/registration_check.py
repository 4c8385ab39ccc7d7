#!/usr/bin/env python3
"""The main cell's Siddon registration, with the patch NCC's statistics in
float32 or in float64, and with the target perturbed or not.

    python3 -m diffdrr_tpu_torch.experiments.registration_check \
        [--device cpu|cuda] [--float64] [--perturb 1e-6] [--steps 60]

The cell of ``chip_smoke.py`` phase 4: the 512x512x133 example CT, a
200x200 detector (sdd 1020 mm, 2 mm pixels), the bench pose, the target
rendered there with the march axis pinned to 2, then Adam (lr 1e-3 rotation,
1e-1 translation) on multiscale NCC (whole image and 13x13 patches, half
each) from translation + 5 mm on each axis. By default the metric is the
port's, whose patch statistics come from float32 cumulative sums as the JAX
package's do; ``--float64`` runs the same metric on float64 copies of the
two images, to see what that rounding does to the trajectory. ``--perturb e``
multiplies the target by 1 + e * N(0, 1) noise (seed 0), to see whether the
trajectory follows the landscape or the rounding. Prints the score and the
translation error (x, y, z) every 10 steps and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from diffdrr_tpu_torch import DRR, load_example_ct
from diffdrr_tpu_torch.metrics import MultiscaleNormalizedCrossCorrelation2d, ncc2d
from diffdrr_tpu_torch.registration import make_registration_step

ROT = [[0.01, math.pi / 2 + 0.02, -0.01]]
TRANS = [[0.0, 850.0, 0.0]]


def multiscale_ncc_float64(x1, x2):
    """The port's multiscale NCC (whole image and 13x13 patches, half each)
    with the patch term taken on float64 copies of the images."""
    return 0.5 * ncc2d(x1, x2) + 0.5 * ncc2d(x1.double(), x2.double(), 13).to(x1.dtype)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--float64", action="store_true",
                        help="patch statistics in float64 (the port's are float32)")
    parser.add_argument("--perturb", type=float, default=0.0)
    parser.add_argument("--steps", type=int, default=60)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    kw = dict(parameterization="euler_angles", convention="ZXY")
    drr = DRR(load_example_ct(device=dev), sdd=1020.0, height=200, delx=2.0, device=dev)
    rot, trans = torch.tensor(ROT, device=dev), torch.tensor(TRANS, device=dev)
    target = drr(rot, trans, axis=2, **kw)
    if args.perturb:
        gen = torch.Generator().manual_seed(0)
        target = target * (1 + args.perturb * torch.randn(target.shape, generator=gen).to(dev))
    metric = MultiscaleNormalizedCrossCorrelation2d([None, 13], [0.5, 0.5])
    if args.float64:
        metric = multiscale_ncc_float64
    init_fn, step_fn = make_registration_step(drr, target, "euler_angles", "ZXY", metric=metric,
                                              lr_rotation=1e-3, lr_translation=1e-1)
    params, opt = init_fn(rot, trans + 5.0)
    trace = []
    for i in range(args.steps):
        params, opt, score = step_fn(params, opt)
        err = (params["translation"].detach() - trans)[0].tolist()
        trace.append({"step": i, "score": float(score), "translation_error": err})
        if i % 10 == 0 or i == args.steps - 1:
            print(f"[registration_check] step {i}: score {float(score):.5f}, translation error "
                  f"({err[0]:.3f}, {err[1]:.3f}, {err[2]:.3f}) mm", flush=True)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": device, "float64": args.float64, "perturb": args.perturb,
                      "final": trace[-1], "trace": trace[::10]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
