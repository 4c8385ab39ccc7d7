#!/usr/bin/env python3
"""The registration CLI's multistart against single-pose runs, on the card.

    python3 -m diffdrr_tpu_torch.experiments.multistart_check [--steps 60]

The registration CLI at ``--volume-size 512 --height 200`` (a 512x512x128
CT, 200x200 detector of 2 mm pixels, trilinear), its seed-0 starts for 4
restarts and its learning rates (Adam, 5e-3 rotation, 5e-1 translation).
First, at the starts, where a batch of four poses and four batches of one
part: the pose matrices, the world rays, the rays' lengths (the render's
weights), the voxel-space rays, the renders, and the multiscale NCC of the
same images batched and one at a time. Then ``make_multistart_step`` and
four single-pose ``make_registration_step`` runs in lockstep for
``--steps`` steps, with the CLI's metric, with ``var_floor`` 1e-3 and 1e-1,
and with the whole-image NCC alone: after steps 1, 2, 5, 10, 30 and 60 the
largest difference of score, rotation (rad) and translation (mm). Prints
the card's name and power limit first and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from diffdrr_tpu_torch import DRR, convert, load_example_ct
from diffdrr_tpu_torch.metrics import MultiscaleNormalizedCrossCorrelation2d as MultiscaleNCC
from diffdrr_tpu_torch.registration import make_multistart_step, make_registration_step

KW = dict(parameterization="euler_angles", convention="ZXY")
MARKS = (1, 2, 5, 10, 30, 60)


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=60)
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    drr = DRR(load_example_ct(shape=(512, 512, 128)), sdd=1020.0, height=200, delx=2.0,
              renderer="trilinear")
    dev = drr.device
    rot_true = torch.tensor([[0.0, np.pi / 2, 0.0]], device=dev)
    trans_true = torch.tensor([[0.0, 850.0, 0.0]], device=dev)
    with torch.no_grad():
        target = drr(rot_true, trans_true, **KW)
    rng = np.random.default_rng(0)  # the CLI's multistart draws
    rots = rot_true + torch.tensor(rng.normal(0, 0.06, (4, 3)).astype(np.float32), device=dev)
    transs = trans_true + torch.tensor(rng.normal(0, 12.0, (4, 3)).astype(np.float32), device=dev)

    metric = MultiscaleNCC([None, 13], [0.5, 0.5])
    parts = {k: 0.0 for k in ("matrix", "world target", "ray length", "voxel target", "render",
                              "score of one render batched")}
    with torch.no_grad():
        pose4 = convert(rots, transs, **KW)
        src4, tgt4 = drr.detector(pose4)
        imgs4 = drr(rots, transs, **KW)
        ones = []
        for i in range(4):
            pose = convert(rots[i:i + 1], transs[i:i + 1], **KW)
            src, tgt = drr.detector(pose)
            ones.append(drr(rots[i:i + 1], transs[i:i + 1], **KW))
            for key, a, b in (
                    ("matrix", pose.matrix, pose4.matrix[i:i + 1]),
                    ("world target", tgt, tgt4[i:i + 1]),
                    ("ray length", torch.linalg.vector_norm(tgt - src, dim=-1),
                     torch.linalg.vector_norm(tgt4 - src4, dim=-1)[i:i + 1]),
                    ("voxel target", drr.affine_inverse(tgt), drr.affine_inverse(tgt4)[i:i + 1])):
                parts[key] = max(parts[key], gap(a, b))
        ones = torch.cat(ones)
        parts["render"] = gap(imgs4, ones)
        single = torch.cat([metric(ones[i:i + 1], target) for i in range(4)])
        parts["score of one render batched"] = gap(metric(ones, target.expand_as(ones)), single)
        parts["score of the batched render"] = gap(metric(imgs4, target.expand_as(imgs4)), single)
    print("[parts] batch of 4 against 4 batches of 1, largest difference: "
          + ", ".join(f"{k} {v:.3e}" for k, v in parts.items())
          + f" (render max {imgs4.abs().max().item():.1f})", flush=True)

    lockstep = {}
    for name, m in (("the CLI's metric", metric),
                    ("var_floor 1e-3", MultiscaleNCC([None, 13], [0.5, 0.5], var_floor=1e-3)),
                    ("var_floor 1e-1", MultiscaleNCC([None, 13], [0.5, 0.5], var_floor=1e-1)),
                    ("whole-image NCC", MultiscaleNCC([None], [1.0]))):
        lr = dict(metric=m, lr_rotation=5e-3, lr_translation=5e-1)
        init4, step4 = make_multistart_step(drr, target, "euler_angles", "ZXY", **lr)
        p4, o4 = init4(rots, transs)
        runs = []
        for i in range(4):
            init1, step1 = make_registration_step(drr, target, "euler_angles", "ZXY", **lr)
            runs.append([step1, *init1(rots[i:i + 1], transs[i:i + 1])])
        rows = []
        for k in range(1, args.steps + 1):
            p4, o4, per = step4(p4, o4)
            scores = []
            for run in runs:
                run[1], run[2], score = run[0](run[1], run[2])
                scores.append(score)
            if k in MARKS or k == args.steps:
                rows.append({"step": k, "score": gap(per, torch.stack(scores)),
                             "rotation_rad": max(gap(p4["rotation"][i], r[1]["rotation"][0])
                                                 for i, r in enumerate(runs)),
                             "translation_mm": max(gap(p4["translation"][i], r[1]["translation"][0])
                                                   for i, r in enumerate(runs))})
        lockstep[name] = rows
        print(f"[lockstep] {name}: " + "; ".join(
            f"step {r['step']} {r['score']:.1e} / {r['rotation_rad']:.1e} rad / "
            f"{r['translation_mm']:.1e} mm" for r in rows), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "card": card, "parts": parts,
                      "lockstep": lockstep}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
