"""Batched renders: ``DRR.__call__`` on a batch of poses, one after another.

Set-up draws a pool of pose batches from the seed (views over
``view_span`` as the reconstruction cells draw them, one offset a batch;
otherwise the config's pose plus seeded offsets) and renders two of them
(the build and the first calls). The timed step is one render of the
next batch, dispatched as soon as the last one returned, with no read-back
beyond the program's own. Correctness: the renders at
``kept`` seeded indices within the first ``trace_steps`` and the window's
last render are compared, pixel by pixel, with the reference's renders of
the same poses (``image_gap``: the widest distance of a pixel from the
values the reference allows it, over the reference's peak; a Joseph sample
within rounding of a ray's end may count either way).
"""

from __future__ import annotations

import torch

from .common import (POSE_KW, DriverBase, Inputs, Reference, block_rays, costs, program_drr,
                     widest_image_gap)


class Driver(DriverBase):
    def __init__(self, config: dict, traffic: dict, seed: int, device, storage=None):
        self.traffic = traffic
        self.inputs = Inputs(config, seed, device)
        B, pool = traffic["batch"], traffic["pool"]
        if "view_span" in traffic:
            self.rot, self.trans = self.inputs.views((pool,), B, traffic["view_span"])
        else:
            self.rot, self.trans = self.inputs.poses((pool, B), traffic)
        picks = torch.randperm(traffic["trace_steps"], generator=self.inputs.generator)[
            :traffic["kept"]]
        self.keep = set(int(i) for i in picks)
        self.drr = program_drr(self.inputs, storage)
        self.rays_per_step = B * self.drr.detector.height * self.drr.detector.width
        self.count, self.kept, self.last = 0, {}, None

    def setup(self) -> None:
        with torch.no_grad():
            for i in (-1, -2):
                self.drr(self.rot[i], self.trans[i], **POSE_KW)
        self.sync()

    def mark_trace(self) -> None:
        self.first_traced = self.count

    def step(self) -> int:
        i = self.count % self.rot.shape[0]
        with torch.no_grad():
            img = self.drr(self.rot[i], self.trans[i], **POSE_KW)
        if self.count in self.keep:
            self.kept[self.count] = img.clone()
        self.last = (self.count, img)
        self.count += 1
        return self.rays_per_step

    def release(self) -> None:
        n, img = self.last
        self.kept[n] = img.clone()
        self.kept = {k: v.cpu() for k, v in self.kept.items()}
        self.drr = self.last = None

    def costs(self) -> dict:
        kernel = "siddon_fwd" if self.inputs.config["renderer"] == "siddon" else "joseph_fwd"
        i = self.first_traced % self.rot.shape[0]
        return costs(self.inputs, self.rot[i], self.trans[i], {kernel: "fwd"})

    def compare(self, device) -> dict:
        ref = Reference(self.inputs, device, block_rays(self.inputs))
        gaps = []
        for n, img in sorted(self.kept.items()):
            i = n % self.rot.shape[0]
            want = ref.render(self.rot[i], self.trans[i], bounds=True)
            gaps.append(widest_image_gap(img.to(ref.device), want))
        return {"image_gap": max(gaps)}
