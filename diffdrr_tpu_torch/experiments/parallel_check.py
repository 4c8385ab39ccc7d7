"""One rank of a multi-rank check of ``parallel`` at the main cell's width.

``chip_smoke.py``'s phase 11b starts two of these on the one card, joined
by gloo (NCCL refuses two ranks on one device), with a ``file://``
rendezvous; on several cards ``torchrun`` starts one a card, on NCCL:

    python -m diffdrr_tpu_torch.experiments.parallel_check --rank R --world 2 \\
        --rendezvous file:///tmp/rdv --out /tmp/rank%d.json
    torchrun --nproc-per-node 4 -m diffdrr_tpu_torch.experiments.parallel_check \\
        --backend nccl --out ranks/rank%d.json

On the 512x512x133 example CT and a 200x200 detector (sdd 1020 mm, 2 mm
pixels), each rank:

  1. probes which collectives its backend takes on CUDA tensors (the port
     uses ``all_reduce`` and ``all_gather``, which must work; the rest are
     reported);
  2. renders 2 poses sharded along rays ``(1, W)`` and along data ``(W, 1)``,
     Siddon and trilinear, against the unsharded render on the card (equal
     bit for bit: each rank cuts its block from the whole batch's rays), and
     the pose gradients of both against the unsharded one (1e-5 x max);
  3. renders ``slab_sharded_siddon`` and ``slab_sharded_joseph`` with
     ``use_pallas=True`` (the CUDA kernels), W slabs along axis 0 at the
     lateral pose, a value call and a gradient call, the launches of each
     counted, against the unsharded kernel render: values within 1e-4 x max;
     each ray's source and target gradients within ``ROW_REL`` x max, and
     the density gradient of the rank's slab within ``DENSITY_REL`` x max
     (Siddon's segment lengths, differences of alphas near 1, carry ~1e-4 of
     rounding that another frame rounds otherwise), but for a few items: in
     slab-local coordinates a ray within float32 rounding of a kink rounds
     to its other side (one Siddon ray of 40,000 at this pose passes an edge
     where an x-plane meets a z-plane; a Joseph sample sits at the end of
     its interval), so up to ``KINK_RAYS`` rays a slab boundary and
     ``KINK_VOXELS`` voxels a rank may be off by up to ``KINK_ROW_REL`` and
     ``KINK_VOXEL_REL`` x max;
  4. runs the sharded Siddon reconstruction step on the 8 views of
     ``chip_smoke.py``'s phase 4c, ``(W, 1)``, ``RECON_STEPS`` steps from
     zero, recording each step's loss, launches, CUDA-event ms and a hash of
     the density (the ranks' must agree), and times the step's collectives
     alone;
  5. rank 0 profiles one more step under ``profiling.trace`` into ``trace/``
     beside its record.

It writes its record as JSON to ``--out % rank`` and fails (non-zero exit)
on any check that does not hold.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# Two poses of the main cell (the bench pose first), both marching axis 2.
POSE_ROT = [[0.01, np.pi / 2 + 0.02, -0.01], [0.03, np.pi / 2 - 0.01, 0.005]]
POSE_TRANS = [[0.0, 850.0, 0.0], [2.0, 847.0, 1.0]]
LATERAL_ROT = [[np.pi / 2 + 0.02, 0.01, -0.01]]
N_VIEWS = 8
RECON_LR = 5e-2
RECON_STEPS = 5
# The slab gradients' limits, x the unsharded gradient's max, and the few
# items that rounding at a kink may take past them (observed on the H100,
# 2 and 4 ranks: 1-4 rays off by at most 1.5e-2 x max, 4 voxels of one
# Joseph sample by 9.1e-2 x max; Siddon's density gradient 1.73e-4 x max).
ROW_REL = 1e-3
DENSITY_REL = 3e-4
KINK_RAYS = 2  # a slab boundary
KINK_VOXELS = 8  # a rank: one Joseph sample's corners
KINK_ROW_REL = 5e-2
KINK_VOXEL_REL = 0.15
KW = dict(parameterization="euler_angles", convention="ZXY")


def _max_err(got, ref) -> float:
    return float((got - ref).abs().max())


def _check(name, got, ref, rel) -> float:
    err, scale = _max_err(got, ref), float(ref.abs().max())
    if not err <= rel * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} > {rel:g} x max {scale:.3e}")
    return err


def _check_most(name, got, ref, rel, most, kink_rel, width=1) -> dict:
    """``got`` within ``rel`` x max of ``ref`` but for at most ``most`` of
    its items (``width`` numbers each: a ray's 3 gradient components, a
    voxel), and those within ``kink_rel`` x max: where a ray passes within
    float32 rounding of a kink (an edge where two planes meet, a sample at
    the end of its interval), the slab-local frame rounds it to the other
    side, and its derivative, or the voxel it lands in, changes."""
    err = (got - ref).abs().reshape(-1, width).amax(-1)
    scale = float(ref.abs().max())
    beyond, worst = int((err > rel * scale).sum()), float(err.max())
    if beyond > most or worst > kink_rel * scale:
        raise AssertionError(f"{name}: {beyond} of {err.numel()} beyond {rel:g} x max "
                             f"{scale:.3e} (at most {most}), max abs err {worst:.3e} "
                             f"(at most {kink_rel:g} x max)")
    return {"beyond": beyond, "of": err.numel(), "beyond_1e-4": int((err > 1e-4 * scale).sum()),
            "max_abs_err": worst, "max": scale}


def _expect(name, want):
    """The launches since the counts were reset: ``want`` and no other."""
    from ..ops.kernels import launch_counts, no_other_launches

    torch.cuda.synchronize()
    got = launch_counts()
    no_other_launches(name, got, want)
    return {k: v for k, v in got.items() if v}


def probe_collectives(device) -> dict:
    """Which collectives the backend takes on CUDA tensors (beyond the two
    the port needs, which run unguarded)."""
    x = torch.ones(8, device=device)
    dist.all_reduce(x)
    dist.all_gather([torch.empty_like(x) for _ in range(dist.get_world_size())], x)
    out = {"all_reduce": "ok", "all_gather": "ok"}
    probes = {
        "broadcast": lambda: dist.broadcast(x, src=0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * dist.get_world_size(), device=device), x),
        "broadcast_object_list": lambda: dist.broadcast_object_list([1], src=0),
    }
    for name, call in probes.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:  # recorded: the port does not use these
            out[name] = f"refused: {str(e).splitlines()[0][:120]}"
    return out


def renders(T, subject, world, rec) -> None:
    """Step 2: sharded renders and the pose gradient against the card's own."""
    from ..ops.kernels import reset_launch_counts
    from ..parallel import make_mesh, make_sharded_render, shard_drr

    rot = torch.tensor(POSE_ROT, device="cuda")
    trans = torch.tensor(POSE_TRANS, device="cuda")
    for renderer in ("siddon", "trilinear"):
        drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0, renderer=renderer)
        ref = drr(rot, trans, **KW)
        for shape in ((1, world), (world, 1)):
            render = make_sharded_render(drr, make_mesh(shape), **KW)
            reset_launch_counts()
            got = render(rot, trans)
            fwd = "siddon_fwd" if renderer == "siddon" else "joseph_fwd"
            _expect(f"{renderer} {shape} render", {fwd: 1})  # the CT's copy is cached
            key = f"{renderer}{shape}"
            if not torch.equal(got, ref):
                raise AssertionError(f"{key}: the split render is not the unsharded one bit for "
                                     f"bit (max abs err {_max_err(got, ref):.3e})")
            rec["renders"][key] = {"bit_equal": True}
        ray_split = shard_drr(drr, make_mesh((1, world)))
        data_split = make_sharded_render(drr, make_mesh((world, 1)), **KW)
        grads = {}
        for split, fn in (("none", lambda r: drr(r, trans, **KW)),
                          ("rays", lambda r: ray_split(r, trans, **KW)),
                          ("data", lambda r: data_split(r, trans))):
            r = rot.clone().requires_grad_(True)
            torch.sum(fn(r) ** 2).backward()
            grads[split] = r.grad
        for split in ("rays", "data"):
            key = f"{renderer} pose gradient, {split} split"
            rec["renders"][key] = {"max_abs_err": _check(key, grads[split], grads["none"], 1e-5),
                                   "max": float(grads["none"].abs().max())}


def slabs(T, subject, world, rank, rec) -> None:
    """Step 3: the slab renderers on the kernels, W slabs along axis 0."""
    from ..ops.kernels import reset_launch_counts
    from ..ops.kernels.joseph import joseph_march_raycast
    from ..ops.kernels.siddon import siddon_slab_raycast
    from ..parallel import make_mesh, slab_sharded_joseph, slab_sharded_siddon

    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0)
    pose = T.convert(torch.tensor(LATERAL_ROT, device="cuda"),
                     torch.tensor([POSE_TRANS[0]], device="cuda"), **KW)
    source, target = drr.detector(pose)
    w = torch.linalg.vector_norm(target - source, dim=-1)[:, None, :]
    sv, tv = drr.affine_inverse(source), drr.affine_inverse(target)
    if int(np.argmin(drr.worst_ratios(sv, tv).tolist())) != 0:
        raise AssertionError("the lateral pose does not march axis 0")
    mesh = make_mesh((world,), ("rays",))
    n = drr.density.shape[0] // world
    cases = {
        "siddon": (lambda v, s, t: slab_sharded_siddon(v, s, t, w, mesh, slab_axis=0,
                                                       use_pallas=True),
                   lambda v, s, t: siddon_slab_raycast(v, s, t, w, axis=0),
                   ("siddon_fwd", "siddon_fwdgrad", "siddon_bwd_vol")),
        "joseph": (lambda v, s, t: slab_sharded_joseph(v, s, t, w, mesh, march_axis=0,
                                                       use_pallas=True),
                   lambda v, s, t: joseph_march_raycast(v, s, t, w, axis=0, step=1.0),
                   ("joseph_fwd", "joseph_fwdgrad", "joseph_bwd_vol")),
    }
    g = torch.tensor(np.random.default_rng(3).normal(size=(1, 1, tv.shape[1])),
                     dtype=torch.float32, device="cuda")
    for name, (sharded, whole, (fwd, fwdgrad, bwd_vol)) in cases.items():
        out = {}
        for fn in (whole, sharded):  # the unsharded kernel render first, uncounted
            # The source a ray (B, N, 3): each ray's own gradient, compared ray
            # by ray (the shared source's, their sum, is recorded too).
            vol = drr.density.clone().requires_grad_(True)
            s = sv.expand_as(tv).clone().requires_grad_(True)
            t = tv.clone().requires_grad_(True)
            if fn is sharded:
                reset_launch_counts()
            with torch.no_grad():
                value = fn(vol.detach(), s.detach(), t.detach())
            if fn is sharded:
                out["value_launches"] = _expect(f"{name} slab value", {fwd: 1, "brick_copy": 1})
                reset_launch_counts()
            torch.sum(fn(vol, s, t) * g).backward()
            if fn is sharded:
                out["grad_launches"] = _expect(f"{name} slab gradient",
                                               {fwdgrad: 1, bwd_vol: 1, "brick_copy": 1})
            mine = vol.grad.narrow(0, rank * n, n)
            out[fn is sharded] = (value, s.grad, t.grad, mine,
                                  int(torch.count_nonzero(vol.grad) - torch.count_nonzero(mine)))
        (v1, s1, t1, d1, _), (v2, s2, t2, d2, rest) = out[False], out[True]
        if rest != 0:
            raise AssertionError(f"{name} slab: a density gradient outside the rank's slab")
        total = s1.sum(dim=(0, 1))
        rays = KINK_RAYS * (world - 1)
        rec["slabs"][name] = {
            "value_err": _check(f"{name} slab value", v2, v1, 1e-4),
            "summed_source_err": _max_err(s2.sum(dim=(0, 1)), total),
            "summed_source_max": float(total.abs().max()),
            "source": _check_most(f"{name} slab source gradient", s2, s1, ROW_REL, rays,
                                  KINK_ROW_REL, 3),
            "target": _check_most(f"{name} slab target gradient", t2, t1, ROW_REL, rays,
                                  KINK_ROW_REL, 3),
            "density": _check_most(f"{name} slab density gradient", d2, d1, DENSITY_REL,
                                   KINK_VOXELS, KINK_VOXEL_REL),
            "value_max": float(v1.abs().max()),
            "launches_value": out["value_launches"], "launches_gradient": out["grad_launches"]}


def reconstruction(T, subject, world, rank, log_dir, rec) -> None:
    """Steps 4 and 5: the sharded Siddon reconstruction step, (W, 1)."""
    from ..ops.kernels import reset_launch_counts
    from ..parallel import make_mesh, make_reconstruction_step
    from ..profiling import trace

    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0)
    thetas = np.linspace(0, np.pi, N_VIEWS, endpoint=False)
    rot = torch.tensor(np.stack([thetas, np.full(N_VIEWS, np.pi / 2), np.zeros(N_VIEWS)], 1),
                       dtype=torch.float32, device="cuda")
    trans = torch.tensor([POSE_TRANS[0]] * N_VIEWS, device="cuda")
    measured = drr(rot, trans, **KW)
    init_fn, step_fn = make_reconstruction_step(drr, make_mesh((world, 1)), lr=RECON_LR)
    dens, opt = init_fn(torch.zeros_like(drr.density))
    losses, hashes, ms, launches = [], [], [], []
    for _ in range(RECON_STEPS):
        reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dens, opt, loss = step_fn(dens, opt, rot, trans, measured)
        end.record()
        launches.append(_expect("reconstruction step", {"siddon_fwd": 1, "siddon_bwd_vol": 1,
                                                        "brick_copy": 1}))
        ms.append(start.elapsed_time(end))
        losses.append(loss.item())
        hashes.append(hashlib.sha256(dens.detach().cpu().numpy().tobytes()).hexdigest())
    rec["recon"] = {"losses": losses, "hashes": hashes, "step_ms": ms,
                    "step_ms_median": statistics.median(ms[1:]), "launches": launches[0]}
    # The step's collectives alone: the density gradient's all-reduce and a
    # scalar loss's; gloo stages CUDA tensors through the host.
    grad = torch.zeros_like(drr.density)
    scalar = torch.zeros((), device="cuda")
    for name, x in (("all_reduce_density_grad", grad), ("all_reduce_loss", scalar)):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rec["collectives_ms"][name] = statistics.median(times[1:])
    rec["collectives_ms"]["density_grad_bytes"] = grad.numel() * 4
    if rank == 0:
        with trace(log_dir) as prof:
            dens, opt, _ = step_fn(dens, opt, rot, trans, measured)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()}
        rec["trace"] = {"files": sorted(p.name for p in Path(log_dir).iterdir()),
                        "kernels": sorted(n for n in names if "_kernel" in n
                                          and ("siddon" in n or "brick" in n))}
    else:
        dens, opt, _ = step_fn(dens, opt, rot, trans, measured)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--rendezvous", default=None,
                   help="file:// or tcp:// rendezvous (default: torchrun's environment)")
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    p.add_argument("--out", required=True, help="the record's path, %%d for the rank")
    args = p.parse_args(argv)

    import diffdrr_tpu_torch as T
    from ..parallel import initialize_distributed

    initialize_distributed(args.rendezvous, args.world, args.rank, backend=args.backend)
    args.rank, args.world = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    rec = {"rank": args.rank, "world": args.world, "backend": dist.get_backend(),
           "device": torch.cuda.get_device_name(), "renders": {}, "slabs": {},
           "collectives_ms": {}}
    rec["collectives"] = probe_collectives(torch.device("cuda"))
    subject = T.load_example_ct()
    renders(T, subject, args.world, rec)
    slabs(T, subject, args.world, args.rank, rec)
    log_dir = str(Path(args.out % args.rank).parent / "trace")
    reconstruction(T, subject, args.world, args.rank, log_dir, rec)
    rec["seconds"] = time.perf_counter() - t0
    Path(args.out % args.rank).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out % args.rank).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
