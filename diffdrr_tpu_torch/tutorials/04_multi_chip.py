"""Several devices: meshes, sharded rendering, and slab-sharded volumes.

This capability has no reference counterpart: the reference is a
single-process, single-GPU library. The port distributes rendering over a
``torch.distributed`` device mesh, one process per device, three
independent ways, all composable:

* **data parallel**: the pose batch splits across the ``data`` mesh axis;
* **ray sharding**: each image's detector pixels split across the ``rays``
  axis, the volume replicated;
* **slab sharding**: the *volume* splits into march-axis slabs, one per
  rank, with a single all-reduce combining the partial line integrals.
  This is the larger-than-one-card path: no rank holds the whole CT.

With ``--cpu`` the script launches a world of 4 ranks, each a process of
this script joined by gloo through a ``file://`` rendezvous, as the port's
tests run them. Without it, on the card, it runs a world of one
(``make_mesh()`` wires it); ``torchrun --nproc-per-node N`` with
``--ranks-from-env`` runs it on N cards over NCCL.

Run:  python diffdrr_tpu_torch/tutorials/04_multi_chip.py [--cpu]
"""

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

CPU_WORLD = 4


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="ranks on the CPU (gloo)")
    p.add_argument("--rank", type=int, help="(a launched rank) this process's rank")
    p.add_argument("--world", type=int, help="(a launched rank) the number of ranks")
    p.add_argument("--rendezvous", help="(a launched rank) file:// or tcp:// address")
    p.add_argument("--ranks-from-env", action="store_true",
                   help="join the world torchrun describes (WORLD_SIZE, RANK, ...)")
    return p.parse_args()


def launch(world: int) -> None:
    """Start ``world`` ranks of this script on the CPU and wait for them."""
    with tempfile.TemporaryDirectory(prefix="tutorial04_") as tmp:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--cpu", "--rank", str(r), "--world", str(world),
             "--rendezvous", f"file://{tmp}/rdv"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
    print(outs[0], end="")
    failed = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    for r, rc, out in failed:
        print(f"rank {r} exited {rc}:\n{out}")
    assert not failed, f"{len(failed)} of {world} ranks failed"


def main(args) -> None:
    import torch.distributed as dist

    from diffdrr_tpu_torch import DRR, convert, load_example_ct
    from diffdrr_tpu_torch.ops.joseph import choose_march_axis, joseph_raycast
    from diffdrr_tpu_torch.ops.siddon import siddon_raycast
    from diffdrr_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                            make_reconstruction_step, make_sharded_render,
                                            slab_sharded_joseph, slab_sharded_siddon)

    device = "cpu" if args.cpu else None
    if args.rank is not None:
        initialize_distributed(args.rendezvous, args.world, args.rank, device=device)
    elif args.ranks_from_env:
        initialize_distributed(device=device)
    mesh = make_mesh(devices=device)  # a world of one if nothing was wired
    n = dist.get_world_size()
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"{n} ranks on {dist.get_backend()}")

    subject = load_example_ct(shape=(48, 48, 24), device=device)
    H = 32
    drr = DRR(subject, sdd=1020.0, height=H, delx=12.0, renderer="trilinear", device=device)
    dev = drr.device
    rot = torch.tensor([[0.0, np.pi / 2, 0.0]], device=dev)
    trans = torch.tensor([[0.0, 850.0, 0.0]], device=dev)
    KW = dict(parameterization="euler_angles", convention="ZXY", n_points=100)

    # -----------------------------------------------------------------------
    # 1. DP x ray sharding. A (data, rays) mesh: pose batch over `data`,
    # each image's pixels over `rays`. `make_sharded_render` returns a
    # render that every rank calls; each renders its block and all-gathers.
    # -----------------------------------------------------------------------
    data_dim = 2 if n % 2 == 0 else 1
    mesh2 = make_mesh((data_dim, n // data_dim), ("data", "rays"), devices=device)
    say("mesh:", dict(zip(mesh2.mesh_dim_names, mesh2.shape)))
    render = make_sharded_render(drr, mesh2, "euler_angles", "ZXY", n_points=100)
    B = 4
    rot_b = rot.repeat(B, 1) + 0.02 * torch.arange(B, device=dev)[:, None]
    trans_b = trans.repeat(B, 1)
    with torch.no_grad():
        imgs = render(rot_b, trans_b)
        ref = drr(rot_b, trans_b, **KW)
    assert imgs.shape == (B, 1, H, H)
    assert torch.equal(imgs, ref)  # each rank cuts its share of the same rays
    say("DP x ray-sharded render equals the one-device render bit for bit: OK")

    # -----------------------------------------------------------------------
    # 2. Slab sharding: the volume itself is split into march-axis slabs,
    # one per rank (one all-reduce). Joseph's samples stay inside single
    # planes, so the decomposition is exact: no halo exchange.
    # -----------------------------------------------------------------------
    mesh1 = make_mesh((1, n), ("data", "rays"), devices=device)
    drr_j = DRR(subject, sdd=1020.0, height=H, delx=12.0, renderer="joseph", device=device)
    pose = convert(rot, trans, parameterization="euler_angles", convention="ZXY")
    with torch.no_grad():
        source, target = drr_j.detector(pose, None)
        weights = torch.linalg.vector_norm(target - source, dim=-1)[:, None, :]
        source_v, target_v = drr_j.affine_inverse(source), drr_j.affine_inverse(target)
        march_axis = choose_march_axis(source_v, target_v)
        img_slab = slab_sharded_joseph(drr_j.density, source_v, target_v, weights, mesh1,
                                       "rays", march_axis=march_axis)
        img_full = joseph_raycast(drr_j.density, source_v, target_v, weights, axis=march_axis)
    torch.testing.assert_close(img_slab, img_full, rtol=1e-4,
                               atol=1e-4 * float(img_full.abs().max()))
    say("slab-sharded Joseph (volume split across ranks) matches: OK")

    # The EXACT Siddon renderer slab-shards too: slab boundaries are grid
    # planes, which are already Siddon segment boundaries, so each segment
    # lands on exactly one rank and one all-reduce restores the integral.
    with torch.no_grad():
        img_slab_s = slab_sharded_siddon(drr_j.density, source_v, target_v, weights, mesh1,
                                         "rays", slab_axis=0)
        img_full_s = siddon_raycast(drr_j.density, source_v, target_v, weights)
    torch.testing.assert_close(img_slab_s, img_full_s, rtol=1e-4,
                               atol=1e-4 * float(img_full_s.abs().max()))
    say("slab-sharded exact Siddon matches: OK")

    # -----------------------------------------------------------------------
    # 3. Distributed reconstruction: views shard over `data`, rays over
    # `rays`; the density gradient is all-reduced, so every rank takes the
    # same Adam step and the density stays replicated.
    # -----------------------------------------------------------------------
    n_views = 8
    angles = np.linspace(0, np.pi, n_views, endpoint=False)
    rot_v = torch.tensor([[a, np.pi / 2, 0.0] for a in angles], dtype=torch.float32, device=dev)
    trans_v = trans.repeat(n_views, 1)
    with torch.no_grad():
        measured = drr(rot_v, trans_v, **KW)
    init_fn, step_fn = make_reconstruction_step(drr, mesh2, lr=5e-2, n_points=100)
    density, opt = init_fn(torch.zeros_like(drr.density))
    losses = []
    for _ in range(10):
        density, opt, loss = step_fn(density, opt, rot_v, trans_v, measured)
        losses.append(float(loss))
    say(f"distributed reconstruction: mse {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0]
    dist.destroy_process_group()
    say("tutorial 04: all checks passed")


if __name__ == "__main__":
    args = parse_args()
    if args.cpu and args.rank is None:
        launch(CPU_WORLD)
    else:
        main(args)
