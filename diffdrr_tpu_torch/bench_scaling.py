"""Scaling efficiency of the port: a ray-sharded render on N ranks against one.

Counterpart of ``tools/bench_scaling.py``. Renders the same pose with the
detector's rays split over N ranks (``parallel.make_mesh`` and
``make_sharded_render``, one process a rank) and on one rank, and reports,
for each detector,

    efficiency = t_single / (N * t_sharded)

unclamped, with the all-gather that assembles the image, the only traffic
between ranks, reckoned as ``(N - 1) / N * B * H * W * 4`` bytes a rank a
step. The workload is the bench harness's (``bench.py``): the Joseph
renderer on the kernels, the 512x512x133 example CT, ``sdd=1020``, its pose
(Euler ZXY, march axis 2), at its detectors, 200x200 (2 mm pixels) and
1000x1000 (0.4 mm). The record's ``scaling_efficiency`` is the 1000x1000
detector's, the larger share of work a rank; ``by_height`` holds each.

  * **CUDA**: one NCCL process a card, N = the visible cards; the baseline
    is one process on one card. With fewer than two cards the result is
    ``{"skipped": ...}``, never a number: two ranks sharing one card would
    measure the host, not the work.
  * **CPU** (``--smoke``, or ``scaling("cpu")``): N gloo processes on a
    tiny CT and detector; each rank, and the one-rank baseline, gets
    ``torch.set_num_threads(T // N)``, T being this process's thread count
    (by default one a core; fewer under ``OMP_NUM_THREADS``), so the
    baseline has one rank's share of the cores (the JAX tool pins its
    processes with ``taskset`` for the same reason). A CPU number, labelled
    so.

    python -m diffdrr_tpu_torch.bench_scaling            # the cards
    python -m diffdrr_tpu_torch.bench_scaling --smoke    # 2 ranks on the CPU

Prints one JSON line. Each rank times ``reps`` runs of ``iters`` renders on
fresh poses, after one warm-up render, and keeps its best run; a step's
time is the slowest rank's.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["scaling", "record", "main", "HEIGHTS", "VOLUME"]

ROOT = Path(__file__).resolve().parents[1]
# The bench harness's CT and detectors (bench.FULL), 400 mm across.
VOLUME = (512, 512, 133)
HEIGHTS = (200, 1000)
SMOKE = dict(heights=(64,), volume=(32, 32, 8), iters=2, reps=1)


def _rank(args) -> None:
    """One rank: join the group, render at each detector, print this rank's
    best seconds a render by detector."""
    from . import DRR, load_example_ct
    from .parallel import initialize_distributed, make_mesh, make_sharded_render

    if args.threads:
        torch.set_num_threads(args.threads)
    if args.world > 1:
        initialize_distributed(args.init, args.world, args.rank, device=args.device)
    elif args.device == "cuda":
        torch.cuda.set_device(0)
    subject = load_example_ct(shape=tuple(args.volume), device=args.device)
    mesh = make_mesh(devices=args.device)
    times = {}
    for h in args.heights:
        drr = DRR(subject, sdd=1020.0, height=h, delx=400.0 / h, renderer="joseph",
                  device=args.device)
        dev = drr.device
        rot = torch.tensor([[0.01, 3.141592653589793 / 2 + 0.02, -0.01]], device=dev)
        trans = torch.tensor([[0.0, 850.0, 0.0]], device=dev)
        rot, trans = rot.repeat(args.batch, 1), trans.repeat(args.batch, 1)
        render = make_sharded_render(drr, mesh, "euler_angles", "ZXY", axis=2)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        with torch.no_grad():
            render(rot, trans)
            sync()
            best = float("inf")
            for r in range(args.reps):
                t0 = time.perf_counter()
                for i in range(args.iters):
                    out = render(rot + 1e-5 * (r * args.iters + i + 1), trans)
                sync()
                best = min(best, (time.perf_counter() - t0) / args.iters)
        if tuple(out.shape) != (args.batch, 1, h, h) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"rank {args.rank}: bad render {tuple(out.shape)} at {h}^2")
        times[h] = best
    print(json.dumps({"rank": args.rank, "t_s": times}), flush=True)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _world(n: int, device: str, threads: int, passthrough: list, timeout: float) -> dict:
    """Start ``n`` rank processes; the slowest rank's best seconds a render,
    by detector height."""
    with tempfile.TemporaryDirectory() as tmp:
        init = (f"tcp://localhost:{_free_port()}" if device == "cuda"
                else f"file://{Path(tmp) / 'rendezvous'}")
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "diffdrr_tpu_torch.bench_scaling", "--role", "rank",
             "--rank", str(r), "--world", str(n), "--init", init, "--device", device,
             "--threads", str(threads), *passthrough],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        try:
            times = []
            deadline = time.monotonic() + timeout
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} of {n} exited {p.returncode}: "
                                       f"{err.strip()[-400:]}")
                times.append(json.loads(out.strip().splitlines()[-1])["t_s"])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return {int(h): max(t[h] for t in times) for h in times[0]}


def record(t_single: dict, t_sharded: dict, n: int, batch: int) -> dict:
    """Each detector's times, speedup, efficiency (raw: above 1 is reported
    as it came) and all-gather bytes; ``scaling_efficiency`` is the largest
    detector's."""
    by_height = {}
    for h in sorted(t_single):
        t1, tn = t_single[h], t_sharded[h]
        by_height[str(h)] = {"t_single_ms": t1 * 1e3, "t_sharded_ms": tn * 1e3,
                             "speedup": t1 / tn, "scaling_efficiency": t1 / (n * tn),
                             "allgather_bytes_per_step": int(batch * h * h * 4 * (n - 1) / n)}
    return {"scaling_efficiency": by_height[str(max(t_single))]["scaling_efficiency"],
            "by_height": by_height}


def scaling(device: str = "cuda", n: int = None, heights=HEIGHTS, volume=VOLUME,
            batch: int = 1, iters: int = 20, reps: int = 5, timeout: float = 560.0) -> dict:
    """The scaling record (see the module docstring) of ``n`` ranks on
    ``device``: by default every visible card, or 2 CPU ranks."""
    if device == "cuda":
        n = torch.cuda.device_count() if n is None else n
        if n < 2:
            return {"skipped": f"{n} CUDA device; scaling needs 2 or more"}
        threads, backend = 0, "nccl"
    elif device == "cpu":
        n = 2 if n is None else n
        threads, backend = max(1, torch.get_num_threads() // n), "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    passthrough = ["--heights", *map(str, heights), "--volume", *map(str, volume),
                   "--batch", str(batch), "--iters", str(iters), "--reps", str(reps)]
    t1 = _world(1, device, threads, passthrough, timeout)
    tn = _world(n, device, threads, passthrough, timeout)
    methodology = (f"ray-axis sharding via parallel.make_sharded_render on {n} {backend} "
                   f"ranks, one process a rank; efficiency = t_single / (n * t_sharded), "
                   f"unclamped; Joseph renderer on the kernels, example CT "
                   f"{'x'.join(map(str, volume))}, batch {batch}, best of {reps} runs of "
                   f"{iters} renders")
    if device == "cpu":
        methodology += (f"; a CPU number: each rank and the one-rank baseline on "
                        f"{threads} threads")
    return {"n_devices": n, "backend": backend, "device": device,
            "volume": list(volume), **record(t1, tn, n, batch), "methodology": methodology}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Ray-sharded render scaling of the port.")
    ap.add_argument("--smoke", action="store_true",
                    help="2 gloo ranks on the CPU at a tiny size (a CPU number)")
    ap.add_argument("--heights", type=int, nargs="+", default=list(HEIGHTS))
    ap.add_argument("--volume", type=int, nargs=3, default=list(VOLUME))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--role", choices=["main", "rank"], default="main", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.role == "rank":
        _rank(args)
        return 0
    if args.smoke:
        res = scaling("cpu", batch=args.batch, **SMOKE)
    else:
        res = scaling("cuda", heights=args.heights, volume=args.volume, batch=args.batch,
                      iters=args.iters, reps=args.reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
