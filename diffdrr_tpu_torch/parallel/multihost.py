"""Several processes, on one host or many: the process group and global batches.

Counterpart of ``diffdrr_tpu/parallel/multihost.py``. The JAX package runs
one controller per host driving all of the host's devices; PyTorch's idiom
is one process per device (a rank), launched by ``torchrun`` and joined by
``torch.distributed``: NCCL between cards, gloo on the CPU.

  * every process calls :func:`initialize_distributed` first; under
    ``torchrun`` it reads the launcher's environment (``env://``);
  * :func:`global_mesh` lays the ranks out as a ``DeviceMesh``: by default
    the hosts on the ``data`` axis and a host's devices on ``rays``;
  * :func:`process_local_slice` is a process's share of a global batch, and
    :func:`local_batch_to_global` makes those shares one sharded ``DTensor``
    without any process holding the whole batch.

A plain single process needs none of it: :func:`initialize_distributed` then
does nothing and ``make_mesh`` makes a world of one itself.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device

__all__ = [
    "initialize_distributed",
    "global_mesh",
    "local_batch_to_global",
    "process_local_slice",
]


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> None:
    """Join this process to the process group (call once, before any mesh).

    ``coordinator_address`` is a ``tcp://host:port`` or ``file://path``
    rendezvous (a bare ``host:port``, as JAX takes it, means ``tcp://``),
    with ``num_processes`` and this process's ``process_id``. Without one,
    ``torchrun``'s environment (``WORLD_SIZE`` above 1) is read through
    ``env://``; with neither, or with one process, nothing is done. Nothing
    is done either when the group already exists.

    The backend is NCCL when the process's device (``device``, by default
    the card, as every entry point) is CUDA, and gloo when the caller names
    ``device="cpu"`` or ``backend="gloo"``. On CUDA the process's card is
    ``LOCAL_RANK`` (or ``process_id``) modulo the visible cards.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError("num_processes > 1 needs a coordinator_address")
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return  # a single process: nothing to wire
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dev = resolve_device(device)
    if backend is None:
        backend = _backend_for(dev)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = {} if init_method == "env://" else dict(world_size=num_processes,
                                                     rank=process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def _world() -> Tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(
    axis_shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data", "rays"),
    devices: DeviceLike = None,
):
    """A mesh over every rank of every host (``make_mesh`` with a default shape).

    With two axis names and no shape, the layout is ``(hosts, ranks a
    host)``: the batch axis crosses hosts and the ray axis stays inside one.
    The ranks a host are ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it), else
    the visible CUDA cards (one when there are none). ``devices`` is the
    ranks' device type, as ``make_mesh`` takes it.
    """
    from .sharding import make_mesh

    _, n = _world()
    if axis_shape is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or max(1, torch.cuda.device_count())
        per_host = min(per_host, n)
        if len(axis_names) == 2 and n % per_host == 0:
            axis_shape = (n // per_host, per_host)
        else:
            axis_shape = (1,) * (len(axis_names) - 1) + (n,)
    return make_mesh(axis_shape, axis_names, devices=devices)


def process_local_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this process's contiguous share of a global batch."""
    index, n_proc = _world()
    if global_batch % n_proc != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n_proc} processes")
    size = global_batch // n_proc
    return index * size, size


def _placements(mesh, spec: Sequence[Union[str, Sequence[str], None]]):
    """DTensor placements of a ``PartitionSpec``-like ``spec``: entry ``i``
    names the mesh axis (or axes, major first) that tensor dim ``i`` is
    split over, ``None`` for none."""
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(spec, str):
        spec = (spec,)
    placements = [Replicate()] * mesh.ndim
    for dim, names in enumerate(spec):
        if names is None:
            continue
        for name in ((names,) if isinstance(names, str) else names):
            if name not in mesh.mesh_dim_names:
                raise ValueError(f"mesh has no axis {name!r} (axes {mesh.mesh_dim_names})")
            placements[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return placements


def local_batch_to_global(mesh, spec, local_data):
    """This process's share of a batch as one global tensor sharded by ``spec``.

    ``spec`` plays ``PartitionSpec``'s part: ``("data",)`` splits the batch
    (dim 0) over the mesh's ``data`` axis and replicates it over the others,
    so the ranks that share a ``data`` coordinate pass the same share;
    ``(("data", "rays"),)`` splits it over both, one share a rank. The
    result is ``DTensor.from_local`` of ``local_data`` on the mesh's device:
    no process holds the global batch.
    """
    from torch.distributed.tensor import DTensor

    if not isinstance(local_data, torch.Tensor):
        local_data = torch.as_tensor(np.asarray(local_data))
    local = local_data.to(mesh.device_type)
    return DTensor.from_local(local, mesh, _placements(mesh, spec), run_check=False)
