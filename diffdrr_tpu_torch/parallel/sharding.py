"""Several devices: ray- and data-sharded renders, slab-sharded volumes,
and the reconstruction step.

Counterpart of ``diffdrr_tpu/parallel/sharding.py``. The JAX package has one
controller drive a ``Mesh`` of devices under ``jit``; here each device is
one process (a rank) of ``torch.distributed``, and the layout is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes, by default
``("data", "rays")``. Every function takes the mesh and runs the same
program on every rank; each rank computes its share and the collectives of
``collectives.py`` (with JAX's transpose rules) assemble the result:

  * **Ray sharding** (:func:`shard_drr`): each rank renders a contiguous
    share of the detector's rays, on the kernels, with every choice the
    render makes from its rays (the march axis, Siddon's slab guard, the
    oracles' axis and sampling interval) taken from the whole frame, so
    each ray is the unsharded render's ray bit for bit; an all-gather
    assembles the image;
  * **Data parallelism** (:func:`make_sharded_render`): the pose batch
    splits over ``data``, the rays of each pose over ``rays``; every rank
    computes the whole batch's rays (a few elementwise kernels) and cuts
    its block from them, so a pose's rays do not depend on how the batch
    is split (a batch of another size rounds the rays' transforms
    differently in the last bit on the card) and the image is again the
    unsharded one bit for bit;
  * **Volume slabs** (:func:`slab_sharded_raycast`, :func:`slab_sharded_joseph`,
    :func:`slab_sharded_siddon`): each rank renders its slab of the volume,
    the rays shifted into slab-local coordinates, with no halo, and one
    all-reduce sums the integrals;
  * **Reconstruction** (:func:`make_reconstruction_step`): views over
    ``data``, rays over ``rays``, the density replicated; autograd
    all-reduces its gradient (XLA's automatic ``psum``; DDP's all-reduce).

A mesh axis whose extent does not divide the work (rays, poses) is
replicated instead, as the JAX package replicates an indivisible target.
A gradient summed over ranks adds the same terms in another order than one
device does, so it equals the unsharded one to float32 rounding.

A plain process with no process group still runs every function:
:func:`make_mesh` makes a world of one, whose collectives are no-ops.
"""

from __future__ import annotations

from math import prod
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..drr import DRR
from ..ops._raygeom import alpha_minmax, reduce_img
from ..ops.kernels._launch import check_precision, check_storage
from ..pose import convert
from ..profiling import annotate
from .collectives import copy_to_mesh, gather_from_mesh, group_size, reduce_from_mesh
from .multihost import _backend_for

__all__ = [
    "make_mesh",
    "shard_drr",
    "make_sharded_render",
    "slab_sharded_raycast",
    "slab_sharded_joseph",
    "slab_sharded_siddon",
    "make_reconstruction_step",
]


def make_mesh(
    axis_shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data", "rays"),
    devices: DeviceLike = None,
):
    """A ``DeviceMesh`` of every rank, ``axis_shape`` over ``axis_names``.

    The shape defaults to ``(1, ..., world size)``. ``devices`` is the
    device the ranks' tensors live on (default: the card, as every entry
    point; ``"cpu"`` for gloo on the CPU): with one process per device, the
    JAX package's device list has no counterpart, each rank holding its
    own. Without a process group, a world of one is made here (an in-memory
    store; NCCL on the card, gloo on the CPU), so a single-device caller
    never wires ``torch.distributed``. A shape that asks for more ranks than
    the world has raises: launch them with ``torchrun`` or
    ``initialize_distributed`` first.
    """
    device = resolve_device(devices)
    if not dist.is_initialized():
        dist.init_process_group(_backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if axis_shape is None:
        axis_shape = (1,) * (len(axis_names) - 1) + (n,)
    axis_shape = tuple(int(a) for a in axis_shape)
    if len(axis_shape) != len(axis_names):
        raise ValueError(f"axis_shape {axis_shape} and axis_names {axis_names} differ in length")
    if prod(axis_shape) > n:
        raise ValueError(
            f"a mesh of shape {axis_shape} needs {prod(axis_shape)} ranks and the world has "
            f"{n}: launch them with torchrun --nproc-per-node, or join them with "
            f"initialize_distributed, before make_mesh")
    if prod(axis_shape) < n:
        raise ValueError(f"a mesh of shape {axis_shape} leaves ranks of the world of {n} out: "
                         f"the mesh must hold every rank")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(n).reshape(axis_shape)
    return DeviceMesh(device.type, ranks, mesh_dim_names=tuple(axis_names))


def _axis(mesh, name: str):
    """(process group, extent) of the mesh axis ``name``."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"the mesh has no axis {name!r} (its axes: {names})")
    return mesh.get_group(name), mesh.size(names.index(name))


def _share(group, n: int) -> Optional[Tuple[int, int]]:
    """This rank's contiguous ``(lo, hi)`` of ``n`` items split over
    ``group``, or None when they are not split (one rank, or ``n`` does not
    divide: replicated)."""
    ranks = group_size(group)
    if ranks == 1 or n % ranks:
        return None
    size = n // ranks
    lo = dist.get_rank(group) * size
    return lo, lo + size


def _joint(mesh, groups: List) -> Optional[dist.ProcessGroup]:
    """One group over the named axes' ranks: None for none, the axis's own
    for one, the world's for every axis of the mesh (it holds every rank)."""
    groups = [g for g in groups if group_size(g) > 1]
    if not groups:
        return None
    if len(groups) == 1:
        return groups[0]
    if len(groups) == sum(1 for s in mesh.shape if s > 1):
        return dist.group.WORLD
    raise NotImplementedError("a collective over some but not all axes of a mesh of more "
                              "than two split axes")


# -----------------------------------------------------------------------------
# Ray and data sharding
# -----------------------------------------------------------------------------


class _ShardedDRR(DRR):
    """A ``DRR`` whose renders split the poses and the rays over mesh axes."""

    _mesh = _data_group = _ray_group = None

    def _render(self, density, source, target, mask_to_channels, sample, kwargs, share=None):
        if share is None:
            B, N = target.shape[0], target.shape[1] if sample is None else len(sample)
            views, rays = _share(self._data_group, B), _share(self._ray_group, N)
            if views is not None or rays is not None:
                group = _joint(self._mesh, [self._data_group if views else None,
                                            self._ray_group if rays else None])
                source, target, density = copy_to_mesh(source, target, density, group=group)
                img = super()._render(density, source, target, mask_to_channels, sample, kwargs,
                                      (views or (0, B), rays or (0, N)))
                if rays is not None:
                    img = gather_from_mesh(img, self._ray_group, dim=-1)
                if views is not None:
                    img = gather_from_mesh(img, self._data_group, dim=0)
                return img
        # Nothing to split (one rank, or indivisible work): every rank renders all.
        return super()._render(density, source, target, mask_to_channels, sample, kwargs, share)


def _sharded(drr: DRR, mesh, data_axis: Optional[str], ray_axis: Optional[str]) -> DRR:
    """A shallow copy of ``drr`` splitting its renders over the named axes."""
    sharded = _ShardedDRR.__new__(_ShardedDRR)
    sharded.__dict__.update(drr.__dict__)
    sharded._mesh = mesh
    if data_axis is not None:
        sharded._data_group = _axis(mesh, data_axis)[0]
    if ray_axis is not None:
        sharded._ray_group = _axis(mesh, ray_axis)[0]
    return sharded


def shard_drr(drr: DRR, mesh, ray_axis: str = "rays") -> DRR:
    """A ``DRR`` whose ``render`` and ``__call__`` split the rays over ``ray_axis``.

    Each rank renders a contiguous share of the detector's ``H * W`` rays
    (of the sampled ones under ``p_subsample``), cut from the whole frame's
    rays after their transforms (``DRR._render``'s ``share``): on the
    kernels, with the march axis and Siddon's slab guard judged from the
    whole frame's corner rays, so each ray is the unsharded render's ray bit
    for bit. The oracles take their choices from the whole ray set too (the
    Joseph oracle's axis, the trilinear oracle's sampling interval).
    ``gather_from_mesh`` assembles the image on every rank and cuts its
    cotangent back to the rank's share; the rays and the density enter
    through ``copy_to_mesh``, so their gradients (and the pose's) sum every
    rank's share. When the rays do not divide by the axis's extent, every
    rank renders all of them (replicated), as in JAX. The result shares the
    DRR's density and detector (a shallow copy).
    """
    return _sharded(drr, mesh, None, ray_axis)


def make_sharded_render(
    drr: DRR,
    mesh,
    parameterization: str,
    convention: Optional[str] = None,
    data_axis: str = "data",
    ray_axis: str = "rays",
    **render_kwargs,
) -> Callable:
    """``render(rotation, translation) -> (B, C, H, W)`` with the pose batch
    split over ``data_axis`` and each pose's rays over ``ray_axis``.

    Every rank computes the rays of the whole batch (cheap, and the same
    bits as the unsharded render's), renders its block of poses and rays,
    and returns the whole image batch (all-gathers over both axes); the
    pose gradient is the unsharded one. A batch made by
    ``local_batch_to_global`` (a ``DTensor``) is rendered share by share and
    returned as a ``DTensor`` sharded the same way. Work that does not
    divide by an axis's extent is replicated over it.
    """
    sharded = _sharded(drr, mesh, data_axis, ray_axis)
    rays_only = shard_drr(drr, mesh, ray_axis)
    kw = dict(parameterization=parameterization, convention=convention, **render_kwargs)

    def render(rotation, translation):
        from torch.distributed.tensor import DTensor, Shard

        if isinstance(rotation, DTensor):
            # Each rank holds its own poses: split only the rays, and those
            # only where the batch is not split over the ray axis too.
            ray_dim = mesh.mesh_dim_names.index(ray_axis)
            mine = drr if isinstance(rotation.placements[ray_dim], Shard) else rays_only
            img = mine(rotation.to_local(), translation.to_local(), **kw)
            return DTensor.from_local(img, mesh, rotation.placements, run_check=False)
        return sharded(rotation, translation, **kw)

    return render


# -----------------------------------------------------------------------------
# Volume slab sharding (zero halo, one all-reduce)
# -----------------------------------------------------------------------------


def _slab(volume: torch.Tensor, mesh, axis: str, dim: int, what: str):
    """(group, slab index, slab size, this rank's slab view) of ``volume``
    cut along ``dim`` over the mesh axis ``axis``."""
    group, n_dev = _axis(mesh, axis)
    X = volume.shape[dim]
    if X % n_dev != 0:
        raise ValueError(f"{what} {X} not divisible by mesh axis {n_dev}")
    S = X // n_dev
    idx = dist.get_rank(group)
    return group, idx, S, volume.narrow(dim, idx * S, S)


def _replicated(volume, source, target, weights, group):
    """The replicated inputs through ``copy_to_mesh``; ``weights`` default to ones."""
    if weights is None:
        B, N, _ = target.shape
        weights = torch.ones((B, 1, N), dtype=volume.dtype, device=volume.device)
    return copy_to_mesh(source, target, weights, group=group)


def _shifted(source, target, dim: int, offset: int):
    """The rays in slab-local coordinates: ``offset`` planes off along ``dim``."""
    shift = torch.zeros(3, dtype=source.dtype, device=source.device)
    shift[dim] = offset
    return source - shift, target - shift


def _no_tile_plan(image_shape, pallas_kwargs, target):
    """The kernels' ``storage`` from ``pallas_kwargs``, whose ``storage`` and
    ``precision`` the kernels take as ``DRR`` does (``"f32"`` or
    ``"highest"``, one function here). The TPU's tile plan has no
    counterpart: ``image_shape`` is checked against the rays, and any other
    ``pallas_kwargs`` key raises."""
    kw = dict(pallas_kwargs or {})
    storage, precision = kw.pop("storage", None), kw.pop("precision", "f32")
    if kw:
        raise TypeError(f"pallas_kwargs {sorted(kw)} plan the TPU's tiles, which the "
                        f"CUDA kernels do not have")
    check_precision(precision)
    check_storage(storage)
    if image_shape is not None and prod(image_shape) != target.shape[1]:
        raise ValueError(f"image_shape {tuple(image_shape)} does not hold the "
                         f"{target.shape[1]} rays")
    return storage


def slab_sharded_raycast(
    volume: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor],
    mesh,
    axis: str = "rays",
    *,
    n_points: int = 500,
    voxel_shift: float = 0.5,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Trilinear raycast ``(B, 1, N)`` with the volume cut in slabs along its x-axis.

    Rank ``i`` takes slab ``[i*S, (i+1)*S)`` of ``volume`` and evaluates only
    the x-corner row terms its slab owns: trilinear interpolation splits
    exactly into two row terms, each local to the slab that owns its row, so
    no halo is exchanged; one all-reduce assembles the integrals. The
    samples are the trilinear oracle's (``n_points`` over the global
    interval of all rays). Plain PyTorch: no TPU kernel computes this.
    """
    group, idx, S, slab = _slab(volume, mesh, axis, 0, "volume x-dim")
    source, target, weights = _replicated(volume, source, target, weights, group)
    amin, amax = alpha_minmax(source, target, tuple(volume.shape), voxel_shift, eps)
    alphamin, alphamax = torch.amin(amin), torch.amax(amax)
    step = (alphamax - alphamin) / max(n_points - 1, 1)  # the oracle's
    alphas = (torch.linspace(0.0, 1.0, n_points, dtype=volume.dtype, device=volume.device)
              [None, None] * (alphamax - alphamin) + alphamin)
    pts = source[..., None, :] + alphas[..., None] * (target - source + eps)[..., None, :]
    g = pts + (voxel_shift - 0.5)  # grid_sample's align_corners=False offset
    x0, y0, z0 = torch.floor(g).unbind(-1)
    fx, fy, fz = (g - torch.floor(g)).unbind(-1)
    y0i, z0i = y0.to(torch.int64), z0.to(torch.int64)
    d1, d2 = slab.shape[1], slab.shape[2]

    def bilinear_at_row(row, weight_x):
        """The (y, z)-bilinear sample of global x-row ``row``, zero off the slab."""
        local = row.to(torch.int64) - idx * S
        in_slab = (local >= 0) & (local < S)
        r = torch.clamp(local, 0, S - 1)

        def corner(yi, zi, wy, wz):
            valid = in_slab & (yi >= 0) & (yi < d1) & (zi >= 0) & (zi < d2)
            flat = (r * d1 + torch.clamp(yi, 0, d1 - 1)) * d2 + torch.clamp(zi, 0, d2 - 1)
            return torch.where(valid, torch.take(slab, flat) * wy * wz, 0.0)

        return weight_x * (corner(y0i, z0i, 1 - fy, 1 - fz) + corner(y0i + 1, z0i, fy, 1 - fz)
                           + corner(y0i, z0i + 1, 1 - fy, fz) + corner(y0i + 1, z0i + 1, fy, fz))

    vals = bilinear_at_row(x0, 1.0 - fx) + bilinear_at_row(x0 + 1.0, fx)
    img = vals * weights.transpose(-1, -2) * step
    return reduce_from_mesh(reduce_img(img, "sum")[:, None, :], group)


def slab_sharded_joseph(
    volume: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor],
    mesh,
    axis: str = "rays",
    *,
    march_axis: int = 0,
    step: int = 1,
    voxel_shift: float = 0.5,
    eps: float = 1e-8,
    use_pallas: bool = False,
    image_shape: Optional[Tuple[int, int]] = None,
    pallas_kwargs: Optional[dict] = None,
) -> torch.Tensor:
    """Joseph plane-march render ``(B, 1, N)`` with the volume cut in march-axis slabs.

    Rank ``i`` takes planes ``[i*S, (i+1)*S)`` of the march axis. Joseph's
    samples lie inside single planes, so the slabs partition them exactly
    with no halo: each rank marches its planes (the rays shifted so local
    plane ``j`` is global plane ``i*S + j``) and one all-reduce assembles
    the integrals. ``use_pallas=True`` (the JAX package's name for its
    kernel path) renders each slab on the Joseph kernels
    (``joseph_march_raycast``: ``joseph_fwd``, ``joseph_fwdgrad`` and
    ``joseph_bwd_vol`` on the card, their plain versions on the CPU); the
    default renders on the oracle (``ops/joseph.py``). ``image_shape`` and
    ``pallas_kwargs`` carried the TPU's tile plan, which has no counterpart
    here: ``image_shape`` must hold the rays, and a ``pallas_kwargs`` key
    other than ``storage`` and ``precision`` raises. ``storage="bf16"``
    gives each slab a bf16 bricked copy on the kernels (the oracle reads
    the float32 density, as in ``DRR``).
    """
    group, idx, S, slab = _slab(volume, mesh, axis, march_axis, "march axis")
    if S % step != 0:
        raise ValueError(f"slab size {S} must be a multiple of step {step}")
    storage = _no_tile_plan(image_shape, pallas_kwargs, target)
    source, target, weights = _replicated(volume, source, target, weights, group)
    src_l, tgt_l = _shifted(source, target, march_axis, idx * S)
    if use_pallas:
        from ..ops.kernels.joseph import joseph_march_raycast

        img = joseph_march_raycast(slab, src_l, tgt_l, weights, axis=march_axis, step=step,
                                   voxel_shift=voxel_shift, eps=eps, storage=storage)
    else:
        from ..ops.joseph import joseph_raycast

        img = joseph_raycast(slab, src_l, tgt_l, weights, axis=march_axis, step=step,
                             voxel_shift=voxel_shift, eps=eps)
    return reduce_from_mesh(img, group)


def slab_sharded_siddon(
    volume: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor],
    mesh,
    axis: str = "rays",
    *,
    slab_axis: int = 0,
    voxel_shift: float = 0.5,
    eps: float = 1e-8,
    use_pallas: bool = False,
    image_shape: Optional[Tuple[int, int]] = None,
    pallas_kwargs: Optional[dict] = None,
) -> torch.Tensor:
    """Exact Siddon render ``(B, 1, N)`` with the volume cut in slabs along one axis.

    Siddon's segments end at grid planes and every slab boundary is one, so
    no segment straddles two slabs: each rank renders its slab with the
    rays shifted into slab-local coordinates (zero outside its box), and
    one all-reduce assembles the exact integral, with no halo.
    ``use_pallas=True`` renders each slab on the Siddon kernels
    (``siddon_slab_raycast`` marching ``slab_axis``: ``siddon_fwd``,
    ``siddon_fwdgrad`` and ``siddon_bwd_vol`` on the card, their plain
    versions on the CPU); that march is exact only when ``slab_axis`` is
    the rays' major axis, which the caller picks. The default renders on the
    sort-based oracle (``ops/siddon.py``). ``image_shape`` and
    ``pallas_kwargs`` (its ``storage`` too): as :func:`slab_sharded_joseph`.
    """
    group, idx, S, slab = _slab(volume, mesh, axis, slab_axis, "slab axis")
    storage = _no_tile_plan(image_shape, pallas_kwargs, target)
    source, target, weights = _replicated(volume, source, target, weights, group)
    src_l, tgt_l = _shifted(source, target, slab_axis, idx * S)
    if use_pallas:
        from ..ops.kernels.siddon import siddon_slab_raycast

        img = siddon_slab_raycast(slab, src_l, tgt_l, weights, axis=slab_axis,
                                  voxel_shift=voxel_shift, eps=eps, storage=storage)
    else:
        from ..ops.siddon import siddon_raycast

        img = siddon_raycast(slab, src_l, tgt_l, weights, voxel_shift=voxel_shift, eps=eps)
    return reduce_from_mesh(img, group)


# -----------------------------------------------------------------------------
# Reconstruction
# -----------------------------------------------------------------------------


def make_reconstruction_step(
    drr: DRR,
    mesh=None,
    parameterization: str = "euler_angles",
    convention: Optional[str] = "ZXY",
    lr: float = 1e-2,
    data_axis: str = "data",
    ray_axis: str = "rays",
    **render_kwargs,
):
    """Build ``(init_fn, step_fn)`` for density reconstruction on ``drr.device``.

    ``init_fn(density0) -> (density, opt)`` makes a fresh leaf and its Adam;
    ``step_fn(density, opt, rotation, translation, measured) -> (density,
    opt, loss)`` renders the views at the poses from the density, scores
    them against ``measured (B, C, H, W)`` by the mean squared error, and
    takes one Adam step in place; ``loss`` is the loss before the step, a
    0-d tensor. The render is the value-only forward of the DRR's renderer
    and the backward its density-gradient kernel (``fused_pose_bwd``
    defaults to False: only the density needs a gradient). ``torch.optim.Adam(lr)``
    applies ``optax.adam(lr)``'s update.

    With a ``mesh`` the views split over ``data_axis`` and each view's rays
    over ``ray_axis`` (an axis that does not divide them is replicated; so
    are the rays of a ``p_subsample`` detector). The density enters the
    render through ``copy_to_mesh``, so autograd all-reduces its gradient;
    each rank sums its share's squared errors and ``reduce_from_mesh``
    makes the global mean. Every rank takes the same Adam step from the
    same all-reduced gradient, so the density stays bitwise replicated. A
    mesh of one rank runs the single-device step.
    """
    render_kwargs.setdefault("fused_pose_bwd", False)
    device = drr.device
    det = drr.detector
    if mesh is not None:
        data_group, ray_group = _axis(mesh, data_axis)[0], _axis(mesh, ray_axis)[0]

    def init_fn(density0):
        density = (torch.as_tensor(density0, dtype=torch.float32, device=device)
                   .detach().clone().requires_grad_(True))
        return density, torch.optim.Adam([density], lr=lr)

    def loss_of(density, rotation, translation, measured):
        rotation, translation, measured = (torch.as_tensor(x, dtype=torch.float32, device=device)
                                           for x in (rotation, translation, measured))
        with annotate("drr.pose"):
            pose = convert(rotation, translation, parameterization=parameterization,
                           convention=convention)
            source, target = det(pose)
        B, N = target.shape[:2]
        views = rays = group = None
        if mesh is not None:
            views = _share(data_group, B)
            if det.n_subsample is None:  # a sampled detector's rays stay whole
                rays = _share(ray_group, N)
            group = _joint(mesh, [data_group if views else None, ray_group if rays else None])
        if group is None:  # nothing split: the one-device step
            img = drr.reshape_transform(drr.render(density, source, target, **render_kwargs),
                                        batch_size=B)
            return torch.mean((img - measured) ** 2)
        (density,) = copy_to_mesh(density, group=group)
        (b0, b1), (lo, hi) = views or (0, B), rays or (0, N)
        img = drr._render(density, source, target, False, None, render_kwargs,
                          ((b0, b1), (lo, hi)))
        mine = measured[b0:b1]
        if rays is None:
            img = drr.reshape_transform(img, batch_size=b1 - b0)
        else:
            mine = mine.reshape(b1 - b0, -1, N)[..., lo:hi]
        return reduce_from_mesh(torch.sum((img - mine) ** 2), group) / measured.numel()

    def step_fn(density, opt, rotation, translation, measured):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(density, rotation, translation, measured)
        loss.backward()
        opt.step()
        return density, opt, loss.detach()

    return init_fn, step_fn
