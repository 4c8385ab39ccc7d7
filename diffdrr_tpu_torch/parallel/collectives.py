"""The three collectives of the sharded renders, with JAX's transpose rules.

JAX differentiates a sharded program as one function: a replicated input
that feeds per-device work is implicitly broadcast (``pbroadcast``), and the
transpose of that broadcast sums the devices' cotangents; ``psum`` with a
replicated output transposes to the identity. With one process per device,
PyTorch's autograd sees only the process's own share, so each collective
carries its transpose explicitly, as Megatron-LM's pairs do:

  * ``copy_to_mesh``: forward the identity, backward an all-reduce (sum) of
    the cotangents. Every replicated input that feeds sharded work enters
    through it (the pose, the rays, the density), so its gradient is the sum
    of every rank's share;
  * ``reduce_from_mesh``: forward an all-reduce (sum), backward the
    identity (``psum`` with a replicated output);
  * ``gather_from_mesh``: forward an all-gather of equal shares along one
    dimension, backward the rank's own slice of the replicated cotangent.

An all-reduce in a backward where the forward was already summed (what
``torch.distributed.nn.functional.all_reduce`` does) makes a replicated
loss's gradients world-size times too large; these rules do not.

A group of one rank needs no communication: each function then returns its
input, as ``psum`` over an axis of size one does. Every rank of a group must
make the same calls in the same order, with tensors of the same shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["copy_to_mesh", "reduce_from_mesh", "gather_from_mesh", "group_size"]


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    """Ranks in ``group``; 1 for ``None`` (no group: nothing is sharded)."""
    return 1 if group is None else dist.get_world_size(group)


class _CopyToMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.shapes = [t.shape for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        # One all-reduce for all the cotangents (autograd passes zeros for
        # an unused output, so every rank sends a buffer of the same size).
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        return (None, *(t.reshape(s) for t, s in
                        zip(flat.split([s.numel() for s in ctx.shapes]), ctx.shapes)))


def copy_to_mesh(*tensors: torch.Tensor, group: Optional[dist.ProcessGroup]) -> Tuple:
    """The tensors as they are; their cotangents summed over ``group``.

    Returns a tuple, one entry per tensor. A tensor that requires no
    gradient is returned itself (so a cache keyed on the tensor, such as
    the bricked copy's, still finds it), and so is every tensor with one
    rank."""
    grads = [i for i, t in enumerate(tensors) if t.requires_grad]
    if group_size(group) == 1 or not grads:
        return tensors
    out = list(tensors)
    for i, t in zip(grads, _CopyToMesh.apply(group, *(tensors[i] for i in grads))):
        out[i] = t
    return tuple(out)


class _ReduceFromMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


def reduce_from_mesh(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of ``x`` over ``group``, on every rank; its cotangent passes
    through unchanged."""
    if group_size(group) == 1:
        return x
    return _ReduceFromMesh.apply(group, x)


class _GatherFromMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(group=ctx.group)
        return None, None, g.narrow(ctx.dim, rank * ctx.n, ctx.n)


def gather_from_mesh(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                     dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    cotangent of the whole is cut back to this rank's slice."""
    if group_size(group) == 1:
        return x
    return _GatherFromMesh.apply(group, dim % x.dim(), x)
