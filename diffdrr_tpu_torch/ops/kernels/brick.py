"""The bricked copy of the density that the gathers read, and its cache.

The forwards ``siddon_fwd`` and ``joseph_fwd`` launch one thread per ray,
and a warp's 32 rays are neighbouring detector pixels (the MIP forwards
``siddon_fwd_max`` and ``joseph_fwd_max``, the channel forward
``joseph_fwd_ch``, the fused pose kernels ``siddon_fwdgrad`` and
``joseph_fwdgrad`` and the pose backwards ``siddon_bwd_rays`` and
``joseph_bwd_rays_ch`` read the same copy, most a few lanes a ray). In the
density's own layout the rays of a warp read 32 different columns at each
slab whenever the march axis is the unit-stride one, so one warp load
touches ~32 cache lines. The bricked
copy cuts the density into bricks of ``BRICK`` voxels (a shape fixed when
the kernels are compiled), each brick contiguous (64 floats, two 128-byte
lines) and the bricks in row-major order, so the voxels those rays read at
one slab fall in a few lines (``csrc/brick.cuh`` has the addressing).

The copy keeps the density's own (X, Y, Z) index order, whatever the march
axis, so one copy serves all three axes; each extent is padded with zeros
to whole bricks (the kernels still read 0 outside the density's extents by
their bounds test). It is layout glue, not a port of a TPU kernel: one
read and one write of the volume, by ``brick_copy`` (``csrc/brick.cu``) on a
CUDA tensor and by a pad, a reshape and a permute
(``brick_density_plain``) on the CPU. ``brick_density.launches`` counts
the kernel's launches: one a copy, on either of its two paths. The packed
path takes a density whose rows are packed (the DRR's contiguous density,
a slab of it) and reads each plane's rows of a column of bricks as one
span; the general path any other strides (:func:`packed_path` says which).

:func:`bricked` keeps the copy of an unchanged density: registration and
plain renders of one CT make it once, a render and its two-pass pose
backward once, a reconstruction step (whose density Adam updates in place)
once per step. An entry is keyed on the density's
data pointer, version counter, shape and strides, and holds only a weak
reference to the density, so it never keeps a density alive and goes when
the density does. A write that bypasses the version counter (through
``tensor.data``) is not seen; the port makes none. ``forget`` drops one density's copy (a
``DRR`` with ``cache_volume=False`` does so before each render).

An int32 labelmap is copied the same way, as the bits of its labels (a
float32 view), which ``joseph_fwd_ch`` and ``joseph_bwd_rays_ch`` read back
as int32: the copy keeps every label exactly and shares the density copy's
brick strides. A channel render and its pose backward make each copy once.

``storage="bf16"`` (the JAX package's bf16 density storage) makes the copy
in bf16, each voxel rounded to the nearest bf16, ties to even: by
``brick_copy_bf16`` on a CUDA tensor (``brick_density.launches_bf16``
counts it), by ``.to(torch.bfloat16)`` before the pad, reshape and permute
on the CPU. It halves the copy's bytes and every gather's; the kernels'
bf16 instantiations read it. The storage is part of the cache's key, so a
bf16 copy and a float32 copy of one density never stand in for each
other, and each is kept; a DRR holds the copy of its own storage only.
A labelmap's copy is float32 (its int32 bits) whatever the storage.
"""

from __future__ import annotations

import weakref
from functools import partial
from typing import List, NamedTuple, Tuple

import torch

from ._launch import call, check_storage, count_launch, runs_plain
from .prep import march_perm

__all__ = ["BRICK", "BrickedDensity", "brick_density", "brick_density_plain", "bricked",
           "forget", "clear_cache", "packed_path"]

# Voxels of a brick along the density's axes 0, 1, 2: two 128-byte lines
# (fwd_timing.py's probes chose it over 4x4x2, 2x2x8, 2x4x4, 1x4x8, 8x4x1).
# A compile-time constant of the kernels: csrc/brick.cuh's BRICK_L0..L2
# are the log2 of these lengths.
BRICK = (4, 4, 4)
# Copies kept at once (each as large as its density).
_MAX_ENTRIES = 4


class BrickedDensity(NamedTuple):
    """``data``: the copy, ``(n0, n1, n2, b0, b1, b2)`` contiguous float32,
    or bfloat16 under bf16 storage (brick indices, then the voxel's place in
    its brick); ``shape``: the density's extents."""

    data: torch.Tensor
    shape: Tuple[int, int, int]

    @property
    def storage(self):
        """The copy's element type: None (float32) or ``"bf16"``."""
        return "bf16" if self.data.dtype == torch.bfloat16 else None

    def entry(self, name: str) -> str:
        """The C entry point of kernel ``name`` that reads this copy: its
        bf16 instantiation ``<name>_bf16`` for a bf16 copy."""
        return name if self.storage is None else f"{name}_bf16"

    def args(self, axis: int) -> list:
        """The C entry points' volume arguments: the march axis, then each
        march-permuted axis's brick stride, then its extent (the same for
        either element type: the strides count elements)."""
        perm = march_perm(axis)
        return [axis] + [self.data.stride(p) for p in perm] + [self.shape[p] for p in perm]


def _as_float(density: torch.Tensor, storage=None) -> torch.Tensor:
    """The float32 ``(X, Y, Z)`` volume to copy: a labelmap's int32 bits
    seen as float32 (float32 storage only)."""
    check_storage(storage)
    if density.dtype == torch.int32 and storage is None:
        density = density.view(torch.float32)
    if density.dtype != torch.float32 or density.dim() != 3:
        raise ValueError(f"the density must be float32 (or, in float32 storage, an int32 "
                         f"labelmap) (X, Y, Z), got {density.dtype} {tuple(density.shape)}")
    return density


@torch.no_grad()
def brick_density_plain(density: torch.Tensor, storage=None) -> BrickedDensity:
    """Plain version of :func:`brick_density`: the density (rounded to bf16
    under bf16 storage) zero-padded to whole bricks, split into them by a
    reshape and a permute, and made contiguous."""
    density = _as_float(density, storage).detach()
    if storage == "bf16":
        density = density.to(torch.bfloat16)
    ext = tuple(density.shape)
    pad = [-e % b for e, b in zip(ext, BRICK)]
    padded = torch.nn.functional.pad(density, (0, pad[2], 0, pad[1], 0, pad[0]))
    split = [m for e, p, b in zip(ext, pad, BRICK) for m in ((e + p) // b, b)]
    data = padded.reshape(split).permute(0, 2, 4, 1, 3, 5).contiguous()
    return BrickedDensity(data, ext)


def brick_density(density: torch.Tensor, storage=None) -> BrickedDensity:
    """The bricked copy of a float32 ``(X, Y, Z)`` density (or an int32
    labelmap) of any strides, in float32 or (``storage="bf16"``) bf16: the
    kernel ``brick_copy`` (``brick_copy_bf16``) on a CUDA tensor, the plain
    version on the CPU."""
    density = _as_float(density, storage)
    if runs_plain("brick_copy", density):
        return brick_density_plain(density, storage)
    ext = tuple(density.shape)
    data = torch.empty((*(-(-e // b) for e, b in zip(ext, BRICK)), *BRICK),
                       dtype=torch.float32 if storage is None else torch.bfloat16,
                       device=density.device)
    if data.stride(0) >= 2 ** 31:  # the kernels' brick strides are 32-bit
        raise ValueError(f"a density of {ext} has too large a brick row for the bricked copy")
    copy = BrickedDensity(data, ext)
    call("brick", copy.entry("brick_copy"), density.device, density.data_ptr(),
         *density.stride(), *ext, data.data_ptr())
    count_launch(brick_density, storage)
    return copy


brick_density.launches = brick_density.launches_bf16 = 0


def packed_path(density: torch.Tensor) -> bool:
    """Whether ``brick_copy`` copies this CUDA density (or labelmap) on its
    packed path: rows packed (unit stride along axis 2, axis 1's stride the
    extent of axis 2), the data pointer and axis 0's stride 16-byte aligned,
    axis 2 at most 1024 long (``csrc/brick.cuh``'s ``copy_packed``, asked
    through the built library: no launch)."""
    from .build import load

    density = _as_float(density)
    if density.device.type != "cuda":
        raise ValueError(f"brick_copy's paths are the CUDA kernel's, not {density.device}'s")
    return bool(load("brick").brick_copy_packed_path(density.data_ptr(), *density.stride(),
                                                     density.shape[2]))


class _Entry(NamedTuple):
    ref: weakref.ref
    key: tuple
    value: BrickedDensity


_entries: List[_Entry] = []


def _key(density: torch.Tensor):
    """What must not change for a copy to stay valid, or None when the
    density keeps no version counter (an inference tensor)."""
    try:
        version = density._version
    except RuntimeError:
        return None
    return (density.data_ptr(), version, tuple(density.shape), density.stride(),
            density.dtype, density.device)


def _drop(ref) -> None:
    _entries[:] = [e for e in _entries if e.ref is not ref]


def bricked(density: torch.Tensor, storage=None) -> BrickedDensity:
    """The bricked copy of ``density`` in ``storage``, made anew only when
    the density is another tensor or was written since, or no copy of that
    storage is kept (see the module's docstring)."""
    # A float32 copy keeps brick_density's one-argument call.
    make = brick_density if storage is None else partial(brick_density, storage=storage)
    key = _key(density)
    if key is None:
        return make(density)
    for i, e in enumerate(_entries):
        if e.key == key and e.value.storage == storage and e.ref() is not None:
            _entries.append(_entries.pop(i))  # most recently used last
            return e.value
    value = make(density)
    # A copy of the same memory at another version (or shape, or strides) is
    # stale, and one of the same storage is replaced: drop them.
    _entries[:] = [e for e in _entries if e.ref() is not None
                   and (e.key[0] != key[0] or (e.key == key and e.value.storage != storage))]
    _entries.append(_Entry(weakref.ref(density, _drop), key, value))
    del _entries[:-_MAX_ENTRIES]
    return value


def forget(density: torch.Tensor) -> None:
    """Drop the copy of ``density``'s memory, if one is kept (its next
    forward bricks it anew)."""
    ptr = density.data_ptr()
    _entries[:] = [e for e in _entries if e.key[0] != ptr]


def clear_cache() -> None:
    """Forget every copy (the next forward of each density bricks it anew)."""
    _entries.clear()
