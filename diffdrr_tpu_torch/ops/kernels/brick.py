"""The bricked copy of the density that the gathers read, and its cache.

``siddon_fwd`` and ``joseph_fwd`` launch one thread per ray, and a warp's 32
rays are neighbouring detector pixels (the fused pose kernels
``siddon_fwdgrad`` and ``joseph_fwdgrad`` read the same copy, a few lanes
a ray). In the density's own layout the rays of a warp read 32 different
columns at each slab whenever the march axis is the unit-stride one, so
one warp load touches ~32 cache lines. The
bricked copy cuts the density into bricks of ``BRICK`` voxels (a shape
fixed when the kernels are compiled), each brick contiguous (64 floats,
two 128-byte lines) and the bricks in row-major order, so the voxels those
rays read at one slab fall in a few lines (``csrc/brick.cuh`` has the
addressing).

The copy keeps the density's own (X, Y, Z) index order, whatever the march
axis, so one copy serves all three axes; each extent is padded with zeros
to whole bricks (the kernels still read 0 outside the density's extents by
their bounds test). It is layout glue, not a port of a TPU kernel: one
read and one write of the volume, by ``brick_copy`` (``csrc/brick.cu``) on a
CUDA tensor and by a pad, a reshape and a permute
(``brick_density_plain``) on the CPU. ``brick_density.launches`` counts
the kernel's launches.

:func:`bricked` keeps the copy of an unchanged density: registration and
plain renders of one CT make it once, a reconstruction step (whose density
Adam updates in place) once per step. An entry is keyed on the density's
data pointer, version counter, shape and strides, and holds only a weak
reference to the density, so it never keeps a density alive and goes when
the density does. A write that bypasses the version counter (through
``tensor.data``) is not seen; the port makes none.
"""

from __future__ import annotations

import weakref
from typing import List, NamedTuple, Tuple

import torch

from ._launch import call, runs_plain
from .prep import march_perm

__all__ = ["BRICK", "BrickedDensity", "brick_density", "brick_density_plain", "bricked",
           "clear_cache"]

# Voxels of a brick along the density's axes 0, 1, 2: two 128-byte lines
# (fwd_timing.py's probes chose it over 4x4x2, 2x2x8, 2x4x4, 1x4x8, 8x4x1).
# A compile-time constant of the kernels: csrc/brick.cuh's BRICK_L0..L2
# are the log2 of these lengths.
BRICK = (4, 4, 4)
# Copies kept at once (each as large as its density).
_MAX_ENTRIES = 4


class BrickedDensity(NamedTuple):
    """``data``: the copy, ``(n0, n1, n2, b0, b1, b2)`` contiguous float32
    (brick indices, then the voxel's place in its brick); ``shape``: the
    density's extents."""

    data: torch.Tensor
    shape: Tuple[int, int, int]

    def args(self, axis: int) -> list:
        """The C entry points' volume arguments: the march axis, then each
        march-permuted axis's brick stride, then its extent."""
        perm = march_perm(axis)
        return [axis] + [self.data.stride(p) for p in perm] + [self.shape[p] for p in perm]


def _check(density: torch.Tensor) -> None:
    if density.dtype != torch.float32 or density.dim() != 3:
        raise ValueError(f"the density must be float32 (X, Y, Z), got {density.dtype} "
                         f"{tuple(density.shape)}")


@torch.no_grad()
def brick_density_plain(density: torch.Tensor) -> BrickedDensity:
    """Plain version of :func:`brick_density`: the density zero-padded to
    whole bricks, split into them by a reshape and a permute, and made
    contiguous."""
    _check(density)
    ext = tuple(density.shape)
    pad = [-e % b for e, b in zip(ext, BRICK)]
    padded = torch.nn.functional.pad(density.detach(), (0, pad[2], 0, pad[1], 0, pad[0]))
    split = [m for e, p, b in zip(ext, pad, BRICK) for m in ((e + p) // b, b)]
    data = padded.reshape(split).permute(0, 2, 4, 1, 3, 5).contiguous()
    return BrickedDensity(data, ext)


def brick_density(density: torch.Tensor) -> BrickedDensity:
    """The bricked copy of a float32 ``(X, Y, Z)`` density of any strides:
    the kernel ``brick_copy`` on a CUDA tensor, the plain version on the
    CPU."""
    if runs_plain("brick_copy", density):
        return brick_density_plain(density)
    _check(density)
    ext = tuple(density.shape)
    data = torch.empty((*(-(-e // b) for e, b in zip(ext, BRICK)), *BRICK),
                       dtype=torch.float32, device=density.device)
    if data.stride(0) >= 2 ** 31:  # the kernels' brick strides are 32-bit
        raise ValueError(f"a density of {ext} has too large a brick row for the bricked copy")
    call("brick", "brick_copy", density.device, density.data_ptr(), *density.stride(), *ext,
         data.data_ptr())
    brick_density.launches += 1
    return BrickedDensity(data, ext)


brick_density.launches = 0


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


def bricked(density: torch.Tensor) -> BrickedDensity:
    """The bricked copy of ``density``, made anew only when the density is
    another tensor or was written since (see the module's docstring)."""
    key = _key(density)
    if key is None:
        return brick_density(density)
    for i, e in enumerate(_entries):
        if e.key == key and e.ref() is not None:
            _entries.append(_entries.pop(i))  # most recently used last
            return e.value
    value = brick_density(density)
    # A copy of the same memory at another version is stale: replace it.
    _entries[:] = [e for e in _entries if e.key[0] != key[0] and e.ref() is not None]
    _entries.append(_Entry(weakref.ref(density, _drop), key, value))
    del _entries[:-_MAX_ENTRIES]
    return value


def clear_cache() -> None:
    """Forget every copy (the next forward of each density bricks it anew)."""
    _entries.clear()
