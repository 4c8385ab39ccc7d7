"""What the kernel wrappers share: argument checks, the device rule, the call.

A wrapper runs its plain PyTorch version on a CPU tensor and launches its
CUDA kernel on a CUDA tensor; any other device raises, and so does a build
or launch failure. There is no fallback from a kernel to a plain version.

``storage`` (``None``, float32, or ``"bf16"``) is the element type of the
density copy a kernel reads: under ``"bf16"`` the wrapper launches the
kernel's bf16 instantiation (its C entry point ``<name>_bf16``, counted in
``launches_bf16``) on a bf16 bricked copy, and the plain version reads the
density rounded to bf16 (:func:`stored`). Both compute the float32 function
of the rounded density, bit for bit.
"""

from __future__ import annotations

import torch

from .prep import NROWS, march_perm

__all__ = ["check_rows", "check", "check_cotangent", "runs_plain", "ptr", "call",
           "strides_extents", "STORAGES", "check_storage", "check_precision", "stored",
           "count_launch"]

STORAGES = (None, "bf16")


def check_rows(family: str, rows: torch.Tensor, axis: int) -> None:
    if rows.dtype != torch.float32:
        raise TypeError(f"{family} kernels take float32 rows, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[0] != NROWS:
        raise ValueError(f"rows must be ({NROWS}, R), got {tuple(rows.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, not {axis}")


def check(family: str, rows: torch.Tensor, density: torch.Tensor, axis: int,
          storage=None) -> None:
    check_rows(family, rows, axis)
    check_storage(storage)
    if density.dtype != torch.float32:
        raise TypeError(f"{family} kernels take a float32 density, got {density.dtype}")
    if density.dim() != 3:
        raise ValueError(f"density must be (X, Y, Z), got {tuple(density.shape)}")
    if rows.device != density.device:
        raise ValueError(f"rows on {rows.device}, density on {density.device}")


def check_cotangent(rows: torch.Tensor, g: torch.Tensor, arg) -> torch.Tensor:
    """``g`` as a contiguous (R,) float32 tensor; checks the MIP argmax."""
    R = rows.shape[1]
    if g.dtype != torch.float32 or g.shape != (R,) or g.device != rows.device:
        raise ValueError(f"g must be float32 ({R},) on {rows.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if arg is not None and (arg.dtype != torch.int32 or arg.shape != (R,)
                            or arg.device != rows.device or not arg.is_contiguous()):
        raise ValueError(f"arg must be contiguous int32 ({R},) on {rows.device}")
    return g.contiguous()


def runs_plain(name: str, t: torch.Tensor) -> bool:
    """True on the CPU (the plain version), False on CUDA (the kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, not {t.device}")
    return False


def ptr(t):
    return None if t is None else t.data_ptr()


def call(lib: str, fn_name: str, device: torch.device, *args) -> None:
    """Call ``lib``'s C entry point ``fn_name(*args, stream)``; raise on a CUDA error."""
    from .build import load

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(load(lib), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")


def strides_extents(t: torch.Tensor, axis: int) -> list:
    """Element strides, then extents, of ``t``'s march-permuted (s, y, z) axes."""
    perm = march_perm(axis)
    return [t.stride(p) for p in perm] + [t.shape[p] for p in perm]


def check_storage(storage) -> None:
    if storage not in STORAGES:
        raise ValueError(f"storage must be None (float32) or 'bf16', not {storage!r}")


def check_precision(precision) -> None:
    """The JAX package's ``precision``: ``"f32"`` or ``"highest"``, one
    function for these scalar float32 kernels. Its ``"bf16"`` rounds the TPU
    matrix unit's inputs, which has no counterpart here."""
    if precision not in ("f32", "highest"):
        hint = "; for a bf16 copy of the density pass storage='bf16'" if precision == "bf16" else ""
        raise ValueError(f"precision must be 'f32' or 'highest', not {precision!r}{hint}")


def stored(density: torch.Tensor, storage) -> torch.Tensor:
    """The density as a kernel of ``storage`` reads it: each voxel rounded
    to the nearest bf16 (ties to even) and widened back to float32 exactly
    under ``"bf16"``, the density itself otherwise."""
    return density if storage is None else density.to(torch.bfloat16).to(torch.float32)


def count_launch(fn, storage) -> None:
    """One launch of ``fn``'s kernel in the instantiation of ``storage``."""
    if storage is None:
        fn.launches += 1
    else:
        fn.launches_bf16 += 1
