"""What the kernel wrappers share: argument checks, the device rule, the call.

A wrapper runs its plain PyTorch version on a CPU tensor and launches its
CUDA kernel on a CUDA tensor; any other device raises, and so does a build
or launch failure. There is no fallback from a kernel to a plain version.
"""

from __future__ import annotations

import torch

from .prep import NROWS, march_perm

__all__ = ["check_rows", "check", "check_cotangent", "runs_plain", "ptr", "call",
           "strides_extents"]


def check_rows(family: str, rows: torch.Tensor, axis: int) -> None:
    if rows.dtype != torch.float32:
        raise TypeError(f"{family} kernels take float32 rows, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[0] != NROWS:
        raise ValueError(f"rows must be ({NROWS}, R), got {tuple(rows.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, not {axis}")


def check(family: str, rows: torch.Tensor, density: torch.Tensor, axis: int) -> None:
    check_rows(family, rows, axis)
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
