"""Build the CUDA kernels from the package's sources and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library lands
in ``diffdrr_tpu_torch/_build/<hash>/``, where the hash covers the sources,
the headers and the compiler flags, so an edit rebuilds and an unchanged
tree reuses the library. Nothing is built at import: the first launch
builds, and :func:`build_all` builds every library at once, one ``nvcc``
process per source started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["load", "build_all", "SOURCES", "CSRC", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("siddon", "joseph", "brick")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_VOID = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
# rows, n_rays, volume, its strides and extents, in march order
_VOL = [_VOID, _I64, _VOID, _I64, _I64, _I64, _INT, _INT, _INT]
# rows, n_rays, the bricked copy, the march axis, then the march-ordered
# axes' brick strides and extents (brick.BrickedDensity.args)
_BVOL = [_VOID, _I64, _VOID] + [_INT] * 7
# rows, n_rays, g, arg, the gradient volume, its strides and extents
_GRAD = [_VOID, _I64, _VOID, _VOID, _VOID, _I64, _I64, _I64, _INT, _INT, _INT]
# the Joseph march: h (the float32 rounding of the stride), n_steps, blend
_MARCH = [_F32, _INT, _INT]
# the labelmap and its strides (its extents are the volume's)
_LAB = [_VOID, _I64, _I64, _I64]
# C signatures of each library's entry points (argtypes, the stream last;
# all return int). Each entry point that reads the bricked copy has a twin
# *_bf16 on a bf16 copy, with the same arguments (_BF16 below).
_SIGNATURES = {
    "siddon": {
        "siddon_fwd": _BVOL + [_VOID] * 2,
        "siddon_fwdgrad": _BVOL + [_VOID] * 2,
        "siddon_fwd_max": _BVOL + [_VOID] * 3,
        "siddon_bwd_rays": _BVOL + [_VOID] * 3,
        "siddon_bwd_rays_mip": _VOL + [_VOID] * 4,
        "siddon_bwd_vol": _GRAD + [_VOID],
    },
    "joseph": {
        "joseph_fwd": _BVOL + _MARCH + [_VOID] * 2,
        "joseph_fwd_max": _BVOL + _MARCH + [_VOID] * 3,
        "joseph_fwdgrad": _BVOL + _MARCH + [_VOID] * 3,
        "joseph_bwd_rays": _BVOL + _MARCH + [_VOID] * 3,
        "joseph_bwd_rays_mip": _VOL + _MARCH + [_VOID] * 4,
        "joseph_bwd_vol": _GRAD + _MARCH + [_VOID],
        # channel mode: the march, then n_channels
        # the bricked density and labelmap share the brick strides and extents
        "joseph_fwd_ch": _BVOL[:3] + [_VOID] + _BVOL[3:] + _MARCH + [_INT] + [_VOID] * 2,
        "joseph_bwd_rays_ch": _BVOL[:3] + [_VOID] + _BVOL[3:] + _MARCH + [_INT] + [_VOID] * 3,
        "joseph_bwd_vol_ch": [_VOID, _I64, _VOID] + _LAB + [_VOID, _I64, _I64, _I64, _INT, _INT,
                                                             _INT] + _MARCH + [_INT, _VOID],
    },
    "brick": {
        # the density, its strides and extents, the copy
        "brick_copy": [_VOID, _I64, _I64, _I64] + [_INT] * 3 + [_VOID] * 2,
        # brick_copy's path for the density, its strides and X2 (no launch, no stream)
        "brick_copy_packed_path": [_VOID, _I64, _I64, _I64, _INT],
    },
}
# The bf16 instantiations: every entry point that reads the bricked copy,
# and the copy itself. The MIP pose backwards read the bf16 bricked copy (the
# sum mode's arguments, then g, arg and out), where their float32 versions
# read the strided density.
_BF16 = {
    "siddon": ("siddon_fwd", "siddon_fwdgrad", "siddon_fwd_max", "siddon_bwd_rays"),
    "joseph": ("joseph_fwd", "joseph_fwd_max", "joseph_fwdgrad", "joseph_bwd_rays",
               "joseph_fwd_ch", "joseph_bwd_rays_ch"),
    "brick": ("brick_copy",),
}
for _lib, _names in _BF16.items():
    _SIGNATURES[_lib].update({f"{n}_bf16": _SIGNATURES[_lib][n] for n in _names})
_SIGNATURES["siddon"]["siddon_bwd_rays_mip_bf16"] = _BVOL + [_VOID] * 4
_SIGNATURES["joseph"]["joseph_bwd_rays_mip_bf16"] = _BVOL + _MARCH + [_VOID] * 4

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_ROOT / _digest(name) / f"lib{name}.so"


def _start(name: str, out: Path):
    """Start nvcc for one source; returns (process, temp path, final path)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started, t0: float) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(proc.args)}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    build_seconds[name] = time.perf_counter() - t0


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load the named libraries, compiling in parallel."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n, _lib_path(n)) for n in names
                   if n not in _loaded and not _lib_path(n).exists()}
        for n, st in started.items():
            _finish(n, st, t0)
        for n in names:
            if n not in _loaded:
                _loaded[n] = _bind(n, _lib_path(n))
        return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib
