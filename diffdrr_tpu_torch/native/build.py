"""Build the port's host C++ components from its own sources and load them.

Counterpart of the JAX package's ``native/build.py``. Each ``native/<name>.cpp``
of this package is compiled with ``g++ -O3 -shared -fPIC -std=c++17``
(``nifti_loader`` also ``-pthread -lz``) into
``diffdrr_tpu_torch/_build/native/<name>-<hash>.so``, where the hash covers
the source and the flags, and loaded with ``ctypes``. Nothing is built at
import: the first use builds, and :func:`build_all` builds every library at
once, one ``g++`` process per source started together.

A failed build is not silent. :func:`load_library` returns None, so a
caller may take its NumPy route, but ``build_errors`` keeps g++'s message
and :func:`require` raises with it. Each native entry point's wrapper adds
one to its count in ``calls`` where it calls the library, and nowhere
else, so a run can show that the native route ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["load_library", "native_available", "require", "build_all", "call_counts",
           "reset_call_counts", "count", "SOURCES", "SRC", "BUILD_ROOT", "CXX_FLAGS"]

SRC = Path(__file__).resolve().parent
BUILD_ROOT = SRC.parent / "_build" / "native"
SOURCES = ("surface_nets", "marching_cubes", "decimate", "nifti_loader")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_EXTRA_FLAGS = {"nifti_loader": ("-pthread", "-lz")}

_VOID = ctypes.c_void_p
_I64 = ctypes.c_int64
_PF = ctypes.POINTER(ctypes.c_float)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PPF = ctypes.POINTER(_PF)
_PPI64 = ctypes.POINTER(_PI64)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
# (restype, argtypes) of each library's C entry points.
_SIGNATURES = {
    "surface_nets": {
        "surface_nets": (_I64, [_PF, _I64, _I64, _I64, ctypes.c_float, _PPF, _PI64, _PPI64,
                                _PI64]),
        "taubin_smooth": (None, [_PF, _I64, _PI64, _I64, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float]),
        "sn_free": (None, [_VOID]),
    },
    "marching_cubes": {
        "marching_cubes": (_I64, [_PF, _I64, _I64, _I64, ctypes.c_float,
                                  ctypes.POINTER(ctypes.c_int8), _I64, _PPF, _PI64, _PPI64,
                                  _PI64]),
        "mc_free": (None, [_VOID]),
    },
    "decimate": {
        "qem_decimate": (ctypes.c_int, [_PF, _I64, _PI64, _I64, _I64, _PPF, _PI64, _PPI64,
                                        _PI64]),
        "qem_free": (None, [_VOID]),
    },
    "nifti_loader": {
        "hu_to_density": (ctypes.c_int, [_VOID, _I64, ctypes.c_int, ctypes.c_float, _PF]),
        "gunzip": (_I64, [_PU8, _I64, ctypes.POINTER(_PU8)]),
        "nl_free": (None, [_VOID]),
    },
}
# The entry points the wrappers count (the frees are not counted).
ENTRY_POINTS = ("surface_nets", "taubin_smooth", "marching_cubes", "qem_decimate",
                "hu_to_density", "gunzip")

_lock = threading.Lock()
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
build_errors: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}
calls: Dict[str, int] = dict.fromkeys(ENTRY_POINTS, 0)


def count(entry: str) -> None:
    """Add one to ``entry``'s count: a wrapper calls this where it calls the library."""
    calls[entry] += 1


def call_counts() -> Dict[str, int]:
    return dict(calls)


def reset_call_counts() -> None:
    for k in calls:
        calls[k] = 0


def lib_path(name: str) -> Path:
    """The library's path: its name and a hash of its flags and source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + _EXTRA_FLAGS.get(name, ())).encode())
    h.update((SRC / f"{name}.cpp").read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}.so"


def command(name: str, out: Path) -> list:
    """The g++ command that builds ``name`` into ``out`` (the libraries it
    links after the source)."""
    return ["g++", *CXX_FLAGS, str(SRC / f"{name}.cpp"), "-o", str(out),
            *_EXTRA_FLAGS.get(name, ())]


def _start(name: str):
    """Start g++ for one source: (process or None, temp path, final path)."""
    out = lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = command(name, tmp)
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:  # no compiler
        build_errors[name] = f"{' '.join(cmd)}: {e}"
        return None, tmp, out
    return proc, tmp, out


def _finish(name: str, started, t0: float) -> None:
    proc, tmp, out = started
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        build_errors[name] = f"{' '.join(proc.args)} exited {proc.returncode}:\n{log}"
        tmp.unlink(missing_ok=True)
        return
    os.replace(tmp, out)  # atomic: another process never loads half a library
    build_seconds[name] = time.perf_counter() - t0


def _bind(name: str, path: Path) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        build_errors[name] = f"loading {path}: {e}"
        return None
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Optional[ctypes.CDLL]]:
    """Build (if needed) and load the named libraries, compiling in parallel.

    A library that fails to build or load maps to None, with the reason in
    ``build_errors``.
    """
    names = list(names)
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names if n not in _loaded and not lib_path(n).exists()}
        for n, st in started.items():
            _finish(n, st, t0)
        for n in names:
            if n not in _loaded:
                _loaded[n] = None if n in build_errors else _bind(n, lib_path(n))
        return {n: _loaded[n] for n in names}


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """The loaded ``<name>`` library, built on first use; None if it cannot
    be built or loaded (``build_errors[name]`` says why)."""
    if name in _loaded:
        return _loaded[name]
    return build_all([name])[name]


def native_available(name: str) -> bool:
    return load_library(name) is not None


def require(name: str) -> ctypes.CDLL:
    """The loaded ``<name>`` library; raises with g++'s message if there is none."""
    lib = load_library(name)
    if lib is None:
        raise RuntimeError(f"native {name} unavailable: {build_errors.get(name, 'unknown')}")
    return lib
