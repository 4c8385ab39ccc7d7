"""Host C++ components (meshers, QEM decimation, HU transfer, gunzip),
built from this package's own sources with g++ and loaded with ctypes."""

from .build import (build_all, call_counts, load_library, native_available, require,
                    reset_call_counts)

__all__ = ["load_library", "native_available", "require", "build_all", "call_counts",
           "reset_call_counts"]
