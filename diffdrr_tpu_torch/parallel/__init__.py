"""Reconstruction, and later multi-device rendering.

Counterpart of ``diffdrr_tpu/parallel``. Only the single-device
reconstruction step is ported so far (see ``sharding.py``).
"""

from .sharding import make_reconstruction_step

__all__ = ["make_reconstruction_step"]
