"""Rendering ops: the plain-PyTorch oracles and the CUDA march kernels."""

from ._raygeom import scatter_channels
from .joseph import choose_march_axis, joseph_raycast
from .sampling import sample_volume
from .siddon import siddon_raycast
from .trilinear import trilinear_raycast

__all__ = ["siddon_raycast", "joseph_raycast", "trilinear_raycast", "choose_march_axis",
           "sample_volume", "scatter_channels"]
