"""Carry a renderer's state across from the JAX package, as NumPy arrays.

``export_state`` reads a ``diffdrr_tpu`` ``DRR`` (or any object with the same
attributes) into a dict of NumPy arrays and plain numbers; ``drr_from_state``
builds this package's ``Subject`` and ``DRR`` from such a dict on a device.
Both packages can then render the same density through the same detector,
which is how the tests hold the port against the JAX package. Nothing here
imports JAX: the exporter only calls ``np.asarray`` on the arrays it reads.

State keys: ``density`` (X, Y, Z) float32, ``affine`` (4, 4) float64 (the
volume affine after centring), ``reorient`` (4, 4) float32, ``mask``
(optional labelmap), ``orientation``, and the detector config ``sdd``,
``height``, ``width``, ``delx``, ``dely``, ``x0``, ``y0``,
``reverse_x_axis``, plus ``voxel_shift``.

``pose_regressor_state_from_flax`` turns the variables of the JAX
package's flax ``PoseRegressor`` (NumPy arrays in flax's nested dicts) into
the ``state_dict`` of this package's ``PoseRegressor``: flax's HWIO
convolution kernels to OIHW, its (in, out) dense kernels to (out, in), its
group norm scales to weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._device import DeviceLike
from .data import Image, Subject
from .drr import DRR

__all__ = ["export_state", "subject_from_state", "drr_from_state",
           "pose_regressor_state_from_flax"]


def export_state(drr: Any) -> Dict[str, Any]:
    """NumPy state of a JAX-package ``DRR``: its subject and detector config."""
    subject, det = drr.subject, drr.detector
    mask = getattr(subject, "mask", None)
    return {
        "density": np.asarray(subject.density.data, np.float32),
        "affine": np.asarray(subject.volume.affine, np.float64),
        "reorient": np.asarray(subject.reorient, np.float32),
        "mask": None if mask is None else np.asarray(mask.data),
        "orientation": subject.orientation,
        "sdd": float(det.sdd),
        "height": int(det.height),
        "width": int(det.width),
        "delx": float(det.delx),
        "dely": float(det.dely),
        # The raw calibration entries (the public x0/y0 are negated).
        "x0": float(det._x0),
        "y0": float(det._y0),
        "reverse_x_axis": bool(det.reverse_x_axis),
        "voxel_shift": float(drr.voxel_shift),
    }


def subject_from_state(state: Dict[str, Any], device: DeviceLike = None) -> Subject:
    """This package's ``Subject`` from exported state, moved to ``device``."""
    affine = np.asarray(state["affine"], np.float64)
    density = np.asarray(state["density"], np.float32)
    mask = state.get("mask")
    subject = Subject(
        volume=Image(density, affine),
        density=Image(density, affine),
        mask=None if mask is None else Image(np.asarray(mask), affine),
        orientation=state.get("orientation", "AP"),
        reorient=np.asarray(state["reorient"], np.float32),
    )
    return subject.to(device)


def drr_from_state(state: Dict[str, Any], device: DeviceLike = None, **kwargs) -> DRR:
    """This package's ``DRR`` over exported state, on ``device``."""
    subject = subject_from_state(state, device)
    return DRR(subject, sdd=state["sdd"], height=state["height"], delx=state["delx"],
               width=state["width"], dely=state["dely"], x0=state["x0"], y0=state["y0"],
               reverse_x_axis=state["reverse_x_axis"], voxel_shift=state["voxel_shift"],
               device=subject.device, **kwargs)


def pose_regressor_state_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of ``registration.PoseRegressor`` from flax variables.

    ``params`` is ``{"params": {"_ConvBackbone_0": {"Conv_j": ...,
    "GroupNorm_j": ...}, "Dense_0": ..., "Dense_1": ...}}`` (or its inner
    dict), as ``PoseRegressor.init`` makes it, leaves as NumPy arrays; the
    same mapping carries a gradient tree of that shape.
    """
    params = params.get("params", params)
    state = {}
    for name, layer in params["_ConvBackbone_0"].items():
        kind, j = name.split("_")
        if kind == "Conv":
            state[f"backbone.convs.{j}.weight"] = np.asarray(layer["kernel"]).transpose(3, 2, 0, 1)
        else:
            state[f"backbone.norms.{j}.weight"] = np.asarray(layer["scale"])
        state[f"backbone.{'convs' if kind == 'Conv' else 'norms'}.{j}.bias"] = np.asarray(
            layer["bias"])
    for name, head in (("Dense_0", "rotation_head"), ("Dense_1", "translation_head")):
        state[f"{head}.weight"] = np.asarray(params[name]["kernel"]).T
        state[f"{head}.bias"] = np.asarray(params[name]["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v, dtype=np.float32)) for k, v in state.items()}
