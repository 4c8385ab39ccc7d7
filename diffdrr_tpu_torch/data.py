"""CT volume ingest and preprocessing.

Counterpart of ``diffdrr_tpu/data.py``. Host-side work (NIfTI I/O, HU ->
density, reorientation, isocentre centring, label masking, resampling, the
procedural example phantom) stays on the host with the same float32
arithmetic as the JAX package, so the density arrays agree byte for byte:
HU -> density tries the fused C++ transfer first (``native/nifti_loader.cpp``,
the JAX package's source in this package's own copy), as the JAX package
does, and keeps the NumPy route beside it.
:meth:`Subject.to` then moves the density (and mask) to a device as
tensors. Files are read by the port's own ``nifti.py``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import nifti
from ._device import DeviceLike, resolve_device

__all__ = ["Image", "Subject", "read", "transform_hu_to_density", "canonicalize",
           "resample_subject", "synthesize_ct_from_labelmap", "load_example_ct"]


class Image:
    """A 3D image (NumPy array or tensor) + a float64 affine."""

    def __init__(self, data, affine: np.ndarray):
        if isinstance(data, np.ndarray):
            if data.ndim == 4 and data.shape[0] == 1:  # torchio's (1, X, Y, Z)
                data = data[0]
        self.data = data
        self.affine = np.asarray(affine, np.float64)

    @classmethod
    def load(cls, path: Union[str, Path]) -> "Image":
        """A NIfTI-1 file (``.nii`` or ``.nii.gz``) on the host."""
        return cls(*nifti.load(path))

    def save(self, path: Union[str, Path]) -> None:
        data = self.data
        nifti.save(path, data.cpu().numpy() if torch.is_tensor(data) else data, self.affine)

    @property
    def spatial_shape(self):
        return tuple(self.data.shape)

    @property
    def spacing(self) -> np.ndarray:
        return np.sqrt((self.affine[:3, :3] ** 2).sum(axis=0))

    @property
    def orientation(self) -> tuple:
        """Axis direction codes, e.g. ``('R', 'A', 'S')``."""
        return nifti.aff2axcodes(self.affine)

    def get_center(self) -> np.ndarray:
        """World coordinates of the volume centre (torchio semantics)."""
        idx = (np.asarray(self.spatial_shape, np.float64) - 1.0) / 2.0
        return self.affine[:3, :3] @ idx + self.affine[:3, 3]

    def get_bounds(self) -> tuple:
        """``((xmin, xmax), (ymin, ymax), (zmin, zmax))`` in world space, from
        the voxel-edge corners at index -0.5 and shape - 0.5 (torchio's)."""
        first = self.affine[:3, :3] @ np.full(3, -0.5) + self.affine[:3, 3]
        last = (self.affine[:3, :3] @ (np.asarray(self.spatial_shape) - 0.5)
                + self.affine[:3, 3])
        pts = np.stack([first, last])
        return tuple((pts[:, i].min(), pts[:, i].max()) for i in range(3))


@dataclasses.dataclass
class Subject:
    """A CT volume + derived density (+ optional labelmap) and orientation."""

    volume: Image
    density: Image
    mask: Optional[Image] = None
    orientation: Optional[str] = "AP"
    reorient: Optional[np.ndarray] = None
    fiducials: Optional[np.ndarray] = None
    structures: Optional[Any] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: Optional[torch.device] = None

    def get_images(self, intensity_only: bool = False) -> List[Image]:
        imgs = [self.volume, self.density]
        if self.mask is not None and not intensity_only:
            imgs.append(self.mask)
        return imgs

    def to(self, device: DeviceLike = None) -> "Subject":
        """Move density (float32) and mask to ``device`` as tensors, in place."""
        device = resolve_device(device)
        self.density.data = torch.as_tensor(
            self.density.data, dtype=torch.float32, device=device)
        if self.mask is not None:
            self.mask.data = torch.as_tensor(self.mask.data, device=device)
        self.device = device
        return self


_NATIVE_HU_DTYPES = {
    np.dtype(np.float32): 0,
    np.dtype(np.int16): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.float64): 3,
    np.dtype(np.uint8): 4,
}


def _hu_to_density_native(volume, bone_attenuation_multiplier):
    """Fused multithreaded C++ transfer (native/nifti_loader.cpp), or None
    when the library does not build."""
    import ctypes

    from .native import build

    arr = np.asarray(volume)
    code = _NATIVE_HU_DTYPES.get(
        arr.dtype if arr.dtype.byteorder in ("=", "|", "<") else None)
    if code is None or not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr, np.float32)
        code = 0
    lib = build.load_library("nifti_loader")
    if lib is None:
        return None
    build.count("hu_to_density")
    out = np.empty(arr.shape, np.float32)
    rc = lib.hu_to_density(arr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(arr.size),
                           ctypes.c_int(code), ctypes.c_float(bone_attenuation_multiplier),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def transform_hu_to_density(volume: np.ndarray,
                            bone_attenuation_multiplier: float = 1.0) -> np.ndarray:
    """Piecewise HU -> density transfer function, min-max normalized.

    Air (<= -800 HU), soft tissue (-800, 350], bone (> 350) times a
    multiplier, then shifted and scaled to [0, 1]. The native transfer
    first (within 1e-6 of the NumPy route, which scales by the peak's
    reciprocal), else float32 NumPy with the same operations in the same
    order as the JAX package's NumPy route.
    """
    native = _hu_to_density_native(volume, bone_attenuation_multiplier)
    if native is not None:
        return native

    volume = np.asarray(volume, np.float32)
    air = volume <= -800
    soft = (-800 < volume) & (volume <= 350)
    bone = 350 < volume

    density = np.empty_like(volume)
    soft_min = volume[soft].min() if soft.any() else np.float32(-800.0)
    density[air] = soft_min
    density[soft] = volume[soft]
    density[bone] = volume[bone] * np.float32(bone_attenuation_multiplier)
    density -= density.min()
    peak = density.max()
    if peak > 0:
        density /= peak
    return density


_REORIENT = {
    # Rotate the C-arm about the x-axis by 90 degrees.
    "AP": np.array(
        [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32),
    # Same, with the y-axis direction reversed.
    "PA": np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32),
    None: np.eye(4, dtype=np.float32),
}


def canonicalize(subject: Subject) -> Subject:
    """Move the subject isocentre to the world origin."""
    affine_original = subject.volume.affine.copy()
    for image in subject.get_images(intensity_only=False):
        isocenter = image.get_center()
        Tinv = np.eye(4)
        Tinv[:3, 3] = -isocenter
        image.affine = Tinv @ image.affine

    if subject.fiducials is not None:
        affine = subject.volume.affine @ np.linalg.inv(affine_original)
        fid = np.asarray(subject.fiducials, np.float32)
        if fid.ndim == 2:
            fid = fid[None]
        subject.fiducials = (
            np.einsum("ij,bnj->bni", affine[:3, :3].astype(np.float32), fid)
            + affine[:3, 3].astype(np.float32))
    return subject


def read(
    volume: Union[str, Path, Image],
    labelmap: Union[str, Path, Image, None] = None,
    labels: Union[int, Sequence[int], None] = None,
    orientation: Optional[str] = "AP",
    bone_attenuation_multiplier: float = 1.0,
    fiducials: Optional[np.ndarray] = None,
    transform=None,
    center_volume: bool = True,
    resample_target: Union[float, Sequence[float], None] = None,
    **kwargs,
) -> Subject:
    """Read a CT (+ optional labelmap), from NIfTI files or in-memory
    images, and package it for rendering.

    Optional affine pre-transform (a ``RigidTransform``), HU -> density,
    AP/PA/None reorientation, isocentre centring, label-subset masking (a
    labelmap stored in another orientation is reoriented to the volume's
    to mask the volume, and masked in its own frame), and optional
    resampling to ``resample_target`` mm. The result stays on the host;
    call :meth:`Subject.to` (or let ``load_example_ct`` do it) to move it.
    """
    if not isinstance(volume, Image):
        volume = Image.load(volume)
    mask = labelmap
    if mask is not None and not isinstance(mask, Image):
        mask = Image.load(mask)
    if transform is not None:
        T = np.asarray(transform.matrix.detach().cpu(), np.float64)[0]
        volume = Image(volume.data, T @ volume.affine)

    density = Image(
        transform_hu_to_density(volume.data, bone_attenuation_multiplier),
        volume.affine)
    if orientation not in _REORIENT:
        raise ValueError(f"Unrecognized orientation {orientation}")

    subject = Subject(
        volume=volume,
        density=density,
        mask=mask,
        orientation=orientation,
        reorient=_REORIENT[orientation].copy(),
        fiducials=fiducials,
        extra=dict(kwargs),
    )
    if "structures" in subject.extra:
        subject.structures = subject.extra.pop("structures")
    if center_volume:
        subject = canonicalize(subject)

    if labels is not None:
        if subject.mask is None:
            raise ValueError("read(labels=...) requires a labelmap; none was provided")
        if isinstance(labels, int):
            labels = [labels]
        labels = np.asarray(labels)
        mask_data = subject.mask.data
        if subject.volume.orientation != subject.mask.orientation:
            tf = nifti.ornt_transform(nifti.axcodes2ornt(subject.mask.orientation),
                                      nifti.axcodes2ornt(subject.volume.orientation))
            mask_data = nifti.apply_orientation(mask_data, tf)
        # ``keep`` is in the volume's frame; the labelmap is masked in its own.
        keep = np.isin(mask_data, labels)
        subject.volume.data = subject.volume.data * keep
        subject.mask.data = subject.mask.data * np.isin(subject.mask.data, labels)
        subject.density.data = subject.density.data * keep

    if resample_target is not None:
        subject = resample_subject(subject, resample_target)
    return subject


def resample_subject(subject: Subject, target: Union[float, Sequence[float]]) -> Subject:
    """Resample every image of a host subject to ``target`` mm spacing
    (torchio's ``Resample``): trilinear for the volume and density, nearest
    (order 0, fill 0) for the labelmap; direction and origin kept."""
    from scipy import ndimage

    if np.isscalar(target):
        target = (float(target),) * 3
    target = np.asarray(target, np.float64)

    def _resample(image: Image, order: int) -> Image:
        spacing = image.spacing
        new_shape = np.maximum(1, np.round(np.asarray(image.spatial_shape) * (spacing / target)))
        new_affine = np.eye(4)
        new_affine[:3, :3] = image.affine[:3, :3] / spacing * target
        new_affine[:3, 3] = image.affine[:3, 3]
        # old index = A_old^-1 @ A_new @ new index
        M = np.linalg.inv(image.affine) @ new_affine
        data = ndimage.affine_transform(
            np.asarray(image.data).astype(np.float32), M[:3, :3], offset=M[:3, 3],
            output_shape=tuple(int(s) for s in new_shape), order=order, mode="constant",
            cval=float(np.asarray(image.data).min()) if order > 0 else 0.0)
        if order == 0:
            data = data.astype(np.asarray(image.data).dtype)
        return Image(data, new_affine)

    subject.volume = _resample(subject.volume, 1)
    subject.density = _resample(subject.density, 1)
    if subject.mask is not None:
        subject.mask = _resample(subject.mask, 0)
    return subject


# -----------------------------------------------------------------------------
# Example data: procedural chest phantom
# -----------------------------------------------------------------------------


def _chest_phantom(shape=(512, 512, 133), seed: int = 0):
    """Deterministic synthetic chest CT (HU) + structure labelmap.

    The same phantom as the JAX package's example subject: air background,
    soft-tissue thorax, near-air lungs, heart, bone spine and ribs, and a
    smooth seeded intensity variation. Labels: 0 background, 1 body, 2/3
    left/right lung, 4 heart, 5 spine, 6 ribs.
    """
    X, Y, Z = shape
    x = np.linspace(-1, 1, X, dtype=np.float32)[:, None, None]
    y = np.linspace(-1, 1, Y, dtype=np.float32)[None, :, None]
    z = np.linspace(-1, 1, Z, dtype=np.float32)[None, None, :]

    hu = np.full(shape, -1024.0, np.float32)
    labels = np.zeros(shape, np.int16)

    body = (x / 0.85) ** 2 + (y / 0.65) ** 2 <= 1.0
    body = body & (np.abs(z) <= 0.95)
    hu[body] = 30.0
    labels[body] = 1

    for sx, lab in ((-0.42, 2), (0.42, 3)):
        lung = ((x - sx) / 0.3) ** 2 + (y / 0.38) ** 2 + (z / 0.8) ** 2 <= 1.0
        lung = lung & body
        hu[lung] = -780.0
        labels[lung] = lab

    heart = ((x - 0.08) / 0.22) ** 2 + ((y + 0.18) / 0.25) ** 2 + (z / 0.45) ** 2 <= 1.0
    heart = heart & body
    hu[heart] = 45.0
    labels[heart] = 4

    spine = (x / 0.09) ** 2 + ((y - 0.45) / 0.09) ** 2 <= 1.0
    spine = spine & body
    hu[spine] = 700.0
    labels[spine] = 5

    r2 = (x / 0.82) ** 2 + (y / 0.62) ** 2
    shell = (r2 <= 1.0) & (r2 >= 0.88) & body
    bands = (np.sin(z * np.pi * 6.0) > 0.55) & np.broadcast_to(
        np.ones_like(x, dtype=bool), shape)
    ribs = shell & bands & (y < 0.5)
    hu[ribs] = 500.0
    labels[ribs] = 6

    rng = np.random.default_rng(seed)
    low = rng.normal(0.0, 12.0, (8, 8, 4)).astype(np.float32)
    from scipy import ndimage

    noise = ndimage.zoom(low, (X / 8, Y / 8, Z / 4), order=1)
    hu = hu + noise[:X, :Y, :Z] * (labels > 0)
    return hu, labels


_EXAMPLE_STRUCTURES = [
    (1, "body"),
    (2, "lung_left"),
    (3, "lung_right"),
    (4, "heart"),
    (5, "spine"),
    (6, "ribs"),
]


_HU_RULES = (
    # (substring of a TotalSegmentator structure name, HU)
    ("lung", -780.0), ("trachea", -850.0),
    ("vertebrae", 550.0), ("rib", 500.0), ("sternum", 450.0),
    ("clavicula", 450.0), ("scapula", 420.0), ("humerus", 420.0),
    ("femur", 420.0), ("hip", 420.0), ("sacrum", 450.0), ("skull", 550.0),
    ("heart", 55.0), ("aorta", 60.0), ("vena", 50.0), ("vein", 50.0),
    ("artery", 55.0), ("atrial", 55.0), ("ventricle", 55.0),
    ("liver", 60.0), ("spleen", 55.0), ("kidney", 35.0),
    ("gallbladder", 20.0), ("pancreas", 40.0), ("adrenal", 30.0),
    ("stomach", 15.0), ("bowel", 10.0), ("duodenum", 15.0),
    ("colon", 5.0), ("esophagus", 35.0), ("thyroid", 90.0),
    ("bladder", 10.0), ("prostate", 40.0),
    ("autochthon", 48.0), ("gluteus", 48.0), ("iliopsoas", 48.0),
)


def _structure_rows(structures):
    """(id, name) pairs of a structures table: a DataFrame with ``id`` and
    ``structure`` (or ``name``) columns, or a sequence of pairs."""
    if hasattr(structures, "iterrows"):
        col = "structure" if "structure" in structures else "name"
        return [(row["id"], row[col]) for _, row in structures.iterrows()]
    return list(structures)


def synthesize_ct_from_labelmap(labelmap, structures=None, body_hu: float = 25.0,
                                air_hu: float = -1000.0) -> np.ndarray:
    """An HU volume (float32, host) whose geometry is a segmented labelmap's.

    Each labelled voxel gets its structure's tissue HU (``_HU_RULES``, by
    name; ``body_hu`` when no rule matches or no table is given); unlabelled
    voxels inside the body envelope (each axial slice's labelled region,
    dilated twice and hole-filled) get ``body_hu``, the rest ``air_hu``.
    """
    from scipy import ndimage

    labelmap = np.asarray(labelmap)
    hu_of = np.full(int(labelmap.max()) + 1, float(body_hu), np.float32)
    if structures is not None:
        for sid, name in _structure_rows(structures):
            name = str(name).lower()
            for needle, hu in _HU_RULES:
                if needle in name:
                    hu_of[int(sid)] = hu
                    break
    labeled = labelmap > 0
    body = np.zeros_like(labeled)
    for k in range(labelmap.shape[2]):
        body[:, :, k] = ndimage.binary_fill_holes(
            ndimage.binary_dilation(labeled[:, :, k], iterations=2))
    hu = np.where(body, body_hu, air_hu).astype(np.float32)
    return np.where(labeled, hu_of[labelmap], hu)


def load_example_ct(
    labels=None,
    orientation: Optional[str] = "AP",
    bone_attenuation_multiplier: float = 1.0,
    shape=(512, 512, 133),
    spacing=(0.703125, 0.703125, 2.5),
    device: DeviceLike = None,
    **kwargs,
) -> Subject:
    """The example chest subject (procedural phantom) on ``device``.

    ``device=None`` means the CUDA card and raises without one. The
    ``structures`` table is a list of ``(id, name)`` pairs.
    """
    device = resolve_device(device)
    hu, labelmap = _chest_phantom(shape)
    spacing = np.asarray(spacing, np.float64)
    affine = np.diag([*spacing, 1.0])
    fiducials = np.asarray(
        [[[shape[0] * spacing[0] * 0.5, shape[1] * spacing[1] * 0.5,
           shape[2] * spacing[2] * 0.6],
          [shape[0] * spacing[0] * 0.5, shape[1] * spacing[1] * 0.45,
           shape[2] * spacing[2] * 0.9]]],
        np.float32,
    )
    subject = read(
        Image(hu, affine),
        Image(labelmap, affine),
        labels,
        orientation=orientation,
        bone_attenuation_multiplier=bone_attenuation_multiplier,
        fiducials=fiducials,
        structures=list(_EXAMPLE_STRUCTURES),
        **kwargs,
    )
    return subject.to(device)
