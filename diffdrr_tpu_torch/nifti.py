"""A small NIfTI-1 reader and writer, and orientation helpers (NumPy only).

Counterpart of ``diffdrr_tpu/nifti.py``, kept as the port's own copy: the
port imports nothing of the JAX package. ``load`` reads single-file
``.nii`` and ``.nii.gz`` volumes with their affine (sform, else qform, else
the pixdim diagonal); ``save`` writes one back (sform only). The orientation
helpers (axis codes, orientation transforms) reconcile a labelmap stored in
another orientation than its CT. Gzip inflates through the native loader
(``native/nifti_loader.cpp``, zlib) first, as in the JAX package, else
through Python's ``gzip``.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

__all__ = [
    "load",
    "save",
    "aff2axcodes",
    "axcodes2ornt",
    "ornt_transform",
    "apply_orientation",
    "io_orientation",
]

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_bytes(path: Union[str, Path]) -> bytes:
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        native = _gunzip_native(raw)
        raw = native if native is not None else gzip.decompress(raw)
    return raw


def _gunzip_native(raw: bytes):
    """zlib inflate through the native loader (native/nifti_loader.cpp), or
    None when the library does not build or the stream is bad."""
    import ctypes

    from .native import build

    lib = build.load_library("nifti_loader")
    if lib is None:
        return None
    build.count("gunzip")
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.gunzip(ctypes.cast(ctypes.c_char_p(raw), ctypes.POINTER(ctypes.c_uint8)),
                   ctypes.c_int64(len(raw)), ctypes.byref(out))
    if n < 0:
        return None
    data = ctypes.string_at(out, n)
    lib.nl_free(out)
    return data


def _quaternion_to_rotation(b: float, c: float, d: float) -> np.ndarray:
    a = np.sqrt(max(1.0 - (b * b + c * c + d * d), 0.0))
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )


def load(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray]:
    """Load a NIfTI-1 volume: ``(data (X, Y, Z[, T]), affine (4, 4))``."""
    raw = _read_bytes(path)
    if len(raw) < 348:
        raise ValueError(f"{path}: too short to be a NIfTI-1 file")

    end = "<"
    (sizeof_hdr,) = struct.unpack_from(end + "i", raw, 0)
    if sizeof_hdr != 348:
        end = ">"
        (sizeof_hdr,) = struct.unpack_from(end + "i", raw, 0)
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: bad sizeof_hdr, not NIfTI-1")

    magic = raw[344:348]
    if magic[:2] == b"ni":
        # A .hdr/.img pair keeps its voxels in another file.
        raise ValueError(
            f"{path}: NIfTI-1 pair format ('ni1' magic, data in a separate "
            f".img file) is not supported; convert to single-file .nii[.gz]")
    if magic[:2] != b"n+":
        raise ValueError(f"{path}: bad magic {magic!r}")

    dim = struct.unpack_from(end + "8h", raw, 40)
    (datatype,) = struct.unpack_from(end + "h", raw, 70)
    pixdim = struct.unpack_from(end + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(end + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(end + "2f", raw, 112)
    qform_code, sform_code = struct.unpack_from(end + "2h", raw, 252)
    quatern = struct.unpack_from(end + "3f", raw, 256)
    qoffset = struct.unpack_from(end + "3f", raw, 268)
    srow_x = struct.unpack_from(end + "4f", raw, 280)
    srow_y = struct.unpack_from(end + "4f", raw, 296)
    srow_z = struct.unpack_from(end + "4f", raw, 312)

    ndim = dim[0]
    shape = tuple(max(1, d) for d in dim[1:1 + max(ndim, 3)])
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(end)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=int(vox_offset)).reshape(shape, order="F")
    data = np.array(data, dtype=data.dtype.newbyteorder("="))  # native order, writable

    # Slope 0 or NaN means no scaling at all (the intercept is ignored too).
    if np.isnan(scl_slope):
        scl_slope = 0.0
    if np.isnan(scl_inter):
        scl_inter = 0.0
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        data = data.astype(np.float32) * scl_slope + scl_inter

    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], np.float64)
    elif qform_code > 0:
        R = _quaternion_to_rotation(*quatern)
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine = np.eye(4)
        affine[:3, :3] = R * zooms
        affine[:3, 3] = qoffset
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    while data.ndim > 3 and data.shape[-1] == 1:  # (X, Y, Z, 1) -> (X, Y, Z)
        data = data[..., 0]
    return data, affine


def save(path: Union[str, Path], data: np.ndarray, affine: np.ndarray) -> None:
    """Write a NIfTI-1 single file (``.nii`` or ``.nii.gz``), sform only."""
    path = Path(path)
    data = np.asarray(data)
    affine = np.asarray(affine, np.float64)
    if data.ndim not in (3, 4):
        raise ValueError("save expects 3D or 4D data")
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, *([1.0] + list(zooms) + [1.0] * 4))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0, sform_code=1
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    if path.name.endswith(".gz"):
        payload = gzip.compress(payload)
    path.write_bytes(payload)


# -----------------------------------------------------------------------------
# Orientation (the nibabel.orientations functions the data layer needs)
# -----------------------------------------------------------------------------


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """(3, 2) orientation: for each input axis, (output axis, flip)."""
    RZS = np.asarray(affine)[:3, :3]
    zooms = np.sqrt((RZS ** 2).sum(axis=0))
    zooms = np.where(zooms == 0, 1, zooms)
    R = RZS / zooms
    ornt = np.full((3, 2), np.nan)
    # Greedy: each column goes to its dominant row.
    P = np.abs(R.copy())
    for _ in range(3):
        out_ax, in_ax = np.unravel_index(np.argmax(P), P.shape)
        ornt[in_ax, 0] = out_ax
        ornt[in_ax, 1] = 1.0 if R[out_ax, in_ax] > 0 else -1.0
        P[out_ax, :] = -1
        P[:, in_ax] = -1
    return ornt


def aff2axcodes(affine: np.ndarray, labels=(("L", "R"), ("P", "A"), ("I", "S"))) -> tuple:
    """Axis direction codes of an affine, e.g. ``('R', 'A', 'S')``."""
    codes = []
    for out_ax, flip in io_orientation(affine):
        out_ax = int(out_ax)
        codes.append(labels[out_ax][1] if flip > 0 else labels[out_ax][0])
    return tuple(codes)


def axcodes2ornt(axcodes, labels=(("L", "R"), ("P", "A"), ("I", "S"))) -> np.ndarray:
    ornt = np.full((len(axcodes), 2), np.nan)
    for i, code in enumerate(axcodes):
        for out_ax, (neg, pos) in enumerate(labels):
            if code == pos:
                ornt[i] = [out_ax, 1]
            elif code == neg:
                ornt[i] = [out_ax, -1]
    return ornt


def ornt_transform(start_ornt: np.ndarray, end_ornt: np.ndarray) -> np.ndarray:
    """The orientation transform taking data in ``start_ornt`` to ``end_ornt``."""
    start_ornt = np.asarray(start_ornt)
    end_ornt = np.asarray(end_ornt)
    result = np.empty_like(start_ornt)
    for end_in_idx, (end_out_idx, end_flip) in enumerate(end_ornt):
        for start_in_idx, (start_out_idx, start_flip) in enumerate(start_ornt):
            if end_out_idx == start_out_idx:
                result[start_in_idx, :] = [end_in_idx, start_flip * end_flip]
                break
        else:
            raise ValueError("Unable to find out axis in start orientation")
    return result


def apply_orientation(arr: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    """Apply a (3, 2) orientation transform: flip the axes marked -1, then
    transpose into the new order."""
    arr = np.asarray(arr)
    ornt = np.asarray(ornt)
    for ax, (_, flip) in enumerate(ornt):
        if flip == -1:
            arr = np.flip(arr, axis=ax)
    return np.transpose(arr, np.argsort(ornt[:, 0].astype(int)))
