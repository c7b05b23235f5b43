"""Self-contained NIfTI-1 reader and writer (numpy only, host side).

Port of ``keymorph_tpu/data/nifti.py``: the same header parser, qform and
sform affines, ``load_nifti``, ``save_nifti``, ``orientation_transform`` and
``to_canonical``, so both packages read a file into the same arrays and
affines bit for bit. A ``.gz`` file is inflated by the port's C++ helper
(:mod:`keymorph_tpu_torch.native.kmio`, built at first use) when it is
available, else by Python's ``gzip``; :func:`gzip_reader` says which.

Format: NIfTI-1 (348-byte header, https://nifti.nimh.nih.gov/nifti-1): the
datatypes (u)int8/16/32/64 and float32/64, scl_slope/inter scaling, qform
and sform affines.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from typing import Optional, Tuple

import numpy as np

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


@dataclasses.dataclass
class NiftiImage:
    """A loaded volume: raw array + (4,4) voxel->world affine."""

    data: np.ndarray
    affine: np.ndarray
    header: Optional[dict] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    def get_fdata(self):
        """nibabel-compatible accessor."""
        return self.data.astype(np.float64)


def _quaternion_to_affine(hdr):
    """qform affine from quaternion fields (NIfTI-1 spec, method 2)."""
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - b * b - c * c],
        ]
    )
    qfac = hdr["pixdim"][0] if hdr["pixdim"][0] != 0 else 1.0
    spacing = np.array([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * spacing
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes):
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file")
        endian = ">"

    def f(fmt, off, n=1):
        vals = struct.unpack(f"{endian}{n}{fmt}", raw[off : off + n * struct.calcsize(fmt)])
        return vals[0] if n == 1 else list(vals)

    hdr = {
        "endian": endian,
        "dim": f("h", 40, 8),
        "datatype": f("h", 70),
        "bitpix": f("h", 72),
        "pixdim": f("f", 76, 8),
        "vox_offset": f("f", 108),
        "scl_slope": f("f", 112),
        "scl_inter": f("f", 116),
        "qform_code": f("h", 252),
        "sform_code": f("h", 254),
        "quatern_b": f("f", 256),
        "quatern_c": f("f", 260),
        "quatern_d": f("f", 264),
        "qoffset_x": f("f", 268),
        "qoffset_y": f("f", 272),
        "qoffset_z": f("f", 276),
        "srow_x": f("f", 280, 4),
        "srow_y": f("f", 296, 4),
        "srow_z": f("f", 312, 4),
        "magic": raw[344:348],
    }
    if hdr["magic"][:2] not in (b"n+", b"ni"):
        raise ValueError(f"bad NIfTI magic {hdr['magic']!r}")
    return hdr


def _affine_from_header(hdr):
    if hdr["sform_code"] > 0:
        aff = np.eye(4)
        aff[0] = hdr["srow_x"]
        aff[1] = hdr["srow_y"]
        aff[2] = hdr["srow_z"]
        return aff
    if hdr["qform_code"] > 0:
        return _quaternion_to_affine(hdr)
    aff = np.diag([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3], 1.0])
    return aff


def gzip_reader() -> str:
    """The reader of ``.gz`` files: "kmio" (the C++ helper) or "gzip"
    (Python's, where the helper could not be built)."""
    from keymorph_tpu_torch.native import kmio

    return "kmio" if kmio.available() else "gzip"


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        if gzip_reader() == "kmio":
            from keymorph_tpu_torch.native import kmio

            return kmio.gunzip_file(path)
        with gzip.open(path, "rb") as fh:
            return fh.read()
    with open(path, "rb") as fh:
        return fh.read()


def load_nifti(path: str, dtype=np.float32) -> NiftiImage:
    """Load a .nii / .nii.gz volume.

    Returns data with its on-disk axis order (i, j, k[, t...]) and the
    voxel->world affine. Applies scl_slope/inter when meaningful.
    """
    raw = _read_bytes(path)
    hdr = _parse_header(raw)
    ndim = hdr["dim"][0]
    shape = tuple(int(s) for s in hdr["dim"][1 : 1 + ndim])
    np_dtype = _DTYPES.get(hdr["datatype"])
    if np_dtype is None:
        raise ValueError(f"unsupported NIfTI datatype {hdr['datatype']}")
    offset = int(hdr["vox_offset"])
    count = int(np.prod(shape))
    arr = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(hdr["endian"]), count=count, offset=offset
    )
    # NIfTI data is Fortran-ordered (first axis fastest)
    arr = arr.reshape(shape, order="F")
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        arr = arr * (slope if slope != 0 else 1.0) + inter
    if dtype is not None:
        arr = np.ascontiguousarray(arr, dtype=dtype)
    else:
        arr = np.ascontiguousarray(arr)
    return NiftiImage(data=arr, affine=_affine_from_header(hdr), header=hdr)


def save_nifti(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a minimal single-file NIfTI-1 (.nii or .nii.gz) with an sform."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    pixdim = [1.0] + [float(np.linalg.norm(affine[:3, i])) for i in range(min(3, ndim))]
    pixdim += [1.0] * (8 - len(pixdim))

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=4) as fh:
            fh.write(payload)
    else:
        with open(path, "wb") as fh:
            fh.write(payload)


def orientation_transform(affine):
    """Axis permutation + flips taking the array to closest-to-RAS order.

    Returns (perm, flips): apply ``np.transpose(arr, perm)`` then flip the
    axes in `flips`. Equivalent to nibabel's io_orientation + apply.
    """
    R = affine[:3, :3]
    # for each world axis, which voxel axis dominates
    perm = [-1, -1, -1]
    flips = []
    used = set()
    Q = R.copy()
    for _ in range(3):
        i, j = np.unravel_index(
            np.argmax(np.where(np.isfinite(Q), np.abs(Q), -1)), Q.shape
        )
        perm[i] = j
        if R[i, j] < 0:
            flips.append(i)
        used.add(j)
        Q[i, :] = -np.inf
        Q[:, j] = -np.inf
    return perm, flips


def to_canonical(img: NiftiImage) -> NiftiImage:
    """Reorient data+affine to RAS+ (the reference pipeline's tio.ToCanonical,
    scripts/hyperparameters.py:5)."""
    perm, flips = orientation_transform(img.affine)
    data = np.transpose(img.data, perm)
    affine = img.affine.copy()
    # permute columns of the rotation part accordingly
    affine[:3, :3] = img.affine[:3, perm]
    for ax in flips:
        data = np.flip(data, axis=ax)
        n = data.shape[ax]
        affine[:3, 3] = affine[:3, 3] + affine[:3, ax] * (n - 1)
        affine[:3, ax] = -affine[:3, ax]
    return NiftiImage(data=np.ascontiguousarray(data), affine=affine, header=img.header)
