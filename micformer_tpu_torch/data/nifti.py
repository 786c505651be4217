"""Pure-Python NIfTI-1 reader and writer.

The port's own copy of `micformer_tpu/data/nifti.py` (`read_nifti`,
`write_nifti`). Arrays are in (z, y, x) index order, the SimpleITK
convention of the reference's data loaders.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes
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

_HDR_SIZE = 348


@dataclass
class NiftiHeader:
    shape: tuple
    dtype: np.dtype
    affine: np.ndarray
    pixdim: tuple
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    vox_offset: int = 352
    swapped: bool = False
    descrip: bytes = b""
    extra: dict = field(default_factory=dict)


def _open_maybe_gzip(path, mode="rb"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < _HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    swapped = False
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
        swapped = True
        endian = ">"

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype])
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    vox_offset = int(struct.unpack_from(endian + "f", raw, 108)[0])
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]
    qform_code = struct.unpack_from(endian + "h", raw, 252)[0]

    affine = np.eye(4, dtype=np.float64)
    if sform_code > 0:
        srow_x = struct.unpack_from(endian + "4f", raw, 280)
        srow_y = struct.unpack_from(endian + "4f", raw, 296)
        srow_z = struct.unpack_from(endian + "4f", raw, 312)
        affine[0, :] = srow_x
        affine[1, :] = srow_y
        affine[2, :] = srow_z
    elif qform_code > 0:
        b, c, d = struct.unpack_from(endian + "3f", raw, 256)
        qx, qy, qz = struct.unpack_from(endian + "3f", raw, 268)
        a2 = 1.0 - (b * b + c * c + d * d)
        a = np.sqrt(max(a2, 0.0))
        R = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )
        qfac = pixdim[0] if pixdim[0] != 0 else 1.0
        zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine[:3, :3] = R * zooms
        affine[:3, 3] = (qx, qy, qz)
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]

    descrip = raw[148 : 148 + 80].split(b"\x00", 1)[0]
    return NiftiHeader(
        shape=shape,
        dtype=dtype,
        affine=affine,
        pixdim=tuple(float(p) for p in pixdim[1 : 1 + ndim]),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        vox_offset=max(vox_offset, _HDR_SIZE + 4),
        swapped=swapped,
        descrip=descrip,
    )


def read_nifti(path, dtype=None, with_header=False):
    """Read a .nii / .nii.gz volume.

    Returns the array in (z, y, x) index order (SimpleITK convention, matching
    reference MMWHS.py:407-409), with scl_slope/inter applied when nontrivial.
    """
    with _open_maybe_gzip(path) as f:
        raw = f.read()
    hdr = _parse_header(raw)
    data = np.frombuffer(raw, dtype=hdr.dtype, count=int(np.prod(hdr.shape)), offset=hdr.vox_offset)
    if hdr.swapped:
        data = data.byteswap().view(data.dtype.newbyteorder())
    # NIfTI stores Fortran order: x fastest. Reshape to (x,y,z,...) then move to (..., z,y,x).
    arr = data.reshape(hdr.shape, order="F")
    # Reverse all axes order -> for 3D gives (z, y, x); 4D gives (t, z, y, x).
    arr = arr.transpose(tuple(range(arr.ndim - 1, -1, -1)))
    slope, inter = hdr.scl_slope, hdr.scl_inter
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        arr = arr * np.float32(slope) + np.float32(inter)
    if dtype is not None:
        arr = arr.astype(dtype)
    else:
        arr = np.ascontiguousarray(arr)
    if with_header:
        return arr, hdr
    return arr


def write_nifti(path, array, affine=None, dtype=None):
    """Write a 3D array given in (z, y, x) index order as NIfTI-1 (.nii or .nii.gz)."""
    array = np.asarray(array)
    if dtype is not None:
        array = array.astype(dtype)
    if array.dtype == np.bool_:
        array = array.astype(np.uint8)
    if array.dtype not in _DTYPE_CODES:
        array = array.astype(np.float32)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, dtype=np.float64)

    # back to Fortran (x fastest): reverse axes then ravel order='F'
    data = array.transpose(tuple(range(array.ndim - 1, -1, -1)))
    shape = data.shape

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [data.ndim] + list(shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    pixdim = [1.0] + [float(z) for z in zooms] + [1.0] * (7 - max(3, data.ndim))
    pixdim = (pixdim + [1.0] * 8)[:8]
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    descrip = b"micformer_tpu"
    hdr[148 : 148 + len(descrip)] = descrip
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + data.ravel(order="F").tobytes()
    with _open_maybe_gzip(path, "wb") as f:
        f.write(payload)
