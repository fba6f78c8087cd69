"""Minimal, dependency-free NIfTI-1 (and .mgz) volume I/O (a copy of
brainfm_tpu/utils/nifti.py, which imports no JAX; the port keeps its own).

The reference reads/writes volumes through nibabel
(the reference's utils/misc.py:159-222 MRIread/MRIwrite). nibabel is not
a dependency of this package, and a data path should not pay nibabel's
object overhead per volume anyway — this module parses the NIfTI-1 header
directly with numpy and streams the voxel payload with zlib, which is the
whole of what the training/inference paths need.

Supports: .nii / .nii.gz (NIfTI-1), .mgz/.mgh (FreeSurfer, used by the
bundled MNI atlas files/gca.mgz), int/float dtypes, scl_slope/inter.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_NII_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_NII_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4,
              np.dtype(np.int32): 8, np.dtype(np.float32): 16,
              np.dtype(np.float64): 64}

_MGH_DTYPES = {0: np.uint8, 1: np.int32, 3: np.float32, 4: np.int16}


def _open(path):
    if path.endswith(".gz") or path.endswith(".mgz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _read_nifti(f):
    hdr = f.read(348)
    sizeof_hdr = struct.unpack("<i", hdr[:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        assert struct.unpack(">i", hdr[:4])[0] == 348, "not a NIfTI-1 file"
    dim = np.frombuffer(hdr[40:56], dtype=endian + "i2")
    datatype = struct.unpack(endian + "h", hdr[70:72])[0]
    bitpix = struct.unpack(endian + "h", hdr[72:74])[0]
    vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
    scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
    scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
    sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
    qform_code = struct.unpack(endian + "h", hdr[252:254])[0]
    srow = np.frombuffer(hdr[280:328], dtype=endian + "f4").reshape(3, 4)
    pixdim = np.frombuffer(hdr[76:108], dtype=endian + "f4")

    ndim = int(dim[0])
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    dtype = np.dtype(_NII_DTYPES[datatype]).newbyteorder(endian)

    aff = np.eye(4)
    if sform_code > 0:
        aff[:3, :] = srow
    elif qform_code > 0:
        aff = _quaternion_affine(hdr, endian, pixdim)
    else:
        aff[0, 0] = pixdim[1]
        aff[1, 1] = pixdim[2]
        aff[2, 2] = pixdim[3]

    skip = int(vox_offset) - 348
    if skip > 0:
        f.read(skip)
    count = int(np.prod(shape)) * (bitpix // 8)
    buf = f.read(count)
    data = np.frombuffer(buf, dtype=dtype).reshape(shape, order="F")
    # non-finite slope/inter mean "no scaling" (nibabel convention; some
    # tools write NaN here)
    if not np.isfinite(scl_slope):
        scl_slope = 0.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    return np.asarray(data), aff


def _quaternion_affine(hdr, endian, pixdim):
    qb, qc, qd = struct.unpack(endian + "3f", hdr[256:268])
    qx, qy, qz = struct.unpack(endian + "3f", hdr[268:280])
    a = np.sqrt(max(0.0, 1.0 - qb * qb - qc * qc - qd * qd))
    b, c, d = qb, qc, qd
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
    ])
    aff = np.eye(4)
    aff[:3, :3] = R * np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff[:3, 3] = [qx, qy, qz]
    return aff


def _read_mgh(f):
    """FreeSurfer .mgz/.mgh (the bundled atlas format, files/gca.mgz)."""
    hdr = f.read(284)
    version, w, h, d, nframes, dtype_code = struct.unpack(">6i", hdr[:24])
    assert version == 1, "unsupported MGH version"
    goodras = struct.unpack(">h", hdr[24 + 4:24 + 6])[0]
    spacing = np.frombuffer(hdr[30:42], dtype=">f4")
    aff = np.eye(4)
    if goodras == 1:
        Mdc = np.frombuffer(hdr[42:78], dtype=">f4").reshape(3, 3, order="F")
        c_ras = np.frombuffer(hdr[78:90], dtype=">f4")
        MdcD = Mdc * spacing
        aff[:3, :3] = MdcD
        crs_c = np.array([w / 2.0, h / 2.0, d / 2.0])
        aff[:3, 3] = c_ras - MdcD @ crs_c
    dtype = _MGH_DTYPES[dtype_code]
    count = w * h * d * nframes * np.dtype(dtype).itemsize
    data = np.frombuffer(f.read(count), dtype=np.dtype(dtype).newbyteorder(">"))
    data = data.reshape((w, h, d, nframes), order="F")
    if nframes == 1:
        data = data[..., 0]
    return np.asarray(data), aff


def load_nifti(path: str):
    """Returns (data, affine). data is numpy in Fortran voxel order
    (i,j,k) like nibabel's get_fdata."""
    with _open(path) as f:
        if path.endswith((".mgz", ".mgh")):
            return _read_mgh(f)
        return _read_nifti(f)


def save_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None):
    """Write a NIfTI-1 volume (optionally .gz)."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if data.dtype not in _NII_CODES:
        data = data.astype(np.float32)
    code = _NII_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8
    ndim = data.ndim
    dim = np.zeros(8, np.int16)
    dim[0] = ndim
    dim[1:1 + ndim] = data.shape

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    hdr[40:56] = dim.tobytes()
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    pixdim = np.ones(8, np.float32)
    pixdim[1:4] = np.sqrt((affine[:3, :3] ** 2).sum(0))
    hdr[76:108] = pixdim.tobytes()
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code
    hdr[280:328] = np.asarray(affine[:3, :], np.float32).tobytes()
    hdr[344:348] = b"n+1\x00"

    payload = np.asarray(data, order="F").tobytes(order="F")
    if path.endswith(".gz"):
        # level 1: gzip.open's default level-9 costs ~30-60 s of host CPU
        # per 40 MB fp32 volume; level 1 is ~10x faster within ~10% size
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(bytes(hdr))
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(bytes(hdr))
            f.write(payload)


def MRIread(path: str, im_only: bool = False, dtype: str = "float"):
    """(API parity: utils/misc.py:159-189)"""
    data, aff = load_nifti(path)
    data = data.astype(np.int32 if dtype == "int" else np.float32)
    if im_only:
        return data
    return data, aff


def MRIwrite(volume, aff, filename: str, dtype=None):
    """(API parity: utils/misc.py:192-205)"""
    vol = np.asarray(volume)
    if dtype is not None:
        vol = vol.astype(dtype)
    save_nifti(filename, vol, aff if aff is not None else np.eye(4))


def viewVolume(x, aff=None, prefix="", postfix="", names=(), ext=".nii.gz",
               save_dir=None):
    """Dump volumes for inspection (API parity: utils/misc.py:208-222).
    `save_dir` defaults to the temporary directory ($TMPDIR)."""
    import tempfile

    import numpy as _np

    save_dir = save_dir or tempfile.gettempdir()
    if not isinstance(x, (list, tuple)):
        x = [x]
    names = list(names) if names else [f"vol{i}" for i in range(len(x))]
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for v, name in zip(x, names):
        arr = _np.asarray(v).squeeze()
        p = os.path.join(save_dir, prefix + name + postfix + ext)
        save_nifti(p, arr.astype(_np.float32), aff)
        paths.append(p)
    return paths
