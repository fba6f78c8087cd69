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

import functools
import gzip
import math
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .profiling import count

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


def save_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None,
               *, dtype=None, clip_min: float | None = None):
    """Write a NIfTI-1 volume (optionally .gz). The file holds `data` cast
    to `dtype` (default: its own dtype if NIfTI has one, else float32),
    clipped below at `clip_min` if given."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if dtype is None:
        dtype = data.dtype if data.dtype in _NII_CODES else np.float32
    dtype = np.dtype(dtype)
    code = _NII_CODES[dtype]
    ndim = data.ndim
    dim = np.zeros(8, np.int16)
    dim[0] = ndim
    dim[1:1 + ndim] = data.shape

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    hdr[40:56] = dim.tobytes()
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, dtype.itemsize * 8)   # bitpix
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

    # the payload is the volume in Fortran order: C order of its transpose
    vol = _Payload(data.T, dtype, clip_min, bytes(hdr))
    if path.endswith(".gz"):
        _write_gzip(path, vol, math.prod(data.shape[:2]) or 1)
    else:
        with open(path, "wb") as f:
            f.write(vol.span(0, data.size))


# ------------------------------------------------------ the gzip encoder
# A .nii.gz is one gzip member at level 1 (gzip.open's default level 9
# costs ~30-60 s of host CPU per 40 MB fp32 volume; level 1 is ~10x faster
# within ~10% size). It is deflated in chunks of whole z-planes on a thread
# pool: each chunk is a raw deflate stream primed with the 32 KiB of payload
# before it and ended by a sync flush (the last by Z_FINISH), so the chunks
# joined in order are one deflate stream, as pigz writes them. A chunk's
# bytes depend only on the volume, so the file does not depend on the
# number of threads or the order they finish in.

CHUNK_BYTES = 1 << 20             # payload bytes of a chunk, in whole planes
THREADS = min(16, os.cpu_count() or 1)
_WINDOW = 1 << 15                 # deflate's window
# no file name, mtime 0, XFL 4 (fastest level), OS 255 (unknown)
_GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x04\xff"
_pool = None                      # the deflate pool, made at first use
_pool_lock = threading.Lock()


def _executor() -> ThreadPoolExecutor:
    """The deflate pool. Only chunk encodes run on it and they submit
    nothing, so writers on other pools cannot deadlock it."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(THREADS,
                                       thread_name_prefix="nifti-deflate")
        return _pool


class _Payload:
    """A file's bytes, made piecewise from the volume: the header, then the
    elements of `t` in C order, cast to `dtype` and clipped below at
    `clip_min`. The clip follows the cast and gives what clipping first
    would (both are monotone and keep the sign; clip maps -0.0 to 0.0)."""

    def __init__(self, t, dtype, clip_min, hdr):
        self.t, self.dtype, self.clip_min, self.hdr = t, dtype, clip_min, hdr

    def span(self, e0: int, e1: int) -> np.ndarray:
        """The bytes of elements e0:e1 as uint8, the header first if e0 is
        0."""
        head = len(self.hdr) if e0 == 0 else 0
        buf = np.empty(head + (e1 - e0) * self.dtype.itemsize, np.uint8)
        buf[:head] = np.frombuffer(self.hdr, np.uint8)[:head]
        vals = buf[head:].view(self.dtype)
        _fill(vals, self.t, e0, e1)
        if self.clip_min is not None:
            np.clip(vals, self.clip_min, None, out=vals)
        return buf

    def deflate(self, e0: int, e1: int, last: bool):
        """(raw deflate stream, crc32, length) of span(e0, e1), primed with
        the window of bytes before it."""
        data = self.span(e0, e1)
        prior = {}
        if e0:
            back = max(0, e0 - _WINDOW // self.dtype.itemsize)
            prior["zdict"] = self.span(back, e0)[-_WINDOW:]
        z = zlib.compressobj(1, zlib.DEFLATED, -zlib.MAX_WBITS, **prior)
        out = z.compress(data) + z.flush(
            zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)
        return out, zlib.crc32(data), data.nbytes


def _fill(out: np.ndarray, t: np.ndarray, e0: int, e1: int):
    """out[:] = the elements e0:e1 of t in C order (one strided copy for
    each run of whole sub-blocks)."""
    if e1 <= e0:
        return
    if t.ndim <= 1:
        out[...] = t.reshape(-1)[e0:e1]
        return
    inner = math.prod(t.shape[1:])
    i0, r0 = divmod(e0, inner)
    i1, r1 = divmod(e1, inner)
    if i0 == i1:
        _fill(out, t[i0], r0, r1)
        return
    pos = 0
    if r0:
        _fill(out[:inner - r0], t[i0], r0, inner)
        pos, i0 = inner - r0, i0 + 1
    whole = (i1 - i0) * inner
    out[pos:pos + whole].reshape((i1 - i0,) + t.shape[1:])[...] = t[i0:i1]
    if r1:
        _fill(out[pos + whole:], t[i1], 0, r1)


def _write_gzip(path: str, vol: _Payload, plane: int):
    """Write vol's bytes as one gzip member, deflated in chunks of whole
    planes of `plane` (>= 1) elements on the pool; a payload of one chunk is
    deflated on this thread. The counter `write.chunks` adds the chunks
    deflated on the pool."""
    n = vol.t.size
    step = max(1, CHUNK_BYTES // (plane * vol.dtype.itemsize)) * plane
    starts = range(0, max(n, 1), step)
    ends = [min(s + step, n) for s in starts]
    lasts = [e == n for e in ends]
    if len(starts) == 1:
        chunks = [vol.deflate(0, n, True)]
    else:
        count("write.chunks", len(starts))
        chunks = _executor().map(vol.deflate, starts, ends, lasts)
    crc = size = 0
    with open(path, "wb") as f:
        f.write(_GZIP_HEADER)
        for z, c, m in chunks:
            f.write(z)
            crc = crc32_combine(crc, c, m)
            size += m
        f.write(struct.pack("<II", crc, size & 0xFFFFFFFF))


# CRC-32 of a concatenation from the parts' CRCs (zlib's crc32_combine):
# polynomials over GF(2) mod the CRC's, bit-reflected, x^0 at bit 31.
_POLY = 0xEDB88320


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the CRC-32 polynomial."""
    p, m = 0, 1 << 31
    while m:
        if a & m:
            p ^= b
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1
        m >>= 1
    return p


_X2N = [1 << 30]                  # x^(2^k) mod p, k = 0..31
for _ in range(31):
    _X2N.append(_multmodp(_X2N[-1], _X2N[-1]))


@functools.lru_cache(maxsize=64)
def _x8n(n: int) -> int:
    """x^(8n) mod p: what appending n bytes multiplies a CRC by."""
    p, k = 1 << 31, 3
    while n:
        if n & 1:
            p = _multmodp(_X2N[k & 31], p)
        n >>= 1
        k += 1
    return p


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib.crc32(a + b) from crc1 = zlib.crc32(a), crc2 = zlib.crc32(b)
    and len2 = len(b)."""
    return _multmodp(_x8n(len2), crc1) ^ crc2


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
               save_dir=None, clip_min: float | None = None):
    """Dump volumes for inspection (API parity: utils/misc.py:208-222), as
    float32, clipped below at `clip_min` if given. `save_dir` defaults to
    the temporary directory ($TMPDIR)."""
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
        save_nifti(p, arr, aff, dtype=_np.float32, clip_min=clip_min)
        paths.append(p)
    return paths
